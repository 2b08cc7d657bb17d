"""Megatron tensor parallelism for the plain (pallas mode "0") layers.

`parallel.mesh.shard_params` keeps, on each rank of the mesh's "model"
group, its slice of every weight that `param_pspec` shards, as a plain
tensor, and tags the parameter with a `TpShard`.  The layers read the tag
through `tp_shard` and run Megatron's conjugate pair over that group:

- `copy_to_model` (f): identity forward, all-reduce of the gradient
  backward; once before the column-parallel products (Q/K/V, W1), whose
  output features are this rank's;
- `reduce_from_model` (g): all-reduce forward, identity backward; after
  each row-parallel product (out-projection, W2), whose input features
  are this rank's, and before its bias, the residual and the LayerNorm.

So a layer costs two all-reduces forward and two backward.  A kernel op
never takes a tagged weight (`kernels/primitives.dispatch` raises): the
mesh pins mode "0" wherever it shards a model.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


class TpShard(NamedTuple):
    """What a rank holds of a tensor-parallel weight: slice `index` of
    `size` along `dim`, whose full length is `full`."""
    group: object
    size: int
    index: int
    dim: int
    full: int


def tp_shard(w: torch.Tensor) -> Optional[TpShard]:
    return getattr(w, "tp_shard", None)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gather_shard(p: torch.Tensor,
                 of: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole of a parameter: all-gathered over its "model" group when
    it is a shard (every rank of the group must call), else itself.  `of`:
    the parameter whose shard `p` is shaped as (an optimizer moment)."""
    shard = tp_shard(p if of is None else of)
    if shard is None:
        return p
    parts = [torch.empty_like(p) for _ in range(shard.size)]
    dist.all_gather(parts, p.detach().contiguous(), group=shard.group)
    return torch.cat(parts, dim=shard.dim)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def dense_col(x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor]) -> torch.Tensor:
    """`models.common.dense` of a column-parallel weight: the input passes
    f first when `w` is sharded."""
    from ..models.common import dense

    shard = tp_shard(w)
    return dense(x if shard is None else copy_to_model(x, shard.group), w, b)


def dense_row(x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor]) -> torch.Tensor:
    """`models.common.dense` of a row-parallel weight: when `w` is sharded,
    the fp32 partial product is summed over the model group (g), then the
    bias is added in fp32 and the sum cast to x's dtype, as `dense` does."""
    from ..models.common import dense

    shard = tp_shard(w)
    if shard is None:
        return dense(x, w, b)
    y = reduce_from_model(F.linear(x.float(), w.to(x.dtype).float()),
                          shard.group)
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)
