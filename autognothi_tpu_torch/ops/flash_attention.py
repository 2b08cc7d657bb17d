"""The standalone masked attention core over split heads (K9).

Replaces `autognothi_tpu/ops/flash_attention.py:_masked_attention_impl`
(body `_attn_kernel`): for q, k, v <N, h, T, D> and a mask row <N, T>,
scores = q.k^T * (1/sqrt(D)) in fp32, then x mask ("mul", the ViT quirk:
a masked score becomes 0) or + mask ("add", the BERT bias), fp32 softmax,
the probabilities cast to v's dtype, fp32 P.V cast to q's dtype.  The JAX
package runs it in pallas mode "1" (`models/common.py:self_attention`).

On the H100 it is one launch of the attention core that the fused blocks
share (`csrc/attention.cu`): the core takes separate Q, K and V pointers
with (batch, head, row) strides, so it reads q, k and v where they lie
(the split-head views of the projections, no copy) and writes the context
as <N, T, h, D> in memory, which `merge_heads` turns into <N, T, H>
without a copy.  The <N, h, T, T> scores and probabilities stay on chip.
What bounds it: the core's mma.sync issue (Q.K and P.V on the tensor
cores; fp32 as 3xTF32, whose operand splits every warp repeats) and, in
bf16, the second Q.K pass that keeps the JAX rounding point of p.

`masked_attention` takes the plain version for CPU tensors and the kernel
for CUDA tensors; the gradient is autograd through the plain version.
"""

from __future__ import annotations

import math

import torch

from ..kernels.build import LaunchCounter
from ..kernels.primitives import attention_heads, dispatch

COUNTER = LaunchCounter("masked_attention")


def masked_attention_plain(q, k, v, mask_row, *, mode: str) -> torch.Tensor:
    """Reference math (port of `_xla_masked_attention`)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / math.sqrt(q.shape[-1])
    m = mask_row.float()[:, None, None, :]
    scores = scores + m if mode == "add" else scores * m
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def masked_attention_launch(q, k, v, mask_row, *, mode: str) -> torch.Tensor:
    """The CUDA version (one launch; no counting, no autograd)."""
    n, h, t, d = q.shape
    out = torch.empty((n, t, h, d), device=q.device,
                      dtype=q.dtype).transpose(1, 2)
    return attention_heads(q, k, v, mask_row, mode, out)


def masked_attention(q: torch.Tensor,         # <N, h, T, D>
                     k: torch.Tensor,
                     v: torch.Tensor,
                     mask_row: torch.Tensor,  # <N, T>: bias ("add") or 0/1
                     mode: str = "add") -> torch.Tensor:
    """-> <N, h, T, D> masked attention context in q's dtype."""
    if mode not in ("mul", "add"):
        raise ValueError(f"unknown mask mode {mode!r}")
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q, k, v must be <N, h, T, D> of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return dispatch(masked_attention_launch, masked_attention_plain, COUNTER,
                    (q, k, v, mask_row), dict(mode=mode))
