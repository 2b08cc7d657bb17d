"""Shared building blocks (port of `autognothi_tpu/models/common.py`).

Linear weights keep the torch `(out, in)` layout, as in the JAX package,
so one flat parameter dict feeds both.  Reduced-precision inputs compute in
fp32 and cast back at the same points as the JAX code: a dense adds its
bias to the fp32 accumulator and then casts to the input dtype; LayerNorm
takes its statistics in fp32.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.tp import copy_to_model, tp_shard

__all__ = [
    "additive_mask_bias",
    "dense",
    "dense_serving",
    "fused_dims_ok",
    "pallas_mode",
    "pallas_override",
    "quant_mode",
    "quant_override",
    "layer_norm",
    "maybe_remat",
    "gelu",
    "dropout",
    "split_heads",
    "merge_heads",
    "self_attention",
    "init_linear",
    "init_layer_norm",
    "init_embedding",
    "subdict",
]


def dense(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor]) -> torch.Tensor:
    """x @ w.T + b with w in torch (out, in) layout: w is cast to x's dtype,
    the product accumulates in fp32, the bias is added in fp32, and the sum
    is cast back to x's dtype once."""
    y = F.linear(x.float(), w.to(x.dtype).float(),
                 None if b is None else b.float())
    return y.to(x.dtype)


def pallas_mode() -> str:
    """The JAX package's AUTOGNOTHI_PALLAS, read per call: which arithmetic
    the model runs, never which device.
    "auto" (default) and "2": the fused block ops (attention block, MLP
        block, ladder; their int8 versions in int8 mode);
    "1": unfused layers whose `self_attention` runs the standalone masked
        attention op (K9, `ops/flash_attention.py`) where there is a mask
        and no active dropout;
    "0": the plain math everywhere, the numerical reference.
    Each op takes its plain version for CPU tensors and its kernel for CUDA
    tensors, in every mode.  The innermost `pallas_override` scope
    replaces the environment variable."""
    flag = (_PALLAS_OVERRIDE[-1] if _PALLAS_OVERRIDE
            else os.environ.get("AUTOGNOTHI_PALLAS", "auto"))
    if flag in ("0", "1"):
        return flag
    return "2"


_PALLAS_OVERRIDE: list = []


class pallas_override:
    """A scope that forces `pallas_mode()` ("0", "1", "2" or "auto") for the
    code it runs, as `quant_override` does for the quant mode: the export
    pins its trace to the plain math ("0") or to the kernel ops ("2"),
    whatever AUTOGNOTHI_PALLAS says."""

    def __init__(self, mode: str):
        if mode not in ("0", "1", "2", "auto"):
            raise ValueError(f"unknown pallas mode {mode!r}")
        self.mode = mode

    def __enter__(self):
        _PALLAS_OVERRIDE.append(self.mode)
        return self

    def __exit__(self, *exc):
        _PALLAS_OVERRIDE.pop()


def fused_dims_ok(hidden: int) -> bool:
    """The JAX package's width floor for the fused block ops and the ladder
    op (`autognothi_tpu/models/common.py:fused_dims_ok`), read per call:
    AUTOGNOTHI_FUSED_MIN_HIDDEN (default 0: every width).  A layer
    narrower than the floor runs the unfused math, which is unquantized
    even in int8 mode, as in the JAX package."""
    return hidden >= int(os.environ.get("AUTOGNOTHI_FUSED_MIN_HIDDEN", "0"))


_QUANT_OVERRIDE: list = []


def quant_mode() -> str:
    """AUTOGNOTHI_INT8=1 switches the fused block ops to W8A8 (per-output-
    channel int8 weights, per-token int8 activations, int32 accumulation),
    but only in pallas mode "2", as in the JAX package: in modes "0" and
    "1" the model computes unquantized.  Read per call.  The innermost
    `quant_override` scope replaces the environment variable."""
    if _QUANT_OVERRIDE:
        mode = _QUANT_OVERRIDE[-1]
    else:
        mode = "int8" if os.environ.get("AUTOGNOTHI_INT8", "0") == "1" \
            else "none"
    return mode if mode != "int8" or pallas_mode() == "2" else "none"


class quant_override:
    """A scope that forces `quant_mode()` ("int8" or "none") for the code it
    runs: the explainer train step runs its no-grad teacher sweep under
    "int8" and its differentiated forward under "none".  "int8" still
    takes effect only in pallas mode "2"."""

    def __init__(self, mode: str):
        if mode not in ("int8", "none"):
            raise ValueError(f"unknown quant mode {mode!r}")
        self.mode = mode

    def __enter__(self):
        _QUANT_OVERRIDE.append(self.mode)
        return self

    def __exit__(self, *exc):
        _QUANT_OVERRIDE.pop()


def remat_on() -> bool:
    """AUTOGNOTHI_REMAT=1: per-layer rematerialisation, read per call."""
    return os.environ.get("AUTOGNOTHI_REMAT") == "1"


@contextlib.contextmanager
def _scopes(pallas: list, quant: list):
    """The override stacks as they were when a layer first ran."""
    saved = _PALLAS_OVERRIDE[:], _QUANT_OVERRIDE[:]
    _PALLAS_OVERRIDE[:], _QUANT_OVERRIDE[:] = pallas, quant
    try:
        yield
    finally:
        _PALLAS_OVERRIDE[:], _QUANT_OVERRIDE[:] = saved


def maybe_remat(body: Callable, *args,
                generator: Optional[torch.Generator] = None):
    """body(*args), a layer of a scan of the JAX package (port of
    `maybe_remat`): with AUTOGNOTHI_REMAT=1 and autograd on, under
    `torch.utils.checkpoint`, which keeps the layer's inputs and not its
    activations and runs it again in the backward; else as it is (under
    no_grad, as `jax.checkpoint` outside differentiation, it changes
    nothing).

    The recompute must compute what the forward did.  It sees the pallas
    and quant override scopes the forward ran under (the train steps leave
    theirs before the backward), and it draws dropout from `generator` as
    the forward did: the generator's state before the layer is replayed,
    then the state it had before the recompute is put back (checkpoint
    itself replays only the default CPU and CUDA generators)."""
    if not (remat_on() and torch.is_grad_enabled()):
        return body(*args)
    from torch.utils.checkpoint import checkpoint

    scopes = _PALLAS_OVERRIDE[:], _QUANT_OVERRIDE[:]
    state = None if generator is None else generator.get_state()
    first = [True]

    def run(*xs):
        if first[0]:
            first[0] = False
            return body(*xs)
        with _scopes(*scopes):
            if generator is None:
                return body(*xs)
            after = generator.get_state()
            generator.set_state(state)
            try:
                return body(*xs)
            finally:
                generator.set_state(after)

    return checkpoint(run, *args, use_reentrant=False)


def dense_serving(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor]) -> torch.Tensor:
    """`dense`, or in int8 mode the eager W8A8 dense (`_dense_int8`): x
    quantized per token, w (not cast) per output channel, the exact int8
    product dequantized and biased in fp32, then cast to x's dtype.  Under
    autograd its gradient is the full-precision dense's."""
    if quant_mode() != "int8":
        return dense(x, w, b)
    from ..kernels.primitives import _KernelFn

    if b is None:
        b = torch.zeros(w.shape[0], device=x.device)
    return _KernelFn.apply(_dense_int8, dense, x, w, b)


def _dense_int8(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    from ..ops.mlp_block import _quant_rows, int8_linear, quant_cols

    return int8_linear(*_quant_rows(x.float()), *quant_cols(w),
                       b).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics, cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + eps)
    return (normed * w.float() + b.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def dropout(generator: Optional[torch.Generator], x: torch.Tensor,
            rate: float, deterministic: bool) -> torch.Tensor:
    """Inverted dropout: each value is kept with probability 1 - rate and
    scaled by 1 / (1 - rate), else zeroed.  The keep mask is drawn from
    `generator` on its own device; JAX's random streams cannot be
    reproduced, so only the law is shared with the JAX package."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a generator")
    keep = 1.0 - rate
    noise = torch.rand(x.shape, generator=generator, device=generator.device)
    return torch.where(noise.to(x.device) < keep, x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """<..., T, H> -> <..., n_heads, T, head_dim>."""
    *lead, t, h = x.shape
    return x.reshape(*lead, t, n_heads, h // n_heads).transpose(-3, -2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """<..., n_heads, T, head_dim> -> <..., T, H>."""
    x = x.transpose(-3, -2)
    *lead, t, n, d = x.shape
    return x.reshape(*lead, t, n * d)


def additive_mask_bias(mask: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """BERT's extended attention mask: <B, T> 0/1 -> <B, 1, 1, T> bias of 0
    (keep) or finfo(dtype).min (drop), added to the raw scores; computed in
    `dtype`, as the JAX package does (the ops read it as fp32)."""
    bias = (1.0 - mask.to(dtype)) * torch.finfo(dtype).min
    return bias[:, None, None, :]


def self_attention(
    h: torch.Tensor,
    wq: torch.Tensor, bq: torch.Tensor,
    wk: torch.Tensor, bk: torch.Tensor,
    wv: torch.Tensor, bv: torch.Tensor,
    n_heads: int,
    mask: Optional[torch.Tensor],
    mask_mode: str,
    attn_dropout: float = 0.0,
    generator: Optional[torch.Generator] = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Multi-head self attention over <B, T, H>.

    "additive": `mask` is a <B, 1, 1, T> bias added to the scores (BERT).
    "multiplicative": `mask` is <B, T> 0/1 multiplied into the scaled
    scores before the softmax (the ViT quirk: a masked score becomes 0,
    not -inf, so a masked key keeps weight exp(0 - max)).

    In pallas mode "1", with a mask and no active attention dropout, the
    scores, mask, softmax and P.V run as the masked attention op (K9);
    the plain math below is mode "0"/"2"'s and the numerical reference.

    Under tensor parallelism (Q/K/V sharded by `parallel.mesh.
    shard_params`) the rank computes its heads, n_heads / model of them,
    on h passed through f (`parallel/tp.py`)."""
    head_dim = h.shape[-1] // n_heads
    shard = tp_shard(wq)
    if shard is not None:
        h = copy_to_model(h, shard.group)
        n_heads //= shard.size
    q = split_heads(dense(h, wq, bq), n_heads)
    k = split_heads(dense(h, wk, bk), n_heads)
    v = split_heads(dense(h, wv, bv), n_heads)

    no_dropout = deterministic or attn_dropout == 0.0
    if mask is not None and no_dropout and h.dim() == 3 \
            and pallas_mode() == "1":
        from ..ops.flash_attention import masked_attention

        if mask_mode == "additive":
            return merge_heads(masked_attention(q, k, v, mask[:, 0, 0, :],
                                                mode="add"))
        return merge_heads(masked_attention(q, k, v, mask, mode="mul"))

    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / math.sqrt(head_dim)
    if mask is not None:
        if mask_mode == "additive":
            scores = scores + mask.float()
        elif mask_mode == "multiplicative":
            scores = scores * mask[..., None, None, :].float()
        else:
            raise ValueError(f"unknown mask_mode {mask_mode!r}")
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    probs = dropout(generator, probs, attn_dropout, deterministic)
    ctx = torch.matmul(probs.float(), v.float()).to(v.dtype)
    return merge_heads(ctx)


# ---------------------------------------------------------------- init


def init_linear(generator: torch.Generator, d_out: int, d_in: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    drawn on the CPU from `generator`."""
    bound = 1.0 / math.sqrt(d_in)
    w = (torch.rand((d_out, d_in), generator=generator) * 2 - 1) * bound
    b = (torch.rand((d_out,), generator=generator) * 2 - 1) * bound
    return w, b


def init_layer_norm(d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.ones((d,)), torch.zeros((d,))


def init_embedding(generator: torch.Generator, *shape: int) -> torch.Tensor:
    """torch nn.Embedding default init: N(0, 1)."""
    return torch.randn(shape, generator=generator)


# ---------------------------------------------------------- dict helpers


def subdict(params: Dict[str, torch.Tensor],
            prefix: str) -> Dict[str, torch.Tensor]:
    """All entries under `prefix`, with the prefix stripped."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}
