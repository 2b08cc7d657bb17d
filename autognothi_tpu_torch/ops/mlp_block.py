"""The fused MLP block: optional LayerNorm (prologue or epilogue),
up-projection + bias, exact GELU, down-projection + bias, residual.

Replaces `autognothi_tpu/ops/mlp_block.py:_pallas_mlp_block` (body
`_kernel`) and its intermediate-dim split `_pallas_mlp_sepx` (body
`_kernel_sepx`, chained by `_tiled_mlp`; below).  On the H100 one call
is: LN statistics, the W1 GEMM reading LN(resid) on the fly with a bias + GELU
epilogue, and the W2 GEMM with a bias + residual epilogue, which walks the
intermediate dim inside the kernel (`csrc/gemm.cu`, tensor cores: bf16
mma, fp32 as 3xTF32); post-norm adds an LN pass.  The <B*T, 4H>
intermediate goes to device memory.  What bounds it: the GEMMs' tensor-
core issue.

quant="int8" is the W8A8 serving block instead, replacing
`_pallas_mlp_block_q` (body `_kernel_q`, K4): LN -> per-token int8 codes
-> int8 W1 (per-output-channel codes of the live weights) -> bias + GELU
in fp32 -> re-quantized per token -> int8 W2 -> bias -> cast -> + resid.
On the H100: the row quantizer with the LN prologue, the int8 GEMM with a
GELU epilogue writing the fp32 intermediate, the row quantizer again and
the int8 GEMM with the residual epilogue (`csrc/int8.cu`: TMA + wgmma).
The weight codes are made once per weight version (`ops/weight_codes.py`).
This module also holds the two quantizers of the JAX package
(`quant_cols`, `_quant_rows`) and the exact int8 product the plain
versions share.

Where the whole block does not fit the JAX package's on-chip budget
(`ops/gates.py:mlp_block_tiles`: BERT-base at T = 512, ViT-L), the JAX op
splits the intermediate dimension into 2, 4 or 8 chained tiles
(`_tiled_mlp`), each adding its share into the running residual.  In int8
that is another function, and the port reproduces it tile by tile: K8q,
replacing `_pallas_mlp_sepx_q` (body `_kernel_sepx_q`).  Each tile
quantizes x per token, its W1 rows per output channel, re-quantizes its
own <M, tile> intermediate per token, quantizes its W2 column slice per
output row of that slice, and adds cast(acc2 * is * s2 + b2_k) to the
residual in the activation dtype (b2 only on the last tile); the LNs come
before and after the chain.  On the H100 a tile is the row quantizer (x
and the intermediate) and two int8 GEMMs with the GELU and the residual
epilogues (`csrc/int8.cu`); the codes of the tile's W1 rows and of its W2
column slice (quantized in place through its row stride) are made once
per weight version (`ops/weight_codes.py`).  Each tile is one counted
launch, as each is one `pallas_call` in JAX.  What bounds it: the fp32
<M, tile> intermediate's round trip through device memory and the
per-tile quantizers of x and the intermediate.

The float split (K8, `_pallas_mlp_sepx`, body `_kernel_sepx`) is another
function only in bf16: each JAX tile rounds its own W2_k GELU(W1_k x +
b1_k) + b2_k to bf16 before adding it to the running residual.  So in bf16
the port runs the chain tile by tile: the float GEMM with the GELU
epilogue over the tile's W1 rows, then with the residual epilogue over the
tile's W2 column slice <H, tile>, read in place through its row stride;
b2 joins on the last tile, each tile is one counted launch.  In fp32 the
split only reorders an fp32 sum, so fp32 keeps the one-pass block above.

`mlp_block` takes the plain version for CPU tensors and the kernel for
CUDA tensors; there is no other switch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.build import LaunchCounter
from ..kernels.primitives import (EPI_BIAS_GELU, EPI_BIAS_RESID,
                                  I8_EPI_BIAS_RESID, I8_EPI_GELU_F32,
                                  dispatch, gemm, gemm_i8, layernorm_,
                                  quant_rows, rowstats)
from ..models.common import dense, gelu, layer_norm
from . import gates
from .attention_block import LN_POSITIONS
from .weight_codes import weight_codes

COUNTER = LaunchCounter("mlp_block")
COUNTER_INT8 = LaunchCounter("mlp_block_int8")
COUNTER_TILED = LaunchCounter("mlp_block_tiled")
COUNTER_INT8_TILED = LaunchCounter("mlp_block_int8_tiled")


# ------------------------------------------------------------ quantizers


def quant_cols(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 codes of a torch (out, in) weight -> (int8
    <out, in>, fp32 scale <out>): the JAX `quant_cols` of w.T, transposed
    back.  scale = max|w| / 127 + 1e-12 and code = round(w / scale), a
    divide, rounded half to even.  Both divisions are tensor by tensor:
    torch computes `t / 127.0` on the card as t * (1 / 127), one rounding
    more than jnp and the kernel."""
    w32 = w.float()
    amax = w32.abs().amax(dim=1)
    scale = amax / amax.new_tensor(127.0) + 1e-12
    return torch.round(w32 / scale[:, None]).to(torch.int8), scale


def _quant_rows(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (per-token) int8 codes over the last axis of an fp32 tensor
    -> (int8, fp32 scale <..., 1>): amax = max|x| + 1e-12, code =
    round(x * (127 / amax)) (a multiply), scale = amax * (1 / 127).  The
    127 / amax is a true division: torch computes `127.0 / t` as
    t.reciprocal() * 127, which is an ulp off for a quarter of the
    values and moves a code now and then."""
    amax = x32.abs().amax(dim=-1, keepdim=True) + 1e-12
    inv = amax.new_tensor(127.0) / amax
    return torch.round(x32 * inv).to(torch.int8), amax * (1.0 / 127.0)


def int8_linear(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                ws: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The dequantized int8 product in fp32: acc * xs * ws + b, with acc =
    xq @ wq.T exact: in int32 on the card (`torch._int_mm`, where its shape
    rules allow), else in float64, which holds every partial sum of int8
    products at these inner dims exactly."""
    x2 = xq.reshape(-1, xq.shape[-1])
    if x2.is_cuda and x2.shape[0] > 16 and x2.shape[1] % 8 == 0 \
            and wq.shape[0] % 8 == 0:
        acc = torch._int_mm(x2, wq.T)
    else:
        acc = torch.matmul(x2.double(), wq.double().T)
    acc = acc.float().reshape(*xq.shape[:-1], wq.shape[0])
    return acc * xs * ws + b.float()


def mlp_block_plain(resid, w1, b1, w2, b2, ln_w, ln_b, *, ln_position: str,
                    ln_eps: float) -> torch.Tensor:
    """Reference math (port of `_xla_mlp_block`), torch-layout weights:
    LN? -> W1 + b1 -> GELU (fp32) -> cast -> W2 + b2 -> cast -> + resid ->
    LN?"""
    x = (layer_norm(resid, ln_w, ln_b, ln_eps) if ln_position == "prologue"
         else resid)
    inter = gelu(F.linear(x.float(), w1.to(x.dtype).float(), b1.float()))
    out = resid + dense(inter.to(x.dtype), w2, b2).to(resid.dtype)
    if ln_position == "epilogue":
        out = layer_norm(out, ln_w, ln_b, ln_eps)
    return out


def mlp_block_launch(resid, w1, b1, w2, b2, ln_w, ln_b, *, ln_position: str,
                     ln_eps: float) -> torch.Tensor:
    """The CUDA version (launches only; no counting, no autograd)."""
    b_sz, t, h = resid.shape
    x = resid.contiguous().reshape(b_sz * t, h)
    ln = (*rowstats(x, ln_eps), ln_w, ln_b) if ln_position == "prologue" \
        else None
    inter = gemm(x, w1.to(x.dtype).contiguous(), b1, EPI_BIAS_GELU, ln=ln)
    out = gemm(inter, w2.to(x.dtype).contiguous(), b2, EPI_BIAS_RESID,
               resid=x)
    if ln_position == "epilogue":
        layernorm_(out, ln_w, ln_b, ln_eps)
    return out.reshape(b_sz, t, h)


def mlp_block_int8_plain(resid, w1, b1, w2, b2, ln_w, ln_b, *,
                         ln_position: str, ln_eps: float) -> torch.Tensor:
    """Reference math of K4 (`_kernel_q`): LN? -> quantize (of the LN output
    in x's dtype) -> int8 W1 + b1 -> GELU (fp32, not cast) -> quantize ->
    int8 W2 + b2 -> cast -> + resid -> LN?  Weights are cast to x's dtype
    before they are quantized."""
    x = (layer_norm(resid, ln_w, ln_b, ln_eps) if ln_position == "prologue"
         else resid)
    inter = gelu(int8_linear(*_quant_rows(x.float()),
                             *quant_cols(w1.to(x.dtype)), b1))
    out = int8_linear(*_quant_rows(inter), *quant_cols(w2.to(x.dtype)), b2)
    out = resid + out.to(resid.dtype)
    if ln_position == "epilogue":
        out = layer_norm(out, ln_w, ln_b, ln_eps)
    return out


def mlp_block_int8_launch(resid, w1, b1, w2, b2, ln_w, ln_b, *,
                          ln_position: str, ln_eps: float) -> torch.Tensor:
    """The CUDA version of K4 (launches only; no counting, no autograd)."""
    b_sz, t, h = resid.shape
    x = resid.contiguous().reshape(b_sz * t, h)
    ln = (ln_w, ln_b, ln_eps) if ln_position == "prologue" else None
    inter = gemm_i8(*quant_rows(x, ln=ln), *weight_codes((w1,), x.dtype),
                    b1, I8_EPI_GELU_F32, x.dtype)
    out = gemm_i8(*quant_rows(inter), *weight_codes((w2,), x.dtype), b2,
                  I8_EPI_BIAS_RESID, x.dtype, resid=x)
    if ln_position == "epilogue":
        layernorm_(out, ln_w, ln_b, ln_eps)
    return out.reshape(b_sz, t, h)


def mlp_block_args(
    resid: torch.Tensor,  # <B, T, H>
    w1: torch.Tensor,     # torch layout <inter, H>
    b1: torch.Tensor,
    w2: torch.Tensor,     # torch layout <H, inter>
    b2: torch.Tensor,
    ln: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None,
    ln_position: str = "none",
):
    """`mlp_block`'s arguments -> (tensors, static keywords) of its plain
    version and its kernel."""
    if ln_position not in LN_POSITIONS:
        raise ValueError(f"unknown ln_position {ln_position!r}")
    h = resid.shape[-1]
    if ln is None:
        ln_w = torch.ones(h, device=resid.device)
        ln_b = torch.zeros(h, device=resid.device)
        ln_eps, ln_position = 1e-12, "none"
    else:
        ln_w, ln_b, ln_eps = ln
    static = dict(ln_position=ln_position, ln_eps=float(ln_eps))
    return (resid, w1, b1, w2, b2, ln_w, ln_b), static


# ------------------------------------ intermediate-dim split (K8, K8q)
# One tile: x <B, T, H> (the possibly LN'd input, the same for every tile),
# resid the running residual, torch-layout slices w1 <tile, H> (rows) and
# w2 <H, tile> (columns), cast to x's dtype; b2 is zero but on the last tile.


def mlp_tile_plain(x, resid, w1, b1, w2, b2) -> torch.Tensor:
    """One float tile (`_xla_mlp_sepx`): resid + cast(W2 gelu(W1 x + b1)
    + b2), the intermediate cast to x's dtype.  The plain version of a K8
    tile, and the gradient of a K8q tile, as in the JAX package."""
    inter = gelu(F.linear(x.float(), w1.float(), b1.float())).to(x.dtype)
    return resid + dense(inter, w2, b2).to(resid.dtype)


def mlp_tile_launch(x, resid, w1, b1, w2, b2) -> torch.Tensor:
    """The CUDA version of one float tile (launches only; no counting, no
    autograd).  The W2 column slice is read in place through its row
    stride."""
    b_sz, t, h = resid.shape
    inter = gemm(x.contiguous().reshape(b_sz * t, h), w1.contiguous(), b1,
                 EPI_BIAS_GELU)
    out = gemm(inter, w2, b2, EPI_BIAS_RESID,
               resid=resid.contiguous().reshape(b_sz * t, h))
    return out.reshape(b_sz, t, h)


def mlp_tile_int8_plain(x, resid, w1, b1, w2, b2) -> torch.Tensor:
    """Reference math of one K8q tile (`_kernel_sepx_q`): x quantized per
    token, the tile's W1 rows and W2 columns per output channel of the
    slice, the fp32 GELU intermediate re-quantized per token over the
    slice, resid + cast(acc2 * is * s2 + b2)."""
    inter = gelu(int8_linear(*_quant_rows(x.float()), *quant_cols(w1), b1))
    out = int8_linear(*_quant_rows(inter), *quant_cols(w2), b2)
    return resid + out.to(resid.dtype)


def mlp_tile_int8_launch(x, resid, w1, b1, w2, b2) -> torch.Tensor:
    """The CUDA version of one K8q tile (launches only; no counting, no
    autograd).  The tile's weight codes are made once per weight version,
    the W2 column slice quantized in place through its row stride."""
    b_sz, t, h = resid.shape
    inter = gemm_i8(*quant_rows(x.contiguous().reshape(b_sz * t, h)),
                    *weight_codes((w1,), w1.dtype), b1, I8_EPI_GELU_F32,
                    x.dtype)
    out = gemm_i8(*quant_rows(inter), *weight_codes((w2,), w2.dtype), b2,
                  I8_EPI_BIAS_RESID, x.dtype,
                  resid=resid.contiguous().reshape(b_sz * t, h))
    return out.reshape(b_sz, t, h)


def _tiled(tile, resid, w1, b1, w2, b2, ln_w, ln_b, *, ln_position: str,
           ln_eps: float, n_tiles: int) -> torch.Tensor:
    """`_tiled_mlp`: LN? -> the chain of `tile` over the intermediate
    slices, the residual accumulating -> LN?"""
    x = (layer_norm(resid, ln_w, ln_b, ln_eps) if ln_position == "prologue"
         else resid)
    w1, w2 = w1.to(resid.dtype), w2.to(resid.dtype)
    width = w1.shape[0] // n_tiles
    out = resid
    for k in range(n_tiles):
        sl = slice(k * width, (k + 1) * width)
        b2_k = b2 if k == n_tiles - 1 else torch.zeros_like(b2)
        out = tile(x, out, w1[sl], b1[sl], w2[:, sl], b2_k)
    if ln_position == "epilogue":
        out = layer_norm(out, ln_w, ln_b, ln_eps)
    return out


def mlp_block_tiled_plain(*tensors, n_tiles: int, **static) -> torch.Tensor:
    """The plain float chain (`mlp_block_args` tensors and keywords)."""
    return _tiled(mlp_tile_plain, *tensors, n_tiles=n_tiles, **static)


def mlp_block_tiled(*args, n_tiles: int, **kwargs) -> torch.Tensor:
    """The float chain (K8) of `n_tiles` tiles, one op call per tile.
    Arguments as `mlp_block_args`."""
    tensors, static = mlp_block_args(*args, **kwargs)

    def tile(*ts):
        return dispatch(mlp_tile_launch, mlp_tile_plain, COUNTER_TILED, ts,
                        {})
    return _tiled(tile, *tensors, n_tiles=n_tiles, **static)


def mlp_block_int8_tiled_plain(*tensors, n_tiles: int,
                               **static) -> torch.Tensor:
    """The plain K8q chain (`mlp_block_args` tensors and keywords)."""
    return _tiled(mlp_tile_int8_plain, *tensors, n_tiles=n_tiles, **static)


def mlp_block_int8_tiled(*args, n_tiles: int, **kwargs) -> torch.Tensor:
    """The K8q chain of `n_tiles` tiles, one op call per tile (gradient:
    the float tile's).  Arguments as `mlp_block_args`."""
    tensors, static = mlp_block_args(*args, **kwargs)

    def tile(*ts):
        return dispatch(mlp_tile_int8_launch, mlp_tile_int8_plain,
                        COUNTER_INT8_TILED, ts, {}, grad=mlp_tile_plain)
    return _tiled(tile, *tensors, n_tiles=n_tiles, **static)


def mlp_block(*args, quant: str = "none", **kwargs) -> torch.Tensor:
    """prologue: resid + MLP(LN(resid)); epilogue: LN(resid + MLP(resid));
    none: resid + MLP(resid).  Arguments as `mlp_block_args`; quant="int8"
    is the W8A8 block (K4), whose gradient is the unquantized math's.
    Shapes past the JAX budget take its split (`gates.mlp_block_tiles`):
    the K8q chain in int8, the float K8 chain in bf16 (in fp32 the float
    split is the one-pass block); where no split fits, the unquantized
    block, as the JAX op."""
    if quant not in ("int8", "none"):
        raise ValueError(f"unknown quant mode {quant!r}")
    tensors, static = mlp_block_args(*args, **kwargs)
    resid, w1 = tensors[0], tensors[1]
    n_tiles = gates.mlp_block_tiles(resid.shape[-2], resid.shape[-1],
                                    w1.shape[0], resid.dtype, quant)
    if n_tiles is None:
        quant, n_tiles = "none", 1
    if n_tiles > 1 and quant == "int8":
        return mlp_block_int8_tiled(*args, n_tiles=n_tiles, **kwargs)
    if n_tiles > 1 and resid.dtype == torch.bfloat16:
        return mlp_block_tiled(*args, n_tiles=n_tiles, **kwargs)
    if quant == "int8":
        return dispatch(mlp_block_int8_launch, mlp_block_int8_plain,
                        COUNTER_INT8, tensors, static, grad=mlp_block_plain)
    return dispatch(mlp_block_launch, mlp_block_plain, COUNTER, tensors,
                    static)
