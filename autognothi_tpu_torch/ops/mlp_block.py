"""The fused MLP block: optional LayerNorm (prologue or epilogue),
up-projection + bias, exact GELU, down-projection + bias, residual.

Replaces `autognothi_tpu/ops/mlp_block.py:_pallas_mlp_block` (body
`_kernel`) and its intermediate-dim split `_pallas_mlp_sepx` (body
`_kernel_sepx`, chained by `_tiled_mlp`), which computes the same function
in tiles only because the fp32 ViT-B weights exceed the TPU's VMEM budget.
On the H100 one call is: LN statistics, the W1 GEMM reading LN(resid) on
the fly with a bias + GELU epilogue, and the W2 GEMM with a bias + residual
epilogue, which walks the intermediate dim in 16-deep slices inside the
kernel (`csrc/gemm.cu`); post-norm adds an LN pass.  The <B*T, 4H>
intermediate goes to device memory.  What bounds it: the SIMT fp32 GEMMs.

quant="int8" is the W8A8 serving block instead, replacing
`_pallas_mlp_block_q` (body `_kernel_q`, K4): LN -> per-token int8 codes
-> int8 W1 (per-output-channel codes of the live weights, quantized at
each call) -> bias + GELU in fp32 -> re-quantized per token -> int8 W2 ->
bias -> cast -> + resid.  On the H100: the row quantizer with the LN
prologue, the int8 GEMM with a GELU epilogue writing the fp32
intermediate, the row quantizer again and the int8 GEMM with the residual
epilogue (`csrc/int8.cu`).  This module also holds the two quantizers of
the JAX package (`quant_cols`, `_quant_rows`) and the exact int8 product
the plain versions share.

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
from .attention_block import LN_POSITIONS

COUNTER = LaunchCounter("mlp_block")
COUNTER_INT8 = LaunchCounter("mlp_block_int8")


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
    inter = gemm_i8(*quant_rows(x, ln=ln),
                    *quant_rows(w1.to(x.dtype).contiguous(), weight=True),
                    b1, I8_EPI_GELU_F32, x.dtype)
    out = gemm_i8(*quant_rows(inter),
                  *quant_rows(w2.to(x.dtype).contiguous(), weight=True),
                  b2, I8_EPI_BIAS_RESID, x.dtype, resid=x)
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


def mlp_block(*args, quant: str = "none", **kwargs) -> torch.Tensor:
    """prologue: resid + MLP(LN(resid)); epilogue: LN(resid + MLP(resid));
    none: resid + MLP(resid).  Arguments as `mlp_block_args`; quant="int8"
    is the W8A8 block (K4), whose gradient is the unquantized math's."""
    tensors, static = mlp_block_args(*args, **kwargs)
    if quant == "int8":
        return dispatch(mlp_block_int8_launch, mlp_block_int8_plain,
                        COUNTER_INT8, tensors, static, grad=mlp_block_plain)
    if quant != "none":
        raise ValueError(f"unknown quant mode {quant!r}")
    return dispatch(mlp_block_launch, mlp_block_plain, COUNTER, tensors,
                    static)
