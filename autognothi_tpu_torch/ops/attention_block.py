"""The fused attention block: optional LayerNorm (prologue: pre-norm,
epilogue: post-norm), Q/K/V projections, per-head masked attention, output
projection, bias and residual.

Replaces `autognothi_tpu/ops/attention_block.py:_pallas_attention_block`
(body `_kernel`).  On the H100 one call is a few launches: for pre-norm a
row pass that writes LN(resid) rounded to the activation dtype, the Q/K/V
projections as one TMA + wgmma GEMM (`csrc/gemm_wgmma.cu`, fp32 A split
into tf32 planes in its registers) writing a packed <B*T, 3H> buffer, the
masked attention core (`csrc/attention.cu`), and the out-projection on the
same GEMM, whose epilogue adds bias and residual (plus an LN pass for
post-norm).  The packed Q|K|V weight and bias, the weights' tf32 planes
(fp32) and the fp32 vectors are made once per weight version
(`ops/weight_codes.py`): after the first call, a call launches no
concatenation and no copy.  The <B, heads, T, T> scores stay on chip;
Q/K/V and the context go to device memory.  What bounds it: the
projections' tensor-core work (fp32 as 3xTF32) and the attention core.

quant="int8" is the W8A8 block instead, replacing
`_pallas_attention_block_q` (body `_kernel_q`, K1): the (LN'd) input is
quantized per token, Q/K/V run as int8 products with per-output-channel
weight codes (of the live weights), the masked attention itself stays in
the activation dtype, and the context is re-quantized per token for the
int8 output projection.  On the H100: the row quantizer with the LN
prologue, one int8 GEMM for the packed Q/K/V, the same attention core,
the row quantizer on the context and the int8 GEMM with the residual
epilogue (`csrc/int8.cu`: TMA + wgmma; `csrc/attention.cu`).  The weight
codes and the packed Q/K/V bias are made once per weight version
(`ops/weight_codes.py`): after the first call, a call launches no weight
quantizer and no concatenation.

`attention_block` takes the plain version for CPU tensors and the kernel
for CUDA tensors; there is no other switch.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..kernels.build import LaunchCounter
from ..kernels.primitives import (EPI_WG_BIAS, EPI_WG_BIAS_RESID,
                                  I8_EPI_BIAS, I8_EPI_BIAS_RESID,
                                  attention_core, dispatch, gemm_i8, gemm_wg,
                                  layernorm_, quant_rows, rows_prep)
from ..models.common import dense, layer_norm
from . import gates
from .weight_codes import (float_weight, identity_ln, packed_bias, vec32,
                           weight_codes)

COUNTER = LaunchCounter("attention_block")
COUNTER_INT8 = LaunchCounter("attention_block_int8")

LN_POSITIONS = ("prologue", "epilogue", "none")


def attention_block_plain(resid, mask_row, wq, bq, wk, bk, wv, bv, wo, bo,
                          ln_w, ln_b, *, n_heads: int, mode: str,
                          ln_position: str, ln_eps: float) -> torch.Tensor:
    """Reference math (port of `_xla_attention_block`), weights in torch
    (out, in) layout.  Casts where the JAX math casts: each projection +
    bias to x's dtype, the probabilities to v's dtype, the out-projection +
    bias to the residual's dtype before the add."""
    x = (layer_norm(resid, ln_w, ln_b, ln_eps) if ln_position == "prologue"
         else resid)
    ctx = _attend(dense(x, wq, bq), dense(x, wk, bk), dense(x, wv, bv),
                  mask_row, n_heads, mode)
    out = resid + dense(ctx, wo, bo).to(resid.dtype)
    if ln_position == "epilogue":
        out = layer_norm(out, ln_w, ln_b, ln_eps)
    return out


def _attend(q, k, v, mask_row, n_heads: int, mode: str) -> torch.Tensor:
    """Masked multi-head attention over <B, T, H> projections in the
    activation dtype (`_heads_attention`): fp32 scores and softmax, the
    probabilities cast to v's dtype, fp32 P.V cast to q's dtype."""
    b_sz, t, h = q.shape
    d = h // n_heads

    def heads(y):
        return y.reshape(b_sz, t, n_heads, d).transpose(1, 2)

    scores = torch.matmul(heads(q).float(), heads(k).float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(d))
    m = mask_row.float()[:, None, None, :]
    scores = scores + m if mode == "add" else scores * m
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    ctx = torch.matmul(probs.float(), heads(v).float()).to(q.dtype)
    return ctx.transpose(1, 2).reshape(b_sz, t, h)


def attention_block_int8_plain(resid, mask_row, wq, bq, wk, bk, wv, bv, wo,
                               bo, ln_w, ln_b, *, n_heads: int, mode: str,
                               ln_position: str,
                               ln_eps: float) -> torch.Tensor:
    """Reference math of K1 (`_kernel_q`): the (LN'd, in x's dtype) input
    quantized per token; Q/K/V = int8 products + bias, cast to x's dtype;
    unquantized attention; the context quantized per token; int8 out-proj
    + bias, cast, + resid; LN?  Weights are cast to x's dtype before they
    are quantized."""
    from .mlp_block import _quant_rows, int8_linear, quant_cols

    x = (layer_norm(resid, ln_w, ln_b, ln_eps) if ln_position == "prologue"
         else resid)
    xq = _quant_rows(x.float())

    def proj(w, b):
        return int8_linear(*xq, *quant_cols(w.to(x.dtype)), b).to(x.dtype)

    ctx = _attend(proj(wq, bq), proj(wk, bk), proj(wv, bv), mask_row,
                  n_heads, mode)
    out = int8_linear(*_quant_rows(ctx.float()),
                      *quant_cols(wo.to(x.dtype)), bo)
    out = resid + out.to(resid.dtype)
    if ln_position == "epilogue":
        out = layer_norm(out, ln_w, ln_b, ln_eps)
    return out


def float_product(a: torch.Tensor, w: tuple, bias: torch.Tensor, epi: int,
                  **kw) -> torch.Tensor:
    """`gemm_wg` on a weight from `weight_codes.float_weight` ((bf16,) or
    fp32 (hi, lo) planes)."""
    return gemm_wg(a, w[0], bias, epi, w_lo=w[1] if len(w) > 1 else None,
                   **kw)


def attention_block_launch(resid, mask_row, wq, bq, wk, bk, wv, bv, wo, bo,
                           ln_w, ln_b, *, n_heads: int, mode: str,
                           ln_position: str, ln_eps: float) -> torch.Tensor:
    """The CUDA version (launches only; no counting, no autograd)."""
    b_sz, t, h = resid.shape
    x = resid.contiguous().reshape(b_sz * t, h)
    ln = (vec32(ln_w), vec32(ln_b), ln_eps)
    # one GEMM for the three projections: packed (q | k | v) columns
    a = rows_prep(x, ln) if ln_position == "prologue" else x
    qkv = float_product(a, float_weight((wq, wk, wv), x.dtype),
                        packed_bias((bq, bk, bv)), EPI_WG_BIAS)
    ctx = attention_core(qkv, mask_row, b_sz, t, h, n_heads, mode)
    out = float_product(ctx, float_weight((wo,), x.dtype), vec32(bo),
                        EPI_WG_BIAS_RESID, resids=(x,))
    if ln_position == "epilogue":
        layernorm_(out, *ln)
    return out.reshape(b_sz, t, h)


def attention_block_int8_launch(resid, mask_row, wq, bq, wk, bk, wv, bv, wo,
                                bo, ln_w, ln_b, *, n_heads: int, mode: str,
                                ln_position: str,
                                ln_eps: float) -> torch.Tensor:
    """The CUDA version of K1 (launches only; no counting, no autograd)."""
    b_sz, t, h = resid.shape
    x = resid.contiguous().reshape(b_sz * t, h)
    ln = (ln_w, ln_b, ln_eps) if ln_position == "prologue" else None
    # per-output-channel codes of the stacked rows are each projection's
    # own; made once per weight version
    qkv = gemm_i8(*quant_rows(x, ln=ln),
                  *weight_codes((wq, wk, wv), x.dtype),
                  packed_bias((bq, bk, bv)), I8_EPI_BIAS, x.dtype)
    ctx = attention_core(qkv, mask_row, b_sz, t, h, n_heads, mode)
    out = gemm_i8(*quant_rows(ctx), *weight_codes((wo,), x.dtype), bo,
                  I8_EPI_BIAS_RESID, x.dtype, resid=x)
    if ln_position == "epilogue":
        layernorm_(out, ln_w, ln_b, ln_eps)
    return out.reshape(b_sz, t, h)


def attention_block_args(
    resid: torch.Tensor,      # <B, T, H>
    mask_row: torch.Tensor,   # <B, T>: 0/1 ("mul") or additive bias ("add")
    weights: Tuple[torch.Tensor, ...],  # (wq,bq,wk,bk,wv,bv,wo,bo), torch layout
    n_heads: int,
    mode: str,
    ln: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None,
    ln_position: str = "none",
):
    """`attention_block`'s arguments -> (tensors, static keywords) of its
    plain version and its kernel."""
    if mode not in ("mul", "add"):
        raise ValueError(f"unknown mask mode {mode!r}")
    if ln_position not in LN_POSITIONS:
        raise ValueError(f"unknown ln_position {ln_position!r}")
    h = resid.shape[-1]
    if ln is None:
        ln_w, ln_b = identity_ln(h, resid.device)
        ln_eps, ln_position = 1e-12, "none"
    else:
        ln_w, ln_b, ln_eps = ln
    static = dict(n_heads=n_heads, mode=mode, ln_position=ln_position,
                  ln_eps=float(ln_eps))
    return (resid, mask_row, *weights, ln_w, ln_b), static


def attention_block(*args, quant: str = "none", **kwargs) -> torch.Tensor:
    """prologue: resid + OutProj(Attn(LN(resid)));
    epilogue: LN(resid + OutProj(Attn(resid)));
    none:     resid + OutProj(Attn(resid)).
    Arguments as `attention_block_args`; quant="int8" is the W8A8 block
    (K1), whose gradient is the unquantized math's.  Where the int8 block
    does not fit the JAX budget (`gates.attention_block_fits`: fp32 at
    BERT-base T = 512), the JAX op computes the unquantized block, and so
    does this one."""
    tensors, static = attention_block_args(*args, **kwargs)
    resid = tensors[0]
    if quant == "int8" and not gates.attention_block_fits(
            resid.shape[-2], resid.shape[-1], resid.dtype, quant):
        quant = "none"
    if quant == "int8":
        return dispatch(attention_block_int8_launch,
                        attention_block_int8_plain, COUNTER_INT8, tensors,
                        static, grad=attention_block_plain)
    if quant != "none":
        raise ValueError(f"unknown quant mode {quant!r}")
    return dispatch(attention_block_launch, attention_block_plain, COUNTER,
                    tensors, static)
