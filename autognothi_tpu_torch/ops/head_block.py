"""The explainer MLP head in W8A8 serving form: LayerNorm (eps 1e-5), the
two wide denses as int8 products with GELUs, and the class projection as a
float product.

Replaces `autognothi_tpu/ops/head_block.py:_pallas_head_q` (body
`_kernel_q`, K3): LN -> per-token int8 codes -> int8 d1 + b1 -> GELU
(fp32) -> re-quantized per token -> int8 d2 + b2 -> GELU -> cast to the
activation dtype -> float d3 + b3 (fp32 accumulation) -> cast.  The JAX
kernel splits d2/d3 into column chunks only to fit the TPU's VMEM; the
function is the same.  On the H100: the row quantizer with the LN
prologue, the int8 GEMM with a GELU epilogue writing the fp32 <M, 3072>
intermediate, the row quantizer, the int8 GEMM with a GELU + cast
epilogue (`csrc/int8.cu`), and the port's float GEMM for d3
(`csrc/gemm.cu`).  The d1 and d2 weights are quantized from the live
weights without a cast (as the JAX op), once per weight version
(`ops/weight_codes.py`); d3's weight is cast to the activation dtype.
What bounds it: the 3072x3072 d2 product and the fp32 intermediate's
round trip through device memory.

`explainer_head_block` takes the plain version for CPU tensors and the
kernel for CUDA tensors; there is no other switch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.build import LaunchCounter
from ..kernels.primitives import (EPI_BIAS, I8_EPI_GELU, I8_EPI_GELU_F32,
                                  dispatch, gemm, gemm_i8, quant_rows)
from ..models.common import dense, gelu, layer_norm
from .mlp_block import _quant_rows, int8_linear, quant_cols
from .weight_codes import weight_codes

COUNTER = LaunchCounter("head_block")


def _ln(x, ln_w, ln_b, has_ln: bool, ln_eps: float) -> torch.Tensor:
    return layer_norm(x, ln_w, ln_b, ln_eps) if has_ln else x


def head_plain(x, w1, b1, w2, b2, w3, b3, ln_w, ln_b, *, has_ln: bool,
               ln_eps: float) -> torch.Tensor:
    """The unquantized head (`_xla_head`): the gradient of K3."""
    x = _ln(x, ln_w, ln_b, has_ln, ln_eps)
    h = gelu(dense(x, w1, b1).float()).to(x.dtype)
    h = gelu(dense(h, w2, b2).float()).to(x.dtype)
    return dense(h, w3, b3)


def head_int8_plain(x, w1, b1, w2, b2, w3, b3, ln_w, ln_b, *, has_ln: bool,
                    ln_eps: float) -> torch.Tensor:
    """Reference math of K3 (`_kernel_q`), torch-layout weights."""
    x = _ln(x, ln_w, ln_b, has_ln, ln_eps)
    h = gelu(int8_linear(*_quant_rows(x.float()), *quant_cols(w1), b1))
    h2 = gelu(int8_linear(*_quant_rows(h), *quant_cols(w2), b2)).to(x.dtype)
    out = F.linear(h2.float(), w3.to(x.dtype).float(), b3.float())
    return out.to(x.dtype)


def head_int8_launch(x, w1, b1, w2, b2, w3, b3, ln_w, ln_b, *, has_ln: bool,
                     ln_eps: float) -> torch.Tensor:
    """The CUDA version of K3 (launches only; no counting, no autograd)."""
    b_sz, t, h_in = x.shape
    x2 = x.contiguous().reshape(b_sz * t, h_in)
    h = gemm_i8(*quant_rows(x2, ln=(ln_w, ln_b, ln_eps) if has_ln else None),
                *weight_codes((w1,), w1.dtype), b1, I8_EPI_GELU_F32, x.dtype)
    h2 = gemm_i8(*quant_rows(h), *weight_codes((w2,), w2.dtype), b2,
                 I8_EPI_GELU, x.dtype)
    out = gemm(h2, w3.to(x.dtype).contiguous(), b3, EPI_BIAS)
    return out.reshape(b_sz, t, -1)


def explainer_head_block_args(
    x: torch.Tensor,              # <B, T, Hin>
    w1: torch.Tensor,             # torch layout <inter, Hin>
    b1: torch.Tensor,
    w2: torch.Tensor,             # <inter, inter>
    b2: torch.Tensor,
    w3: torch.Tensor,             # <C, inter>
    b3: torch.Tensor,
    ln_w: Optional[torch.Tensor],  # None: no leading LayerNorm (BERT head)
    ln_b: Optional[torch.Tensor],
    ln_eps: float,
):
    """`explainer_head_block`'s arguments -> (tensors, static keywords) of
    its plain version and its kernel."""
    has_ln = ln_w is not None
    if not has_ln:
        ln_w = torch.ones(x.shape[-1], device=x.device)
        ln_b = torch.zeros(x.shape[-1], device=x.device)
    return ((x, w1, b1, w2, b2, w3, b3, ln_w, ln_b),
            dict(has_ln=has_ln, ln_eps=float(ln_eps)))


def explainer_head_block(*args, **kwargs) -> torch.Tensor:
    """-> <B, T, C>: d3(gelu(d2(gelu(d1(LN?(x)))))) with int8 d1/d2 (K3);
    the gradient is the unquantized head's.  Arguments as
    `explainer_head_block_args`.  The models call it only where a token
    tile of the fused head fits the JAX budget (`gates.head_token_tile`),
    as the JAX models do."""
    tensors, static = explainer_head_block_args(*args, **kwargs)
    return dispatch(head_int8_launch, head_int8_plain, COUNTER, tensors,
                    static, grad=head_plain)
