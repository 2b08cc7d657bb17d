"""The explainer MLP head in W8A8 serving form: LayerNorm (eps 1e-5), the
two wide denses as int8 products with GELUs, and the class projection as a
float product.

Replaces `autognothi_tpu/ops/head_block.py:_pallas_head_q` (body
`_kernel_q`, K3): LN -> per-token int8 codes -> int8 d1 + b1 -> GELU
(fp32) -> re-quantized per token -> int8 d2 + b2 -> GELU -> cast to the
activation dtype -> float d3 + b3 (fp32 accumulation) -> cast.  The JAX
kernel keeps h and h2 on chip and folds d3 into d2's column chunks (out +=
h2_chunk @ w3[chunk]).  On the H100, three launches:
1. d1 straight to h's codes (`csrc/int8_block.cu`): a block of 64 rows
   makes x's codes (LN prologue), runs d1 twice (K = 96), first for each
   row's max |GELU|, then to write the codes `quant_rows` makes of h and
   their scales: the fp32 <M, 3072> h never reaches device memory;
2. d2 on the int8 GEMM (`csrc/int8.cu`, TMA + wgmma) with the fold
   epilogue: bias, GELU, the cast to the activation dtype, and each column
   tile's h2 slice times the matching slice of w3 (cast to the activation
   dtype, as JAX does) on mma.sync products from the accumulator's
   registers (bf16 exact, fp32 as 3xTF32) into an fp32 <tile, M, C> partial
   sum: h2 never reaches device memory;
3. the partials summed in a fixed order with b3, then cast.
That narrow d1 kernel takes inputs up to 128 wide (the LTT side heads;
`csrc/int8_block.cu:ag_head_d1`).  The
vanilla and froyo heads read the trunk's hidden state (768 at ViT-B and
BERT-base, 384 at ViT-S, 192 at ViT-T), which the JAX gate admits as well;
there d1 is two launches of K4's trunk tools instead (the "wide" route,
`k3_route`): the row quantizer makes x's codes (with the LN prologue), the
int8 GEMM's GELU epilogue (`I8_EPI_GELU_F32`) writes h in fp32, and a
second row-quantizer pass makes h's codes and scales (the pass needs each
row's max |h| anyway, so the GEMM raises no row maxima).  d2 and the sum
are the narrow route's.  So the fp32 <M, inter> h reaches device memory
once and is read once (155 MB at ViT-B B=64), where the narrow route's
d1 would recompute a 768-deep product to keep it on chip.
The fold's sum order differs from JAX's 4 chunks by an fp32 reordering
only.  It takes up to `I8_MAX_FOLD` classes (the repo's heads have 2 and
10); more raise `ValueError` on the card.  The d1 and d2 weights are
quantized from the live weights without a cast (as the JAX op), once per
weight version (`ops/weight_codes.py`), and so is w3's cast.  What bounds
it: the 3072 x 3072 d2 product (238 GOP at ViT B=64), then d1's GELUs.

`explainer_head_block` takes the plain version for CPU tensors and the
kernel for CUDA tensors; there is no other switch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.build import LaunchCounter
from ..kernels.primitives import (I8_EPI_GELU_F32, I8_EPI_GELU_FOLD,
                                  I8_MAX_FOLD, dispatch, fold_planes,
                                  fold_sum, gemm_i8, head_d1, quant_rows)
from ..models.common import dense, gelu, layer_norm
from .mlp_block import _quant_rows, int8_linear, quant_cols
from .weight_codes import cached, identity_ln, vec32, weight_codes

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


def _fold_planes(w3: torch.Tensor, dtype: torch.dtype):
    """What d2's fold epilogue reads of w3 <C, inter>: w3 cast to the
    activation dtype (the float d3's weight as JAX casts it), padded to
    I8_MAX_FOLD rows, as bf16 or as fp32's tf32 planes
    (`fold_planes`), once per version of w3."""
    def make():
        with torch.no_grad():
            return fold_planes(w3, dtype)

    return cached((w3,), ("fold", dtype), make)


# the widest input and d1 output the narrow d1 kernel takes
# (`csrc/int8_block.cu:ag_head_d1`)
HEAD_D1_MAX_K, HEAD_D1_MAX_N = 128, 4096


def k3_route(h_in: int, inter: int, classes: int) -> str:
    """K3's route on the card for a head h_in -> inter -> inter -> classes:
    "narrow" (d1 straight to h's codes in one launch) where the narrow d1
    kernel takes the widths, else "wide" (d1 as the row quantizer, the
    int8 GEMM with the fp32 GELU epilogue and the row quantizer of h).  A
    pure function of the shapes.  Raises ValueError for more than
    I8_MAX_FOLD classes (d2's fold) or widths that are not multiples of
    16 (the int8 GEMM's K)."""
    if classes > I8_MAX_FOLD:
        raise ValueError(f"the head's d3 fold takes at most {I8_MAX_FOLD} "
                         f"classes, got {classes}")
    if h_in % 16 or inter % 16 or h_in < 16 or inter < 16:
        raise ValueError(f"K3 takes widths that are multiples of 16, got "
                         f"{h_in} -> {inter}")
    if h_in <= HEAD_D1_MAX_K and inter <= HEAD_D1_MAX_N:
        return "narrow"
    return "wide"


def _d1_wide(x2, w1, b1, ln) -> tuple:
    """d1 on the wide route -> (h's int8 codes <M, inter>, fp32 scales)."""
    xq, xs = quant_rows(x2, ln=ln)
    h = gemm_i8(xq, xs, *weight_codes((w1,), w1.dtype), vec32(b1),
                I8_EPI_GELU_F32, x2.dtype)
    return quant_rows(h)


def head_int8_launch(x, w1, b1, w2, b2, w3, b3, ln_w, ln_b, *, has_ln: bool,
                     ln_eps: float) -> torch.Tensor:
    """The CUDA version of K3 (launches only; no counting, no autograd):
    d1 to h's codes on the route `k3_route` picks, d2 with d3 folded into
    its epilogue, the fold's sum."""
    b_sz, t, h_in = x.shape
    route = k3_route(h_in, w1.shape[0], w3.shape[0])
    x2 = x.contiguous().reshape(b_sz * t, h_in)
    ln = (vec32(ln_w), vec32(ln_b), ln_eps) if has_ln else None
    if route == "narrow":
        hq, hs = head_d1(x2, *weight_codes((w1,), w1.dtype), vec32(b1),
                         ln=ln)
    else:
        hq, hs = _d1_wide(x2, w1, b1, ln)
    part = gemm_i8(hq, hs, *weight_codes((w2,), w2.dtype), vec32(b2),
                   I8_EPI_GELU_FOLD, x.dtype, fold=_fold_planes(w3, x.dtype),
                   classes=w3.shape[0])
    return fold_sum(part, vec32(b3), x.dtype).reshape(b_sz, t, -1)


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
        ln_w, ln_b = identity_ln(x.shape[-1], x.device)
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
