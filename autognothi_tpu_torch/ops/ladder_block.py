"""One full LTT ladder step for every side branch: side <- SideLayer(side +
GELU(h Wmap + b)), with SideLayer a complete narrow transformer layer.

Replaces `autognothi_tpu/ops/ladder_block.py:_pallas_ladder` (body
`_kernel`, math `_branch_math`).  On the H100, per branch: the map GEMM
reads the trunk hidden h and fuses bias + GELU + cast + side add in its
epilogue (`csrc/gemm.cu`), then the side layer runs the same launches as
the attention and MLP blocks at 96 wide (12 heads of d = 8), with the
masked attention core keeping the <B, heads, T, T> scores on chip
(`csrc/attention.cu`).  The mapped side, Q/K/V, context and the MLP
intermediate go to device memory.  What bounds it: launch count and the
narrow tensor-core GEMMs (N or K = 96 / 384 fill few tiles), and d = 8
attention, one k8 step of Q.K per key group.

Both layer kinds run on the card: the ViT's "mul" mask with pre-norm
(LN1 and LN2 before attention and MLP) and BERT's additive "add" bias
with post-norm (LN1 after the attention residual, LN2 after the MLP
residual), as `_branch_math(pre_norm=...)`.  Whether the BERT encoder
takes this op at all is the JAX gate `gates.ladder_block_fits`.

`mlp_ladder_block` is the int8 serving step (K2), replacing
`_pallas_mlp_ladder_q` (body `_kernel_mlp_ladder_q`): the trunk's
pre-norm W8A8 MLP block writes the fresh layer output h once, and every
branch's ladder update above reads it, unquantized.  On the H100 that is
the K4 launches (`ops/mlp_block.py`) followed by this module's ladder
launches on h.

`ladder_attention` is the masked attention core for every branch at once
(K10), replacing `_make_attn_fn` (body `_attn_kernel`, public
`ladder_attention`): separate q, k, v <B, T, S> per branch.  It is a thin
wrapper over K9's core (`csrc/attention.cu`), launched once per branch on
the <B, T, S> tensors' own head-merged strides; no model calls it.

`ladder_block`, `mlp_ladder_block` and `ladder_attention` take the plain
version for CPU tensors and the kernel for CUDA tensors; there is no other
switch.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels.build import LaunchCounter
from ..kernels.primitives import (EPI_BIAS_GELU_RESID, attention_heads,
                                  dispatch, gemm)
from ..models.common import gelu
from .attention_block import attention_block_launch, attention_block_plain
from .mlp_block import (mlp_block_int8_launch, mlp_block_int8_plain,
                        mlp_block_launch, mlp_block_plain)

COUNTER = LaunchCounter("ladder_block")
COUNTER_MLP_LADDER = LaunchCounter("mlp_ladder_block")
COUNTER_ATTENTION = LaunchCounter("ladder_attention")

TRUNK_MLP_KEYS = ("w1", "b1", "w2", "b2", "ln_w", "ln_b")

BRANCH_KEYS = ("map_w", "map_b", "ln1_w", "ln1_b", "wq", "bq", "wk", "bk",
               "wv", "bv", "wo", "bo", "ln2_w", "ln2_b", "w1", "b1", "w2",
               "b2")
N_BRANCH_ARGS = len(BRANCH_KEYS)


def _branch_plain(h, side, mask_row, args, *, n_heads, mode, pre_norm,
                  ln_eps):
    """One branch's update (port of `_branch_math` on the XLA path)."""
    (map_w, map_b, ln1_w, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo,
     ln2_w, ln2_b, w1, b1, w2, b2) = args
    mapped = F.linear(h.float(), map_w.float(), map_b.float())
    x = side + gelu(mapped).to(side.dtype)
    position = "prologue" if pre_norm else "epilogue"
    x = attention_block_plain(x, mask_row, wq, bq, wk, bk, wv, bv, wo, bo,
                              ln1_w, ln1_b, n_heads=n_heads, mode=mode,
                              ln_position=position, ln_eps=ln_eps)
    return mlp_block_plain(x, w1, b1, w2, b2, ln2_w, ln2_b,
                           ln_position=position, ln_eps=ln_eps)


def ladder_block_plain(h, mask_row, *flat, n_branches, n_heads, mode,
                       pre_norm, ln_eps) -> Tuple[torch.Tensor, ...]:
    """flat = sides + per-branch args (BRANCH_KEYS order, torch layout)."""
    sides = flat[:n_branches]
    return tuple(
        _branch_plain(h, sides[s], mask_row,
                      flat[n_branches + s * N_BRANCH_ARGS:
                           n_branches + (s + 1) * N_BRANCH_ARGS],
                      n_heads=n_heads, mode=mode, pre_norm=pre_norm,
                      ln_eps=ln_eps)
        for s in range(n_branches))


def ladder_block_launch(h, mask_row, *flat, n_branches, n_heads, mode,
                        pre_norm, ln_eps) -> Tuple[torch.Tensor, ...]:
    """The CUDA version (launches only; no counting, no autograd).  Pre-norm
    (ViT): LN1 and LN2 are the side layer's prologues; post-norm (BERT):
    its epilogues, after each residual add."""
    b_sz, t, hidden = h.shape
    h2 = h.contiguous().reshape(b_sz * t, hidden)
    position = "prologue" if pre_norm else "epilogue"
    outs = []
    for s in range(n_branches):
        side = flat[s]
        (map_w, map_b, ln1_w, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo,
         ln2_w, ln2_b, w1, b1, w2, b2) = flat[
            n_branches + s * N_BRANCH_ARGS:n_branches + (s + 1) * N_BRANCH_ARGS]
        s_hidden = side.shape[-1]
        x = gemm(h2, map_w.contiguous(), map_b, EPI_BIAS_GELU_RESID,
                 resid=side.contiguous().reshape(b_sz * t, s_hidden))
        x = attention_block_launch(
            x.reshape(b_sz, t, s_hidden), mask_row, wq, bq, wk, bk, wv, bv,
            wo, bo, ln1_w, ln1_b, n_heads=n_heads, mode=mode,
            ln_position=position, ln_eps=ln_eps)
        outs.append(mlp_block_launch(x, w1, b1, w2, b2, ln2_w, ln2_b,
                                     ln_position=position, ln_eps=ln_eps))
    return tuple(outs)


def ladder_block_args(
    h: torch.Tensor,                  # <B, T, hidden> trunk layer output
    sides: Sequence[torch.Tensor],    # per-branch <B, T, s_hidden>
    mask_row: torch.Tensor,           # <B, T>
    branch_weights: Sequence[Dict[str, torch.Tensor]],  # BRANCH_KEYS, torch layout
    n_heads: int,
    mode: str,                        # "mul" (ViT quirk) | "add" (BERT)
    pre_norm: bool,                   # True: ViT pre-norm; False: post-norm
    ln_eps: float,
):
    """`ladder_block`'s arguments -> (tensors, static keywords) of its plain
    version and its kernel.  Every branch weight is cast to h's dtype, as
    the JAX op does."""
    if mode not in ("mul", "add"):
        raise ValueError(f"unknown mask mode {mode!r}")
    flat = [*sides]
    for w in branch_weights:
        flat.extend(w[k].to(h.dtype) for k in BRANCH_KEYS)
    static = dict(n_branches=len(sides), n_heads=n_heads, mode=mode,
                  pre_norm=pre_norm, ln_eps=float(ln_eps))
    return (h, mask_row, *flat), static


def ladder_block(*args, **kwargs) -> Tuple[torch.Tensor, ...]:
    """-> updated sides: SideLayer_b(side_b + gelu(Map_b(h))).  Arguments
    as `ladder_block_args`."""
    tensors, static = ladder_block_args(*args, **kwargs)
    return dispatch(ladder_block_launch, ladder_block_plain, COUNTER,
                    tensors, static)


# ------------------------------------------------- trunk int8 MLP + ladder


def _mlp_ladder(mlp, ladder, h_attn, mask_row, w1, b1, w2, b2, ln_w, ln_b,
                *flat, n_branches, n_heads, mode, ln_eps):
    h = mlp(h_attn, w1, b1, w2, b2, ln_w, ln_b, ln_position="prologue",
            ln_eps=ln_eps)
    return (h, *ladder(h, mask_row, *flat, n_branches=n_branches,
                       n_heads=n_heads, mode=mode, pre_norm=True,
                       ln_eps=ln_eps))


def mlp_ladder_block_plain(h_attn, mask_row, *args, **static):
    """Reference math of K2: the int8 trunk MLP block (pre-norm), then every
    branch's unquantized ladder update from the fresh h -> (h, *sides)."""
    return _mlp_ladder(mlp_block_int8_plain, ladder_block_plain, h_attn,
                       mask_row, *args, **static)


def mlp_ladder_block_float(h_attn, mask_row, *args, **static):
    """The same step with an unquantized trunk MLP (`_xla_mlp_ladder`, the
    gradient of K2)."""
    return _mlp_ladder(mlp_block_plain, ladder_block_plain, h_attn,
                       mask_row, *args, **static)


def mlp_ladder_block_launch(h_attn, mask_row, *args, **static):
    """The CUDA version of K2 (launches only; no counting, no autograd):
    h is written once, by the W2 GEMM, and read by every branch."""
    return _mlp_ladder(mlp_block_int8_launch, ladder_block_launch, h_attn,
                       mask_row, *args, **static)


def mlp_ladder_block_args(
    h_attn: torch.Tensor,             # <B, T, hidden> trunk attention out
    sides: Sequence[torch.Tensor],    # per-branch <B, T, s_hidden>
    mask_row: torch.Tensor,           # <B, T>
    trunk_mlp: Dict[str, torch.Tensor],  # TRUNK_MLP_KEYS, torch layout
    branch_weights: Sequence[Dict[str, torch.Tensor]],
    n_heads: int,
    mode: str,
    ln_eps: float,
):
    """`mlp_ladder_block`'s arguments -> (tensors, static keywords) of its
    plain version and its kernel.  The branch weights are cast to h's
    dtype as the JAX op casts them (the MLP ops cast the trunk's w1/w2)."""
    (h, mask_row, *flat), static = ladder_block_args(
        h_attn, sides, mask_row, branch_weights, n_heads, mode, True, ln_eps)
    static.pop("pre_norm")
    trunk = [trunk_mlp[k] for k in TRUNK_MLP_KEYS]
    return (h, mask_row, *trunk, *flat), static


def mlp_ladder_block(*args, **kwargs) -> Tuple[torch.Tensor, ...]:
    """-> (h_next, *updated sides): the trunk's pre-norm int8 MLP block
    fused with the full ladder step (W8A8 trunk products; ladders in the
    activation dtype); the gradient is the unquantized step's.  Arguments
    as `mlp_ladder_block_args`."""
    tensors, static = mlp_ladder_block_args(*args, **kwargs)
    return dispatch(mlp_ladder_block_launch, mlp_ladder_block_plain,
                    COUNTER_MLP_LADDER, tensors, static,
                    grad=mlp_ladder_block_float)


# ------------------------------------------------- ladder attention (K10)


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """<B, T, S> -> the <B, heads, T, S / heads> view of its head columns."""
    b, t, s = x.shape
    return x.reshape(b, t, n_heads, s // n_heads).transpose(1, 2)


def ladder_attention_plain(mask_row, *qkv_flat, n_heads: int,
                           mode: str) -> Tuple[torch.Tensor, ...]:
    """Reference math (port of `_xla_ctx` per branch): fp32 scores x
    1/sqrt(d), the mask multiplied or added, fp32 softmax cast to v's
    dtype, fp32 P.V cast to q's dtype -> per-branch <B, T, S>."""
    outs = []
    for s in range(len(qkv_flat) // 3):
        q, k, v = qkv_flat[3 * s:3 * s + 3]
        b, t, s_hidden = q.shape
        scale = 1.0 / math.sqrt(s_hidden // n_heads)
        scores = torch.matmul(_heads(q, n_heads).float(),
                              _heads(k, n_heads).float().transpose(-1, -2)
                              ) * scale
        m = mask_row.float()[:, None, None, :]
        scores = scores + m if mode == "add" else scores * m
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = torch.matmul(probs.float(), _heads(v, n_heads).float())
        outs.append(ctx.transpose(1, 2).reshape(b, t, s_hidden).to(q.dtype))
    return tuple(outs)


def ladder_attention_launch(mask_row, *qkv_flat, n_heads: int,
                            mode: str) -> Tuple[torch.Tensor, ...]:
    """The CUDA version: one core launch per branch (no counting, no
    autograd)."""
    outs = []
    for s in range(len(qkv_flat) // 3):
        q, k, v = qkv_flat[3 * s:3 * s + 3]
        out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
        attention_heads(_heads(q, n_heads), _heads(k, n_heads),
                        _heads(v, n_heads), mask_row, mode,
                        _heads(out, n_heads))
        outs.append(out)
    return tuple(outs)


def ladder_attention(qkvs: Sequence[Tuple[torch.Tensor, ...]],
                     mask_row: torch.Tensor, n_heads: int,
                     mode: str) -> Tuple[torch.Tensor, ...]:
    """Masked multi-head attention for every ladder branch at once: `qkvs`
    holds a (q, k, v) triple of <B, T, S> per branch -> the per-branch
    context tuple."""
    if mode not in ("mul", "add"):
        raise ValueError(f"unknown mask mode {mode!r}")
    flat = [a for triple in qkvs for a in triple]
    return dispatch(ladder_attention_launch, ladder_attention_plain,
                    COUNTER_ATTENTION, (mask_row, *flat),
                    dict(n_heads=n_heads, mode=mode))
