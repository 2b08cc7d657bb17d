"""One full LTT ladder step for every side branch: side <- SideLayer(side +
GELU(h Wmap + b)), with SideLayer a complete narrow transformer layer.

Replaces `autognothi_tpu/ops/ladder_block.py:_pallas_ladder` (body
`_kernel`, math `_branch_math`).  On the H100 one ladder step is four
launches, whatever the number of branches (`csrc/ladder.cu` says why and
what goes to device memory):
1. side-in: h times every branch's map weight at once (one TMA + wgmma
   GEMM, `csrc/gemm_wgmma.cu`: h read once), bias, GELU, cast and the
   side added in its epilogue -> x <branches, M, S>;
2. side QKV: LN1 (pre-norm) and the Q|K|V projection of every branch;
3. side attention: all heads of every branch, the context kept on chip,
   out-projection, bias, residual and (post-norm) LN1;
4. side MLP: LN2, W1, GELU, W2, bias, residual and LN2, the intermediate
   kept on chip.
Each stage has a plain version of its own (`side_in_plain`,
`side_qkv_plain`, `side_attention_plain`, `side_mlp_plain`), on the same
branch-major tensors as its launch; chained they compute
`ladder_block_plain`.  The branches' weights are packed per kind once per
weight version (`ops/weight_codes.py:cached`), so a step launches no
concatenation and no copy.  The stage kernels take any side width that is
a multiple of 8 up to 128, in heads of d = 8 (`ag_ladder_supports`), and
any MLP width that is a multiple of 8; more than four branches take one
side-in launch per four.

Every other side shape the JAX gate admits (a side of hidden / 4, heads of
d = 4 or 16-128) takes the second route, `ladder_route` says which by shape
alone: the same side-in launch, then each branch's side layer on the
kernels of the float attention block (the Q|K|V and out-projection
products on `csrc/gemm_wgmma.cu`, the core of `csrc/attention.cu`, which
runs d = 8, 16, 32, 64 or 128 at any T and zero-pads a narrower head,
such as d = 4, to the next of them) and of the float MLP block
(`csrc/gemm.cu`).  A head wider than 128 raises.

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
`ladder_attention`): separate q, k, v <B, T, S> per branch; no model calls
it.  `ladder_attention_route` picks by shape: heads of d = 8 (S a multiple
of 8 up to 128, the only head width the ladders build) take one launch of
`csrc/ladder_attention.cu` for every branch ("narrow"); any other head
takes K9's core (`csrc/attention.cu`) once per branch on the <B, T, S>
tensors' own head-merged strides ("per_branch").

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
from ..kernels.primitives import (CORE_HEAD_DIMS, EPI_BIAS_GELU,
                                  EPI_BIAS_RESID, EPI_WG_BIAS,
                                  LADDER_ATTENTION_MAX_BRANCHES,
                                  LADDER_ATTENTION_MAX_T,
                                  EPI_WG_BIAS_RESID, EPI_WG_GELU_RESID_SPLIT,
                                  LADDER_ATTENTION, LADDER_MLP, LADDER_QKV,
                                  WG_MAX_BRANCHES, attention_core,
                                  attention_heads, core_head_dim, dispatch,
                                  gemm, gemm_wg, ladder_attention_narrow,
                                  ladder_stage, layernorm_,
                                  rows_prep, rowstats)
from ..models.common import dense, gelu, layer_norm
from .attention_block import (_attend, attention_block_plain,
                              float_product)
from .mlp_block import (mlp_block_int8_launch, mlp_block_int8_plain,
                        mlp_block_plain)
from .weight_codes import cached, float_weight, tf32_planes

COUNTER = LaunchCounter("ladder_block")
# the ladder_block calls of those that took the per-branch route
COUNTER_PER_BRANCH = LaunchCounter("ladder_block_per_branch")
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
    """flat = sides + per-branch args (BRANCH_KEYS order, torch layout).
    Every branch weight is cast to h's dtype first, as the JAX op does."""
    sides = flat[:n_branches]
    weights = [w.to(h.dtype) for w in flat[n_branches:]]
    return tuple(
        _branch_plain(h, sides[s], mask_row,
                      weights[s * N_BRANCH_ARGS:(s + 1) * N_BRANCH_ARGS],
                      n_heads=n_heads, mode=mode, pre_norm=pre_norm,
                      ln_eps=ln_eps)
        for s in range(n_branches))


# --------------------------------------------------- the four stages


def ladder_pack(flat, n_branches: int, dtype: torch.dtype,
                planes: bool = False) -> dict:
    """The branches' weights (`flat` past the sides, BRANCH_KEYS order) as
    the stages read them: map_w <branches * S, H> and map_b the rows of
    every branch's map; per kind, the branches stacked on a first axis:
    wqkv <nb, 3S, S>, bqkv, wo, bo, w1 <nb, I, S>, b1, w2 <nb, S, I>, b2,
    the LN vectors.  Every weight is cast to `dtype`, as the JAX op casts
    it; matrices stay in `dtype`, vectors are widened to fp32.  planes
    (fp32): also map_w's tf32 planes as `map_planes`, the side-in GEMM's
    weight."""
    args = flat[n_branches:]
    branches = [dict(zip(BRANCH_KEYS, args[s * N_BRANCH_ARGS:
                                           (s + 1) * N_BRANCH_ARGS]))
                for s in range(n_branches)]
    with torch.no_grad():
        def stack(make):
            return torch.stack([make(w) for w in branches]).contiguous()

        def mat(k):
            return stack(lambda w: w[k].to(dtype))

        def vec(k):
            return stack(lambda w: w[k].to(dtype).float())

        pack = {k: mat(k) for k in ("wo", "w1", "w2")}
        pack.update({k: vec(k) for k in ("bo", "b1", "b2", "ln1_w", "ln1_b",
                                         "ln2_w", "ln2_b")})
        pack["map_w"] = torch.cat([w["map_w"].to(dtype) for w in branches])
        pack["map_b"] = torch.cat([w["map_b"].to(dtype).float()
                                   for w in branches])
        pack["wqkv"] = stack(lambda w: torch.cat(
            [w["wq"], w["wk"], w["wv"]]).to(dtype))
        pack["bqkv"] = stack(lambda w: torch.cat(
            [w["bq"], w["bk"], w["bv"]]).to(dtype).float())
        if planes and dtype == torch.float32:
            pack["map_planes"] = tf32_planes(pack["map_w"])
    return pack


def side_in_plain(h2, sides, map_w, map_b):
    """x_b = side_b + cast(gelu(h Wmap_b^T + bmap_b)) for every branch:
    h2 <M, H>, sides <M, S> each, map_w <branches * S, H> -> <nb, M, S>."""
    mapped = gelu(F.linear(h2.float(), map_w.float(), map_b.float()))
    s = sides[0].shape[-1]
    return torch.stack([side + mapped[:, i * s:(i + 1) * s].to(side.dtype)
                        for i, side in enumerate(sides)])


def side_in_launch(h2, sides, map_w, map_b, *planes):
    """`side_in_plain` as one TMA + wgmma GEMM per four branches (fp32: A
    split in registers; the map weight's tf32 planes as given, or once per
    version of map_w)."""
    hi, *lo = planes or float_weight((map_w,), map_w.dtype)
    s = sides[0].shape[-1]
    x = torch.empty((len(sides), h2.shape[0], s), device=h2.device,
                    dtype=h2.dtype)
    for b0 in range(0, len(sides), WG_MAX_BRANCHES):
        b1 = min(b0 + WG_MAX_BRANCHES, len(sides))
        rows = slice(b0 * s, b1 * s)
        gemm_wg(h2, hi[rows], map_b[rows], EPI_WG_GELU_RESID_SPLIT,
                w_lo=lo[0][rows] if lo else None, resids=sides[b0:b1],
                out=x[b0:b1], split=s)
    return x


def side_qkv_plain(x, wqkv, bqkv, ln1_w, ln1_b, eps, pre_norm):
    """Q|K|V <nb, M, 3S> = cast(LN1?(x_b) Wqkv_b^T + b) of x <nb, M, S>."""
    return torch.stack([
        dense(layer_norm(x[i], ln1_w[i], ln1_b[i], eps) if pre_norm
              else x[i], wqkv[i], bqkv[i]) for i in range(x.shape[0])])


def side_qkv_launch(x, wqkv, bqkv, ln1_w, ln1_b, eps, pre_norm):
    ln = dict(lnw=ln1_w, lnb=ln1_b, eps=eps) if pre_norm else {}
    return ladder_stage(LADDER_QKV, x, w=wqkv, b=bqkv, **ln)


def side_attention_plain(x, qkv, mask_row, wo, bo, ln1_w, ln1_b, eps,
                         n_heads, mode, pre_norm):
    """x1 <nb, M, S> = x_b + cast(Attn_b Wo_b^T + bo_b) (then LN1 for
    post-norm), Attn the masked multi-head attention of Q|K|V <nb, M, 3S>
    over the images of mask_row <B, T>, its context cast to x's dtype."""
    nb, m, s = x.shape
    b_sz, t = mask_row.shape
    outs = []
    for i in range(nb):
        q, k, v = (y.reshape(b_sz, t, s) for y in qkv[i].split(s, dim=-1))
        ctx = _attend(q, k, v, mask_row, n_heads, mode).reshape(m, s)
        out = x[i] + dense(ctx, wo[i], bo[i]).to(x.dtype)
        outs.append(out if pre_norm
                    else layer_norm(out, ln1_w[i], ln1_b[i], eps))
    return torch.stack(outs)


def side_attention_launch(x, qkv, mask_row, wo, bo, ln1_w, ln1_b, eps,
                          n_heads, mode, pre_norm):
    if n_heads * 8 != x.shape[-1]:
        raise ValueError(f"the ladder kernels take heads of d = 8, got "
                         f"{n_heads} heads of {x.shape[-1]}")
    return ladder_stage(LADDER_ATTENTION, x, qkv=qkv, mask=mask_row, w=wo,
                        b=bo, lnw=ln1_w, lnb=ln1_b, eps=eps,
                        post=not pre_norm, mul=mode == "mul",
                        batch=mask_row.shape[0])


def side_mlp_plain(x1, w1, b1, w2, b2, ln2_w, ln2_b, eps, pre_norm):
    """The MLP half of every branch's side layer: x1 + cast(cast(gelu(
    LN2?(x1) W1^T + b1)) W2^T + b2), then LN2 for post-norm."""
    position = "prologue" if pre_norm else "epilogue"
    return torch.stack([
        mlp_block_plain(x1[i], w1[i], b1[i], w2[i], b2[i], ln2_w[i],
                        ln2_b[i], ln_position=position, ln_eps=eps)
        for i in range(x1.shape[0])])


def side_mlp_launch(x1, w1, b1, w2, b2, ln2_w, ln2_b, eps, pre_norm):
    return ladder_stage(LADDER_MLP, x1, w=w1, b=b1, w2=w2, b2=b2, lnw=ln2_w,
                        lnb=ln2_b, eps=eps, post=not pre_norm)


def _ladder_stages(stages, pack, h, mask_row, sides, *, n_heads, mode,
                   pre_norm, ln_eps):
    b_sz, t, hidden = h.shape
    m, s = b_sz * t, sides[0].shape[-1]
    side_in, qkv_fn, attention, mlp = stages
    x = side_in(h.contiguous().reshape(m, hidden),
                [side.contiguous().reshape(m, s) for side in sides],
                pack["map_w"], pack["map_b"], *pack.get("map_planes", ()))
    qkv = qkv_fn(x, pack["wqkv"], pack["bqkv"], pack["ln1_w"],
                 pack["ln1_b"], ln_eps, pre_norm)
    x1 = attention(x, qkv, mask_row, pack["wo"], pack["bo"], pack["ln1_w"],
                   pack["ln1_b"], ln_eps, n_heads, mode, pre_norm)
    out = mlp(x1, pack["w1"], pack["b1"], pack["w2"], pack["b2"],
              pack["ln2_w"], pack["ln2_b"], ln_eps, pre_norm)
    return tuple(out[i].view(b_sz, t, s) for i in range(len(sides)))


PLAIN_STAGES = (side_in_plain, side_qkv_plain, side_attention_plain,
                side_mlp_plain)
LAUNCH_STAGES = (side_in_launch, side_qkv_launch, side_attention_launch,
                 side_mlp_launch)


def ladder_stages_plain(h, mask_row, *flat, n_branches, n_heads, mode,
                        pre_norm, ln_eps) -> Tuple[torch.Tensor, ...]:
    """The four stages' plain versions chained: the function of
    `ladder_block_plain`, in the kernel's decomposition."""
    return _ladder_stages(PLAIN_STAGES, ladder_pack(flat, n_branches,
                                                    h.dtype),
                          h, mask_row, flat[:n_branches], n_heads=n_heads,
                          mode=mode, pre_norm=pre_norm, ln_eps=ln_eps)


STAGES_MAX_S = 128  # `csrc/ladder.cu:kLadMaxS`


def ladder_route(s: int, inter: int, n_heads: int, t: int) -> str:
    """K5's route on the card for a side of width s in n_heads heads, an
    MLP of width inter and T = t tokens an image: "stages" (the four stage
    launches of `csrc/ladder.cu`: heads of d = 8, s a multiple of 8 up to
    128) or "per_branch" (the side-in launch, then each branch's side layer
    on the float attention and MLP blocks' kernels: any d up to 128, which
    the attention core runs at d = 8, 16, 32, 64 or 128, zero-padding
    another d to the next of them; any T).  Both take widths that are
    multiples of 8.  Any other shape raises ValueError naming it; the
    choice never depends on a launch."""
    d = s // n_heads if n_heads > 0 and s % n_heads == 0 else 0
    shape = (f"side {s} in {n_heads} heads (d = {s / max(n_heads, 1):g}), "
             f"MLP {inter}, T = {t}")
    if s % 8 or inter % 8 or d == 0:
        raise ValueError(f"the ladder kernels take side and MLP widths that "
                         f"are multiples of 8 in whole heads, got {shape}")
    if d == 8 and s <= STAGES_MAX_S:
        return "stages"
    if core_head_dim(d) is not None and t >= 1:
        return "per_branch"
    raise ValueError(f"no ladder kernel for {shape}: the stage kernels take "
                     f"d = 8 up to a side of {STAGES_MAX_S}, the attention "
                     f"core d up to {CORE_HEAD_DIMS[-1]}")


def _branch_pack(pack: dict, dtype: torch.dtype) -> dict:
    """The float GEMM's weights of every branch's Q|K|V and out-projection
    (`float_product`'s tuples: (bf16,) or fp32 tf32 (hi, lo) planes),
    stacked per kind like the rest of the pack."""
    if dtype == torch.float32:
        return {k: tf32_planes(pack[k]) for k in ("wqkv", "wo")}
    return {k: (pack[k],) for k in ("wqkv", "wo")}


def side_layer_launch(x, mask_row, pack, i, *, n_heads, mode, pre_norm,
                      ln_eps):
    """Branch i's side layer on x <M, S> (the side-in output), the
    per-branch route: the attention half as `attention_block_launch` runs
    it (the LN row pass, Q|K|V and out-projection on the wgmma GEMM, the
    attention core), the MLP half as `mlp_block_launch` (LN statistics,
    W1 with GELU and W2 with the residual on `csrc/gemm.cu`); post-norm
    LayerNorms in place after each residual."""
    m, s = x.shape
    b_sz, t = mask_row.shape
    wg = pack["per_branch"]
    ln1 = (pack["ln1_w"][i], pack["ln1_b"][i], ln_eps)
    a = rows_prep(x, ln1) if pre_norm else x
    qkv = float_product(a, tuple(w[i] for w in wg["wqkv"]), pack["bqkv"][i],
                        EPI_WG_BIAS)
    ctx = attention_core(qkv, mask_row, b_sz, t, s, n_heads, mode)
    x1 = float_product(ctx, tuple(w[i] for w in wg["wo"]), pack["bo"][i],
                       EPI_WG_BIAS_RESID, resids=(x,))
    if not pre_norm:
        layernorm_(x1, *ln1)
    ln2_w, ln2_b = pack["ln2_w"][i], pack["ln2_b"][i]
    ln = (*rowstats(x1, ln_eps), ln2_w, ln2_b) if pre_norm else None
    inter = gemm(x1, pack["w1"][i], pack["b1"][i], EPI_BIAS_GELU, ln=ln)
    out = gemm(inter, pack["w2"][i], pack["b2"][i], EPI_BIAS_RESID, resid=x1)
    if not pre_norm:
        layernorm_(out, ln2_w, ln2_b, ln_eps)
    return out


def ladder_pack_cached(flat, n_branches: int, dtype: torch.dtype,
                       route: str = "stages") -> dict:
    """`ladder_pack` (with the per-branch products' weights for that
    route), made once per version of the branches' weights."""
    def make():
        pack = ladder_pack(flat, n_branches, dtype, planes=True)
        if route == "per_branch":
            pack["per_branch"] = _branch_pack(pack, dtype)
        return pack

    return cached(flat[n_branches:], ("ladder", n_branches, dtype, route),
                  make)


def ladder_block_launch(h, mask_row, *flat, n_branches, n_heads, mode,
                        pre_norm, ln_eps) -> Tuple[torch.Tensor, ...]:
    """The CUDA version (launches only; no counting, no autograd), on the
    route `ladder_route` picks: the four stage launches, or the side-in
    launch and each branch's side layer; the branches' weights packed once
    per version."""
    b_sz, t, hidden = h.shape
    s, inter = flat[0].shape[-1], flat[n_branches + BRANCH_KEYS.index("w1")
                                      ].shape[0]
    route = ladder_route(s, inter, n_heads, t)
    pack = ladder_pack_cached(flat, n_branches, h.dtype, route)
    if route == "stages":
        return _ladder_stages(LAUNCH_STAGES, pack, h, mask_row,
                              flat[:n_branches], n_heads=n_heads, mode=mode,
                              pre_norm=pre_norm, ln_eps=ln_eps)
    COUNTER_PER_BRANCH.add()
    m = b_sz * t
    x = side_in_launch(h.contiguous().reshape(m, hidden),
                       [side.contiguous().reshape(m, s)
                        for side in flat[:n_branches]],
                       pack["map_w"], pack["map_b"],
                       *pack.get("map_planes", ()))
    return tuple(side_layer_launch(x[i], mask_row, pack, i, n_heads=n_heads,
                                   mode=mode, pre_norm=pre_norm,
                                   ln_eps=ln_eps).view(b_sz, t, s)
                 for i in range(n_branches))


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
    version and its kernel.  The branch weights go as given: the plain
    version casts them to h's dtype, and the kernel's pack, made once per
    version of these weights, does the same."""
    if mode not in ("mul", "add"):
        raise ValueError(f"unknown mask mode {mode!r}")
    flat = [*sides]
    for w in branch_weights:
        flat.extend(w[k] for k in BRANCH_KEYS)
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
    plain version and its kernel.  The weights go as given: the ladder's
    plain version and pack cast the branch weights to h's dtype, the MLP
    ops the trunk's w1/w2, as the JAX op casts them."""
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


def ladder_attention_route(s: int, n_heads: int, n_branches: int,
                           t: int) -> str:
    """The route K10 takes on the card, by shape: "narrow" (one launch of
    `csrc/ladder_attention.cu` for every branch) for heads of d = 8 with S
    a multiple of 8 up to 128, at most LADDER_ATTENTION_MAX_BRANCHES
    branches and T up to LADDER_ATTENTION_MAX_T; "per_branch" (K9's core
    once per branch) for any other."""
    narrow = (s % 8 == 0 and 8 <= s <= 128 and n_heads * 8 == s
              and 1 <= n_branches <= LADDER_ATTENTION_MAX_BRANCHES
              and 1 <= t <= LADDER_ATTENTION_MAX_T)
    return "narrow" if narrow else "per_branch"


def ladder_attention_launch(mask_row, *qkv_flat, n_heads: int,
                            mode: str) -> Tuple[torch.Tensor, ...]:
    """The CUDA version on `ladder_attention_route`'s route: one launch for
    every branch, or one core launch per branch (no counting, no
    autograd)."""
    b, t, s = qkv_flat[0].shape
    if ladder_attention_route(s, n_heads, len(qkv_flat) // 3,
                              t) == "narrow":
        return ladder_attention_narrow(
            [x.contiguous() for x in qkv_flat], mask_row, mode)
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
