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
On the H100 one of two designs, by a shape rule (`k4_design`):
- narrow (the side widths 96/384 and 128/512): one launch
  (`csrc/int8_block.cu`).  A block of 64 rows holds both weights' codes in
  shared memory, makes x's codes (with the LN prologue), runs W1 on wgmma,
  bias, GELU and the whole row's max |.| in registers, the intermediate's
  codes into shared memory, W2 on them and the residual (and LN)
  epilogue: the intermediate never leaves the SM, as in the TPU kernel.
  What bounds it: a block's steps run one after the other, GELU the
  longest (PERF.md); its bound is the bytes of x and the output.
- trunk (768/3072, 1024/4096): three launches, K8q's tools on one tile:
  the row quantizer (LN prologue) zeroes a row-max buffer in the same
  launch; the int8 GEMM with `I8_EPI_GELU_F32_AMAX` writes the fp32
  intermediate and raises its rows' max |.|; the W2 product quantizes the
  intermediate as it loads it (`gemm_i8_qa`), with the residual epilogue
  (BERT's post-norm adds the LN pass).  The intermediate's codes never
  reach memory; the fp32 intermediate does (155 MB at ViT B=64, written
  once, read once per 192 columns, from L2 after the first): that, and the
  W1 product's epilogue, are what bound it.
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
before and after the chain.  On the H100 the tiles of a chain share what
is the same for all of them (`_Int8Chain`): x's codes, made once by the
first tile's row quantizer, whose launch also zeroes one fp32 <M> row-max
buffer per tile, and every tile's weight codes and fp32 vectors, made once
per weight version and fetched in one lookup per chain
(`weight_codes.split_codes`).  A tile is then two int8 GEMMs
(`csrc/int8.cu`, TMA + wgmma): W1 with an epilogue that writes the fp32
GELU intermediate and raises its rows' max |.| by atomics, and W2, which
loads that fp32 intermediate by TMA and quantizes it in its consumers'
registers from those row maxima (the codes `quant_rows` would make), with
the residual epilogue.  So no pass reads the intermediate to reduce or
quantize it, and its codes never reach device memory.  Each tile is one
counted launch, as each is one `pallas_call` in JAX.  What bounds it: the
bytes of the fp32 <M, tile> intermediate, written once and read once
(25.2 MB at BERT-base B=8), and the W2 product's quantize-on-load, which
reads it once per 192-wide column tile (from L2 after the first).

The float split (K8, `_pallas_mlp_sepx`, body `_kernel_sepx`) is another
function only in bf16: each JAX tile rounds its own W2_k GELU(W1_k x +
b1_k) + b2_k to bf16 before adding it to the running residual.  So in bf16
the port runs the chain tile by tile on the TMA + wgmma GEMM
(`csrc/gemm_wgmma.cu`, bf16 wgmma, fp32 sums): the tile's W1 rows with
the bias + GELU epilogue (rounded to bf16 where `_kernel_sepx` casts),
then the tile's W2 column slice <H, tile>, read in place by TMA through
its row stride, with the bias + residual epilogue; b2 joins on the last
tile, the fp32 vectors are made once per weight version, each tile is one
counted launch.  The bf16 intermediate goes through device memory: a
block's share of it does not fit in shared memory beside its operands at
wgmma's 64-row minimum.  What bounds it: the tensor cores (38.7 GFLOP per
chain at BERT-base B=8).  In fp32 the split only reorders an fp32 sum, so
fp32 keeps the one-pass block above.

`mlp_block` takes the plain version for CPU tensors and the kernel for
CUDA tensors; there is no other switch.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.build import LaunchCounter
from ..kernels.primitives import (EPI_BIAS_GELU, EPI_BIAS_RESID,
                                  EPI_WG_BIAS_GELU, EPI_WG_BIAS_RESID,
                                  I8_EPI_GELU_F32_AMAX, dispatch, gemm,
                                  gemm_i8, gemm_i8_qa, layernorm_,
                                  mlp_narrow, quant_rows, rows_prep,
                                  rowstats)
from ..models.common import dense, gelu, layer_norm
from . import gates
from .attention_block import LN_POSITIONS, float_product
from .weight_codes import (float_weight, identity_ln, split_codes, vec32,
                           weight_codes, zero_bias)

COUNTER = LaunchCounter("mlp_block")
COUNTER_INT8 = LaunchCounter("mlp_block_int8")
COUNTER_TILED = LaunchCounter("mlp_block_tiled")
COUNTER_INT8_TILED = LaunchCounter("mlp_block_int8_tiled")
# the split chains' LayerNorm row pass (the JAX chain's XLA LayerNorm, not a
# TPU kernel)
COUNTER_CHAIN_LN = LaunchCounter("chain_layer_norm")


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


# (H, I) of the narrow K4 kernel (`int8_block.cu:ag_mlp_narrow_supports`):
# the LTT side widths of ViT-B / BERT-base and of ViT-L, where a 64-row
# block holds both weights' codes and a whole row of the intermediate
K4_NARROW_WIDTHS = ((96, 384), (128, 512))


def k4_design(h: int, inter: int) -> str:
    """K4's design on the card at MLP widths h / inter: "narrow" (one
    launch) where the narrow kernel is built for them, else "trunk" (three
    launches, and BERT's post-norm LN)."""
    return "narrow" if (h, inter) in K4_NARROW_WIDTHS else "trunk"


def mlp_block_int8_launch(resid, w1, b1, w2, b2, ln_w, ln_b, *,
                          ln_position: str, ln_eps: float) -> torch.Tensor:
    """The CUDA version of K4 (launches only; no counting, no autograd), in
    the design `k4_design` picks."""
    b_sz, t, h = resid.shape
    x = resid.contiguous().reshape(b_sz * t, h)
    (q1, s1), (q2, s2) = (weight_codes((w,), x.dtype) for w in (w1, w2))
    ln = (vec32(ln_w), vec32(ln_b), ln_eps)
    if k4_design(h, w1.shape[0]) == "narrow":
        out = mlp_narrow(x, q1, s1, vec32(b1), q2, s2, vec32(b2), ln=ln,
                         ln_position=ln_position)
        return out.reshape(b_sz, t, h)
    amax = torch.empty(b_sz * t, device=x.device, dtype=torch.float32)
    xq, xs = quant_rows(x, ln=ln if ln_position == "prologue" else None,
                        zero=amax)
    inter = gemm_i8(xq, xs, q1, s1, vec32(b1), I8_EPI_GELU_F32_AMAX,
                    x.dtype, amax=amax)
    out = gemm_i8_qa(inter, amax, q2, s2, vec32(b2), x.dtype, resid=x)
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
        ln_w, ln_b = identity_ln(h, resid.device)
        ln_eps, ln_position = 1e-12, "none"
    else:
        ln_w, ln_b, ln_eps = ln
    static = dict(ln_position=ln_position, ln_eps=float(ln_eps))
    return (resid, w1, b1, w2, b2, ln_w, ln_b), static


# ------------------------------------ intermediate-dim split (K8, K8q)
# One tile: x <B, T, H> (the possibly LN'd input, the same for every tile),
# resid the running residual, torch-layout slices w1 <tile, H> (rows) and
# w2 <H, tile> (columns), cast to x's dtype; b2 is zero but on the last tile.

# The bf16 K8 tile's GEMM tile width, for both products (at BERT-base B=8,
# M = 4096: W1 N = 1536 in 256 tiles of 128 x 192, W2 N = 768 in 128)
K8_TILE_WIDTH = 192


def mlp_tile_plain(x, resid, w1, b1, w2, b2) -> torch.Tensor:
    """One float tile (`_xla_mlp_sepx`): resid + cast(W2 gelu(W1 x + b1)
    + b2), the intermediate cast to x's dtype.  The plain version of a K8
    tile, and the gradient of a K8q tile, as in the JAX package."""
    inter = gelu(F.linear(x.float(), w1.float(), b1.float())).to(x.dtype)
    return resid + dense(inter, w2, b2).to(resid.dtype)


def mlp_tile_launch(x, resid, w1, b1, w2, b2) -> torch.Tensor:
    """The CUDA version of one float tile (launches only; no counting, no
    autograd): both products on the TMA + wgmma GEMM, the W1 rows with the
    bias + GELU epilogue, then the W2 column slice, read in place by TMA
    through its row stride, with the bias + residual epilogue; the fp32
    vectors once per weight version."""
    b_sz, t, h = resid.shape
    bn = K8_TILE_WIDTH if x.dtype == torch.bfloat16 else 0
    inter = float_product(x.reshape(b_sz * t, h),
                          float_weight((w1,), x.dtype), vec32(b1),
                          EPI_WG_BIAS_GELU, bn=bn)
    out = float_product(inter, float_weight((w2,), x.dtype), vec32(b2),
                        EPI_WG_BIAS_RESID, resids=(resid.reshape(b_sz * t, h),),
                        bn=bn)
    return out.reshape(b_sz, t, h)


def mlp_tile_int8_plain(x, resid, w1, b1, w2, b2) -> torch.Tensor:
    """Reference math of one K8q tile (`_kernel_sepx_q`): x quantized per
    token, the tile's W1 rows and W2 columns per output channel of the
    slice, the fp32 GELU intermediate re-quantized per token over the
    slice, resid + cast(acc2 * is * s2 + b2)."""
    inter = gelu(int8_linear(*_quant_rows(x.float()), *quant_cols(w1), b1))
    out = int8_linear(*_quant_rows(inter), *quant_cols(w2), b2)
    return resid + out.to(resid.dtype)


class _Int8Chain:
    """What the tiles of one K8q chain share on the card: every tile's
    weight codes and fp32 vectors (`weight_codes.split_codes`, one lookup
    per chain), x's codes and one fp32 <M> row-max buffer per tile.  The
    first tile's launch makes x's codes, and the same launch zeroes the
    buffers.  The tiles launch in order, one chain per pass."""

    def __init__(self, w1, b1, w2, b2, n_tiles: int):
        self.weights, self.n_tiles = (w1, b1, w2, b2), n_tiles
        self.pack = self.codes = self.amax = None
        self.k = 0

    def next_tile(self, x: torch.Tensor):
        """-> (x's codes, x's scales, the next tile's W1 codes, scales, b1,
        W2 codes, scales, b2, its row-max buffer)."""
        k = self.k
        if k >= self.n_tiles:
            raise RuntimeError(f"a chain of {self.n_tiles} tiles has no "
                               f"tile {k}")
        self.k += 1
        if self.codes is None:
            b_sz, t, h = x.shape
            self.pack = split_codes(*self.weights, self.n_tiles, x.dtype)
            self.amax = torch.empty((self.n_tiles, b_sz * t), device=x.device,
                                    dtype=torch.float32)
            self.codes = quant_rows(x.reshape(b_sz * t, h), zero=self.amax)
        q1, s1, b1, q2, s2, b2 = self.pack
        rows = slice(k * q1.shape[0] // self.n_tiles,
                     (k + 1) * q1.shape[0] // self.n_tiles)
        return (*self.codes, q1[rows], s1[rows], b1[rows], q2[k], s2[k],
                b2[k], self.amax[k])


def mlp_tile_int8_launch(x, resid, w1, b1, w2, b2, *,
                         chain: Optional[_Int8Chain] = None) -> torch.Tensor:
    """The CUDA version of the next tile of a K8q chain (launches only; no
    counting, no autograd).  The kernels read the codes of the tile's
    weight slices (w1 ... b2 are the plain version's and the gradient's)
    from the chain: the W1 product's epilogue writes the fp32 GELU
    intermediate and its per-row max |.|, and the W2 product quantizes the
    intermediate as it loads it, with the residual epilogue.  Without a
    chain (an exported program's tile op, which shares nothing with the
    other tiles' calls) the tile makes x's codes itself, one more row
    quantizer launch, and takes its slices' codes by `weight_codes`, once
    per weight version: the codes and scales the chain's one lookup
    holds for them (per output channel of each slice)."""
    b_sz, t, h = resid.shape
    if chain is None:
        amax = torch.empty(b_sz * t, device=x.device, dtype=torch.float32)
        xq, xs = quant_rows(x.reshape(b_sz * t, h), zero=amax)
        (q1, s1), (q2, s2) = (weight_codes((w,), x.dtype) for w in (w1, w2))
        b1_k, b2_k = vec32(b1), vec32(b2)
    else:
        xq, xs, q1, s1, b1_k, q2, s2, b2_k, amax = chain.next_tile(x)
    inter = gemm_i8(xq, xs, q1, s1, b1_k, I8_EPI_GELU_F32_AMAX, x.dtype,
                    amax=amax)
    out = gemm_i8_qa(inter, amax, q2, s2, b2_k, x.dtype,
                     resid=resid.reshape(b_sz * t, h))
    return out.reshape(b_sz, t, h)


def _chain_ln_launch(x, w, b, *, eps: float) -> torch.Tensor:
    """cast(LN(x)) of a <B, T, H> by the row pass (`rows_prep`), one read
    and one write."""
    b_sz, t, h = x.shape
    return rows_prep(x.reshape(b_sz * t, h),
                     (vec32(w), vec32(b), eps)).reshape(b_sz, t, h)


def _chain_ln_plain(x, w, b, *, eps: float) -> torch.Tensor:
    return layer_norm(x, w, b, eps)


def _chain_ln(x, w, b, eps: float) -> torch.Tensor:
    """The LayerNorm before or after a split chain: `layer_norm` for CPU
    tensors, the row pass on the card."""
    return dispatch(_chain_ln_launch, _chain_ln_plain, COUNTER_CHAIN_LN,
                    (x, w, b), dict(eps=eps))


def _tiled(tile, resid, w1, b1, w2, b2, ln_w, ln_b, *, ln_position: str,
           ln_eps: float, n_tiles: int, ln=layer_norm) -> torch.Tensor:
    """`_tiled_mlp`: LN? -> the chain of `tile` over the intermediate
    slices, the residual accumulating -> LN? (`ln(x, w, b, eps)`)."""
    x = (ln(resid, ln_w, ln_b, ln_eps) if ln_position == "prologue"
         else resid)
    w1, w2 = w1.to(resid.dtype), w2.to(resid.dtype)
    width = w1.shape[0] // n_tiles
    zero = zero_bias(b2)
    out = resid
    for k in range(n_tiles):
        sl = slice(k * width, (k + 1) * width)
        out = tile(x, out, w1[sl], b1[sl], w2[:, sl],
                   b2 if k == n_tiles - 1 else zero)
    if ln_position == "epilogue":
        out = ln(out, ln_w, ln_b, ln_eps)
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
    return _tiled(tile, *tensors, n_tiles=n_tiles, ln=_chain_ln, **static)


def mlp_block_int8_tiled_plain(*tensors, n_tiles: int,
                               **static) -> torch.Tensor:
    """The plain K8q chain (`mlp_block_args` tensors and keywords)."""
    return _tiled(mlp_tile_int8_plain, *tensors, n_tiles=n_tiles, **static)


def mlp_block_int8_tiled(*args, n_tiles: int, **kwargs) -> torch.Tensor:
    """The K8q chain of `n_tiles` tiles, one op call per tile (gradient:
    the float tile's).  Arguments as `mlp_block_args`."""
    tensors, static = mlp_block_args(*args, **kwargs)
    chain = _Int8Chain(*tensors[1:5], n_tiles)

    def tile(*ts):
        launch = functools.partial(mlp_tile_int8_launch, chain=chain)
        return dispatch(launch, mlp_tile_int8_plain, COUNTER_INT8_TILED, ts,
                        {}, grad=mlp_tile_plain)
    return _tiled(tile, *tensors, n_tiles=n_tiles, ln=_chain_ln, **static)


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
