"""Typed Python launchers for the CUDA building blocks of `csrc/`, and the
autograd convention shared by every kernel op.

Each launcher checks device, dtype, shape and strides before it hands raw
pointers to the library, allocates its outputs with `torch.empty`, launches
on PyTorch's current stream, and raises if the C function returns a CUDA
error.  Nothing here synchronises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch

from .build import LaunchCounter, load

_P = ctypes.c_void_p

EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_RESID = 0, 1, 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _dtype_code(t: torch.Tensor) -> int:
    return _code(t.dtype)


def _code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPES:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return _DTYPES[dtype]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _rows(t: torch.Tensor, name: str) -> int:
    """Row stride of a 2-D CUDA tensor whose rows are contiguous."""
    if not t.is_cuda or t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"{name} must be a 2-D CUDA tensor with contiguous "
                         f"rows, got {tuple(t.shape)} strides {t.stride()}")
    return t.stride(0)


def _aligned16(t: torch.Tensor, name: str, strides: Sequence[int]) -> None:
    """The tensor-core kernels copy 16-byte pieces (cp.async): the pointer
    and each stride named must be whole multiples of 16 bytes."""
    size = t.element_size()
    if t.data_ptr() % 16 or any(s * size % 16 for s in strides):
        raise ValueError(f"{name} must be 16-byte aligned with strides of "
                         f"whole 16 bytes, got {t.dtype} strides {t.stride()} "
                         f"at offset {t.data_ptr() % 16}")


def _vec32(t: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """A length-n fp32 contiguous copy (vectors are read in fp32, as the
    JAX math upcasts biases and LN weights)."""
    if t.shape != (n,):
        raise ValueError(f"{name} must have shape ({n},), got {tuple(t.shape)}")
    return t.to(torch.float32).contiguous()


def rowstats(x: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """<M, N> -> (mean, 1/sqrt(var + eps)), fp32 <M> each."""
    if not x.is_contiguous():
        raise ValueError("rowstats needs a contiguous <M, N> tensor")
    m, n = x.shape
    mean = torch.empty(m, device=x.device, dtype=torch.float32)
    rstd = torch.empty(m, device=x.device, dtype=torch.float32)
    _check(load().ag_rowstats(_dtype_code(x), x.data_ptr(), m, n, eps,
                              mean.data_ptr(), rstd.data_ptr(), _stream()),
           "ag_rowstats")
    return mean, rstd


def layernorm_(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the rows of a contiguous <M, N>, in place."""
    if not x.is_contiguous():
        raise ValueError("layernorm_ needs a contiguous <M, N> tensor")
    m, n = x.shape
    w32, b32 = _vec32(w, n, "ln weight"), _vec32(b, n, "ln bias")
    _check(load().ag_layernorm(_dtype_code(x), x.data_ptr(), m, n, eps,
                               w32.data_ptr(), b32.data_ptr(), x.data_ptr(),
                               _stream()), "ag_layernorm")
    return x


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epi: int, *,
         ln: Optional[Tuple[torch.Tensor, ...]] = None,
         resid: Optional[torch.Tensor] = None,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out <M, N> = epilogue(A' @ w.T + bias); w in torch (out, in) layout.

    ln = (mean, rstd, ln_w, ln_b): A' = LN(a) computed while loading a.
    resid <M, N>: added after the cast (EPI_BIAS_RESID).
    `a`, `w`, `resid` and `out` may be column slices (rows contiguous);
    `a` and `w` are read in 16-byte pieces, so their pointers and row
    strides, and K, must be whole multiples of 16 bytes."""
    lda = _rows(a, "a")
    m, k = a.shape
    n = w.shape[0]
    if w.shape != (n, k) or w.dtype != a.dtype:
        raise ValueError(f"w must be a {a.dtype} ({n}, {k}) matrix, got "
                         f"{w.dtype} {tuple(w.shape)}")
    ldw = _rows(w, "w")
    if k * a.element_size() % 16:
        raise ValueError(f"the GEMM reads 16-byte pieces of k: K={k} "
                         f"{a.dtype} is not a whole number of them")
    _aligned16(a, "a", (lda,))
    _aligned16(w, "w", (ldw,))
    b32 = _vec32(bias, n, "bias")
    if out is None:
        out = torch.empty((m, n), device=a.device, dtype=a.dtype)
    ldc = _rows(out, "out")
    if out.shape != (m, n) or out.dtype != a.dtype:
        raise ValueError(f"out must be {a.dtype} ({m}, {n})")
    ln_ptrs = [None] * 4
    if ln is not None:
        mean, rstd, ln_w, ln_b = ln
        ln_w32, ln_b32 = _vec32(ln_w, k, "ln weight"), _vec32(ln_b, k, "ln bias")
        keep = (mean, rstd, ln_w32, ln_b32)  # alive across the launch
        ln_ptrs = [t.data_ptr() for t in keep]
    wants_resid = epi == EPI_BIAS_RESID
    if wants_resid != (resid is not None):
        raise ValueError("resid is required exactly by EPI_BIAS_RESID")
    ldr, r_ptr = 0, None
    if resid is not None:
        ldr = _rows(resid, "resid")
        if resid.shape != (m, n) or resid.dtype != a.dtype:
            raise ValueError(f"resid must be {a.dtype} ({m}, {n})")
        r_ptr = resid.data_ptr()
    _check(load().ag_gemm(_dtype_code(a), epi, a.data_ptr(), lda, *ln_ptrs,
                          w.data_ptr(), ldw, b32.data_ptr(), r_ptr, ldr,
                          out.data_ptr(), ldc, m, n, k, _stream()), "ag_gemm")
    return out


I8_EPI_BIAS, I8_EPI_BIAS_RESID, I8_EPI_GELU_F32 = 0, 1, 2
I8_EPI_GELU_F32_AMAX, I8_EPI_GELU_FOLD = 4, 5
# the most float rows (classes) I8_EPI_GELU_FOLD folds in (`int8.cu:kI8MaxFold`)
I8_MAX_FOLD = 16


def quant_rows(x: torch.Tensor, *, weight: bool = False,
               ln: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None,
               zero: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """<M, N> fp32/bf16 -> (int8 codes <M, N> contiguous, fp32 scales <M>).

    weight=False: the per-token activation recipe (`_quant_rows`), of
    LN(x) rounded to x's dtype when ln = (w, b, eps) is given;
    weight=True: the per-output-channel recipe (`quant_cols`) of a torch
    (out, in) weight, whose rows are the output channels.
    zero: a contiguous fp32 CUDA tensor the same launch fills with zeros
    (a K8q chain's per-row amax buffers)."""
    ldx = _rows(x, "x")
    m, n = x.shape
    if weight and ln is not None:
        raise ValueError("the weight recipe has no LN prologue")
    q = torch.empty((m, n), device=x.device, dtype=torch.int8)
    scale = torch.empty(m, device=x.device, dtype=torch.float32)
    ptrs, eps = [None, None], 0.0
    if ln is not None:
        keep = (_vec32(ln[0], n, "ln weight"), _vec32(ln[1], n, "ln bias"))
        ptrs, eps = [t.data_ptr() for t in keep], float(ln[2])
    z_ptr, nzero = None, 0
    if zero is not None:
        if zero.dtype != torch.float32 or not zero.is_contiguous() \
                or zero.device != x.device:
            raise ValueError("zero must be a contiguous fp32 tensor on x's "
                             "device")
        z_ptr, nzero = zero.data_ptr(), zero.numel()
    _check(load().ag_quant_rows(_dtype_code(x), x.data_ptr(), ldx, m, n, eps,
                                *ptrs, int(weight), q.data_ptr(),
                                scale.data_ptr(), z_ptr, nzero, _stream()),
           "ag_quant_rows")
    return q, scale


def _amax_rows(amax: torch.Tensor, m: int) -> int:
    if amax.shape != (m,) or amax.dtype != torch.float32 \
            or not amax.is_contiguous() or not amax.is_cuda:
        raise ValueError(f"amax must be a contiguous fp32 CUDA ({m},) "
                         f"vector, got {amax.dtype} {tuple(amax.shape)}")
    return amax.data_ptr()


def _i8_weight(w: torch.Tensor, k: int) -> int:
    n = w.shape[0]
    if w.dtype != torch.int8 or w.shape != (n, k) or not w.is_contiguous() \
            or w.data_ptr() % 16:
        raise ValueError(f"w must be a contiguous, 16-byte aligned int8 "
                         f"({n}, {k}) matrix, got {w.dtype} "
                         f"{tuple(w.shape)}")
    return n


def _i8_resid(resid: Optional[torch.Tensor], m: int, n: int,
              dtype: torch.dtype) -> Tuple[int, Optional[int]]:
    if resid is None:
        return 0, None
    ldr = _rows(resid, "resid")
    if resid.shape != (m, n) or resid.dtype != dtype:
        raise ValueError(f"resid must be {dtype} ({m}, {n})")
    return ldr, resid.data_ptr()


def gemm_i8(a: torch.Tensor, a_scale: torch.Tensor, w: torch.Tensor,
            w_scale: torch.Tensor, bias: torch.Tensor, epi: int,
            dtype: torch.dtype, *, resid: Optional[torch.Tensor] = None,
            amax: Optional[torch.Tensor] = None,
            fold: Sequence[torch.Tensor] = (), classes: int = 0
            ) -> torch.Tensor:
    """out <M, N> = epilogue((a @ w.T) * a_scale[:, None] * w_scale + bias)
    with int8 a <M, K>, int8 w <N, K> (torch layout) and an exact int32
    accumulator.  `dtype` is the activation dtype; the output is fp32 for
    I8_EPI_GELU_F32(_AMAX) and `dtype` otherwise; resid (`dtype` <M, N>,
    rows contiguous) is added after the cast by I8_EPI_BIAS_RESID.
    I8_EPI_GELU_F32_AMAX also raises amax (fp32 <M>, zeroed before) to each
    row's max |out|.  I8_EPI_GELU_FOLD writes no <M, N>: it folds
    cast(gelu(...)) into `classes` (at most I8_MAX_FOLD) float rows, given
    as `fold`: their planes <I8_MAX_FOLD, N> (rows past `classes` zero;
    `fold_planes` makes them), -> the fp32 partial sums <column
    tiles, M, classes> of cast(gelu(...)) @ rows.T, one per column tile of
    the GEMM (`fold_sum` adds them)."""
    lda = _rows(a, "a")
    m, k = a.shape
    if a.dtype != torch.int8:
        raise TypeError("gemm_i8 takes int8 operands")
    n = _i8_weight(w, k)
    if k % 16 or lda % 16 or a.data_ptr() % 16:
        raise ValueError(f"the int8 GEMM reads a and w by TMA: the pointers, "
                         f"K and the row stride must be multiples of 16, "
                         f"got K={k}, stride {lda}")
    sa = _vec32(a_scale, m, "a_scale")
    sw, b32 = _vec32(w_scale, n, "w_scale"), _vec32(bias, n, "bias")
    if (epi == I8_EPI_BIAS_RESID) != (resid is not None):
        raise ValueError("resid is required exactly by I8_EPI_BIAS_RESID")
    if (epi == I8_EPI_GELU_F32_AMAX) != (amax is not None):
        raise ValueError("amax is required exactly by I8_EPI_GELU_F32_AMAX")
    if (epi == I8_EPI_GELU_FOLD) != bool(fold):
        raise ValueError("fold is required exactly by I8_EPI_GELU_FOLD")
    fold_ptrs, part_ptr = [None, None], None
    if fold:
        rows = I8_MAX_FOLD
        planes = 1 if dtype == torch.bfloat16 else 2
        if not 0 < classes <= I8_MAX_FOLD or n % 8 or len(fold) != planes \
                or any(f.shape != (rows, n) or f.dtype != dtype
                       or not f.is_contiguous() for f in fold):
            raise ValueError(f"the fold epilogue takes 1 to {I8_MAX_FOLD} "
                             f"rows of N (a multiple of 8) = {n}, as "
                             f"{planes} {dtype} plane(s) <{rows}, {n}> "
                             f"(`fold_planes`), got {classes} rows")
        fold_ptrs[:planes] = [f.data_ptr() for f in fold]
        out = torch.empty((load().ag_gemm_i8_tiles_n(n), m, classes),
                          device=a.device, dtype=torch.float32)
        part_ptr, c_ptr, ldc = out.data_ptr(), None, 0
    else:
        f32_out = epi in (I8_EPI_GELU_F32, I8_EPI_GELU_F32_AMAX)
        out = torch.empty((m, n), device=a.device,
                          dtype=torch.float32 if f32_out else dtype)
        c_ptr, ldc = out.data_ptr(), n
    ldr, r_ptr = _i8_resid(resid, m, n, dtype)
    amax_ptr = None if amax is None else _amax_rows(amax, m)
    _check(load().ag_gemm_i8(_code(dtype), epi, a.data_ptr(), lda,
                             sa.data_ptr(), w.data_ptr(), sw.data_ptr(),
                             b32.data_ptr(), r_ptr, ldr, c_ptr, ldc,
                             amax_ptr, *fold_ptrs, classes, part_ptr, m, n,
                             k, _stream()), "ag_gemm_i8")
    return out


def fold_planes(rows: torch.Tensor, dtype: torch.dtype
                ) -> Tuple[torch.Tensor, ...]:
    """The planes I8_EPI_GELU_FOLD reads of float rows <C, N> (C at most
    I8_MAX_FOLD): the rows cast to `dtype`, padded with zero rows to
    I8_MAX_FOLD; bf16 -> (the bf16 rows,), fp32 -> their tf32 (hi, lo)
    planes (3xTF32)."""
    c, n = rows.shape
    if c > I8_MAX_FOLD:
        raise ValueError(f"the fold takes at most {I8_MAX_FOLD} rows, got "
                         f"{c}")
    padded = torch.zeros((I8_MAX_FOLD, n), device=rows.device, dtype=dtype)
    padded[:c] = rows.to(dtype)
    if dtype == torch.bfloat16:
        return (padded,)
    from ..ops.weight_codes import tf32_planes

    return tf32_planes(padded)


def fold_sum(part: torch.Tensor, b3: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """<M, C> in `dtype` = cast(the sum of the partials <tiles, M, C> of
    I8_EPI_GELU_FOLD, tile by tile in order, + b3 (fp32 <C>))."""
    if part.dim() != 3 or part.dtype != torch.float32 \
            or not part.is_contiguous() or not part.is_cuda:
        raise ValueError("part must be a contiguous fp32 CUDA <tiles, M, C>")
    tiles, m, c = part.shape
    b32 = _fp32_vector(b3, c, "b3")
    out = torch.empty((m, c), device=part.device, dtype=dtype)
    _check(load().ag_fold_sum(_code(dtype), part.data_ptr(), tiles, m, c,
                              b32.data_ptr(), out.data_ptr(), _stream()),
           "ag_fold_sum")
    return out


def gemm_i8_qa(a: torch.Tensor, amax: torch.Tensor, w: torch.Tensor,
               w_scale: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
               *, resid: torch.Tensor) -> torch.Tensor:
    """`gemm_i8` with the residual epilogue, A quantized on load: a is the
    fp32 <M, K> the codes are made of and amax <M> its per-row max |a| (as
    `I8_EPI_GELU_F32_AMAX` leaves it); each consumer thread makes its own
    fragments' codes, the codes and scales `quant_rows` would give.
    out <M, N> = resid + cast(acc * a_scale * w_scale + bias).  w_scale
    and bias: contiguous fp32 <N>, handed over as they are."""
    lda = _rows(a, "a")
    m, k = a.shape
    if a.dtype != torch.float32:
        raise TypeError(f"gemm_i8_qa takes an fp32 a, got {a.dtype}")
    n = _i8_weight(w, k)
    if k % 16:
        raise ValueError(f"the int8 GEMM takes K a multiple of 16, got {k}")
    _aligned16(a, "a", (lda,))
    sw = _fp32_vector(w_scale, n, "w_scale")
    b32 = _fp32_vector(bias, n, "bias")
    ldr, r_ptr = _i8_resid(resid, m, n, dtype)
    out = torch.empty((m, n), device=a.device, dtype=dtype)
    _check(load().ag_gemm_i8_qa(_code(dtype), a.data_ptr(), lda,
                                _amax_rows(amax, m), w.data_ptr(),
                                sw.data_ptr(), b32.data_ptr(), r_ptr, ldr,
                                out.data_ptr(), n, m, n, k, _stream()),
           "ag_gemm_i8_qa")
    return out


def _codes_operand(q: torch.Tensor, s: torch.Tensor, rows: int, cols: int,
                   name: str) -> None:
    """int8 codes <rows, cols> (contiguous, 16-byte aligned, read by TMA)
    with their fp32 scales <rows>."""
    if q.dtype != torch.int8 or q.shape != (rows, cols) \
            or not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous, 16-byte aligned int8 "
                         f"({rows}, {cols}) codes, got {q.dtype} "
                         f"{tuple(q.shape)}")
    _fp32_vector(s, rows, f"{name}'s scales")


def mlp_narrow(x: torch.Tensor, q1: torch.Tensor, s1: torch.Tensor,
               b1: torch.Tensor, q2: torch.Tensor, s2: torch.Tensor,
               b2: torch.Tensor, *,
               ln: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None,
               ln_position: str = "none",
               codes: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """The narrow W8A8 MLP block in one launch (`csrc/int8_block.cu`): x
    <M, H> (rows contiguous) -> <M, H> = [LN](x + cast(W2 codes(gelu(W1
    codes([LN] x))))) with the weights' codes q1 <I, H>, q2 <H, I> and fp32
    scales and biases; ln = (fp32 w, fp32 b, eps) at ln_position
    "prologue" or "epilogue".  H / I: the widths `ag_mlp_narrow_supports`
    takes.  codes = (int8 <M, I>, fp32 <M>): where given, the launch also
    writes the intermediate's codes and scales there."""
    ldx = _rows(x, "x")
    m, h = x.shape
    inter = q1.shape[0]
    if not load().ag_mlp_narrow_supports(h, inter):
        raise ValueError(f"the narrow MLP block has no kernel for "
                         f"{h}/{inter}")
    _codes_operand(q1, s1, inter, h, "W1")
    _codes_operand(q2, s2, h, inter, "W2")
    b1, b2 = _fp32_vector(b1, inter, "b1"), _fp32_vector(b2, h, "b2")
    pos = {"none": 0, "prologue": 1, "epilogue": 2}[ln_position]
    ln_ptrs, eps = [None, None], 0.0
    if pos:
        ln_ptrs = [_fp32_vector(ln[0], h, "ln weight").data_ptr(),
                   _fp32_vector(ln[1], h, "ln bias").data_ptr()]
        eps = float(ln[2])
    hq = hs = None
    if codes is not None:
        hq, hs = codes
        if hq.shape != (m, inter) or hq.dtype != torch.int8 \
                or not hq.is_contiguous():
            raise ValueError(f"codes must be a contiguous int8 ({m}, "
                             f"{inter})")
        hs = _fp32_vector(hs, m, "the codes' scales")
        hq, hs = hq.data_ptr(), hs.data_ptr()
    out = torch.empty((m, h), device=x.device, dtype=x.dtype)
    _check(load().ag_mlp_narrow(_dtype_code(x), pos, x.data_ptr(), ldx,
                                *ln_ptrs, eps, q1.data_ptr(), s1.data_ptr(),
                                b1.data_ptr(), q2.data_ptr(), s2.data_ptr(),
                                b2.data_ptr(), out.data_ptr(), hq, hs, m, h,
                                inter, _stream()), "ag_mlp_narrow")
    return out


def head_d1(x: torch.Tensor, q1: torch.Tensor, s1: torch.Tensor,
            b1: torch.Tensor, *,
            ln: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The explainer head's d1 straight to codes (`csrc/int8_block.cu`): x
    <M, K> (rows contiguous, K a multiple of 16 up to 128), [LN (fp32 w, b,
    eps)], W1's codes <N, K> (N a multiple of 16 up to 4096) with fp32
    scales and b1 <N> -> (h's int8 codes <M, N>, fp32 scales <M>), h =
    gelu(the int8 d1 product): the codes `quant_rows` makes of h."""
    ldx = _rows(x, "x")
    m, k = x.shape
    n = q1.shape[0]
    _codes_operand(q1, s1, n, k, "W1")
    b1 = _fp32_vector(b1, n, "b1")
    if k % 16 or k > 128 or n % 16 or n > 4096:
        raise ValueError(f"d1 takes K a multiple of 16 up to 128 and N a "
                         f"multiple of 16 up to 4096, got K={k}, N={n}")
    ln_ptrs, eps = [None, None], 0.0
    if ln is not None:
        ln_ptrs = [_fp32_vector(ln[0], k, "ln weight").data_ptr(),
                   _fp32_vector(ln[1], k, "ln bias").data_ptr()]
        eps = float(ln[2])
    hq = torch.empty((m, n), device=x.device, dtype=torch.int8)
    hs = torch.empty(m, device=x.device, dtype=torch.float32)
    _check(load().ag_head_d1(_dtype_code(x), x.data_ptr(), ldx, *ln_ptrs, eps,
                             q1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
                             hq.data_ptr(), hs.data_ptr(), m, k, n,
                             _stream()), "ag_head_d1")
    return hq, hs


# ------------------------------------------- float GEMM on TMA + wgmma

EPI_WG_BIAS, EPI_WG_BIAS_RESID, EPI_WG_GELU_RESID_SPLIT = 0, 1, 2
EPI_WG_BIAS_GELU = 3
WG_TILE_WIDTHS = {torch.bfloat16: (96, 128, 192, 256), torch.float32: (96,)}
WG_MAX_BRANCHES = 4


def _tma_operand(t: torch.Tensor, name: str) -> int:
    """Row stride of a 2-D CUDA operand read by TMA: rows contiguous, the
    pointer and the row stride whole multiples of 16 bytes."""
    ld = _rows(t, name)
    _aligned16(t, name, (ld,))
    return ld


def _fp32_vector(t: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """A length-n fp32 contiguous vector, taken as it is: the ops that call
    the new kernels hand over vectors made once per weight version
    (`ops/weight_codes.py:vec32`), so nothing is copied at a launch."""
    if t.shape != (n,) or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous fp32 ({n},) vector, "
                         f"got {t.dtype} {tuple(t.shape)}")
    return t


def gemm_wg(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epi: int,
            *, w_lo: Optional[torch.Tensor] = None,
            resids: Sequence[torch.Tensor] = (),
            out: Optional[torch.Tensor] = None, split: int = 0, bn: int = 0
            ) -> torch.Tensor:
    """The float GEMM on TMA + wgmma (`csrc/gemm_wgmma.cu`): epilogue(A @
    W.T + bias) with W in torch (out, in) layout.

    bf16: a and w bf16.  fp32 (3xTF32): a fp32, split in the kernel's
    registers; w and w_lo the weight's tf32 hi and lo planes
    (`ops/weight_codes.py:tf32_planes`).  bias: fp32 <N>.
    EPI_WG_BIAS: out <M, N>.  EPI_WG_BIAS_GELU: out = cast(gelu(...)).
    EPI_WG_BIAS_RESID: out = resids[0] + cast(...), resids[0] <M, N>.
    EPI_WG_GELU_RESID_SPLIT: column n belongs to branch n // split; out
    <N // split, M, split> gets resids[branch] + cast(gelu(...)), each
    resid <M, split>.  bn: the tile width (`WG_TILE_WIDTHS`), 0 for the
    kernel's own shape rule."""
    lda = _tma_operand(a, "a")
    m, k = a.shape
    n = w.shape[0]
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gemm_wg takes fp32 or bf16, got {a.dtype}")
    if w.shape != (n, k) or w.dtype != a.dtype:
        raise ValueError(f"w must be a {a.dtype} ({n}, {k}) matrix, got "
                         f"{w.dtype} {tuple(w.shape)}")
    ldw = _tma_operand(w, "w")
    if (a.dtype == torch.float32) != (w_lo is not None):
        raise ValueError("w_lo (the weight's lo plane) is given exactly for "
                         "fp32")
    if w_lo is not None and (w_lo.shape != w.shape or w_lo.dtype != w.dtype
                             or _tma_operand(w_lo, "w_lo") != ldw):
        raise ValueError("w_lo must match its hi plane")
    if k * a.element_size() % 16:
        raise ValueError(f"TMA reads 16-byte pieces of k: K={k} {a.dtype}")
    b32 = _fp32_vector(bias, n, "bias")
    split_epi = epi == EPI_WG_GELU_RESID_SPLIT
    if bn and bn not in WG_TILE_WIDTHS[a.dtype]:
        raise ValueError(f"no {bn}-wide {a.dtype} tile")
    if epi in (EPI_WG_BIAS, EPI_WG_BIAS_GELU) and resids:
        raise ValueError("EPI_WG_BIAS and EPI_WG_BIAS_GELU take no residual")
    if epi == EPI_WG_BIAS_RESID and len(resids) != 1:
        raise ValueError("EPI_WG_BIAS_RESID takes one residual")
    if split_epi:
        if split <= 0 or split % 8 or n % split or \
                n // split != len(resids) or len(resids) > WG_MAX_BRANCHES:
            raise ValueError(f"the split epilogue needs N = branches x split "
                             f"(split a multiple of 8, at most "
                             f"{WG_MAX_BRANCHES} branches) and one residual "
                             f"per branch, got N={n}, split={split}, "
                             f"{len(resids)} residuals")
        shape, width = (n // split, m, split), split
    elif epi in (EPI_WG_BIAS, EPI_WG_BIAS_RESID, EPI_WG_BIAS_GELU):
        shape, width = (m, n), n
    else:
        raise ValueError(f"unknown epilogue {epi}")
    if out is None:
        out = torch.empty(shape, device=a.device, dtype=a.dtype)
    if out.shape != shape or out.dtype != a.dtype or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {a.dtype} {shape}")
    r_ptrs = (_P * WG_MAX_BRANCHES)()
    ldr = 0
    for i, r in enumerate(resids):
        ldr_i = _rows(r, "resid")
        if r.shape != (m, width) or r.dtype != a.dtype or \
                (i and ldr_i != ldr):
            raise ValueError(f"each resid must be {a.dtype} ({m}, {width}) "
                             f"with one row stride")
        ldr = ldr_i
        r_ptrs[i] = r.data_ptr()
    _check(load().ag_gemm_wg(
        _dtype_code(a), epi, a.data_ptr(), lda, w.data_ptr(),
        None if w_lo is None else w_lo.data_ptr(), ldw, b32.data_ptr(),
        r_ptrs, ldr, out.data_ptr(), width, m * split if split_epi else 0,
        split if split_epi else 0, m, n, k, bn, _stream()), "ag_gemm_wg")
    return out


def rows_prep(x: torch.Tensor, ln: Tuple[torch.Tensor, torch.Tensor, float]
              ) -> torch.Tensor:
    """The LayerNorm row pass before the float GEMM, one warp per row of x
    <M, K>: -> cast(LN(x)) as a new contiguous <M, K> tensor of x's dtype
    (ln = (fp32 w, fp32 b, eps))."""
    ldx = _rows(x, "x")
    m, k = x.shape
    w32 = _fp32_vector(ln[0], k, "ln weight")
    b32 = _fp32_vector(ln[1], k, "ln bias")
    out = torch.empty((m, k), device=x.device, dtype=x.dtype)
    _check(load().ag_rows_prep(_dtype_code(x), x.data_ptr(), ldx, m, k,
                               float(ln[2]), w32.data_ptr(), b32.data_ptr(),
                               out.data_ptr(), _stream()), "ag_rows_prep")
    return out


def _mask_rows(mask: torch.Tensor, shape: tuple,
               dtype: torch.dtype) -> Tuple[torch.Tensor, int]:
    """An attention mask <N, T> as the kernels read it -> (mask, 1 if bf16).
    fp32, and the activation dtype `dtype`, are read as they come: BERT's
    additive bias is made in the activation dtype, so a bf16 step copies
    nothing; another dtype is converted to fp32."""
    if mask.dtype not in (torch.float32, dtype):
        mask = mask.float()
    mask = mask.contiguous()
    if mask.shape != shape:
        raise ValueError(f"mask must be {shape}, got {tuple(mask.shape)}")
    return mask, int(mask.dtype == torch.bfloat16)


# ------------------------------------------------------ the ladder stages

LADDER_QKV, LADDER_ATTENTION, LADDER_MLP = 0, 1, 2


def _ladder_tensor(t: torch.Tensor, shape: tuple, dtype, name: str) -> int:
    if t.shape != shape or t.dtype != dtype or not t.is_contiguous() \
            or not t.is_cuda:
        raise ValueError(f"{name} must be a contiguous CUDA {dtype} {shape}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    _aligned16(t, name, ())
    return t.data_ptr()


def ladder_stage(stage: int, x: torch.Tensor, *, w: torch.Tensor,
                 b: torch.Tensor, lnw: Optional[torch.Tensor] = None,
                 lnb: Optional[torch.Tensor] = None, eps: float = 0.0,
                 post: bool = False, qkv: Optional[torch.Tensor] = None,
                 mask: Optional[torch.Tensor] = None, mul: bool = False,
                 w2: Optional[torch.Tensor] = None,
                 b2: Optional[torch.Tensor] = None,
                 batch: int = 0) -> torch.Tensor:
    """One launch of a ladder stage (`csrc/ladder.cu`) on branch-major
    tensors; -> the stage's new output.
    LADDER_QKV: x <nb, M, S> -> Q|K|V <nb, M, 3S> (w <nb, 3S, S>, b
      <nb, 3S>; LN1 of x first where lnw/lnb are given);
    LADDER_ATTENTION: x (the residual) and qkv -> x1 <nb, M, S> (w = wo
      <nb, S, S>, b = bo; mask <batch, M / batch>, `_mask_rows`; mul: the
      "mul" mask; post: LN1 after the residual);
    LADDER_MLP: x1 -> out <nb, M, S> (w = w1 <nb, I, S>, b = b1, w2 <nb,
      S, I>, b2, I a multiple of 8; lnw/lnb = LN2, before W1 or, with
      post, after the residual).
    Weights in the activation dtype; vectors fp32 <nb, n>.  S: a multiple
    of 8 up to 128, read as S / 8 heads of d = 8."""
    nb, m, s = x.shape
    dtype = x.dtype
    lib = load()
    if not lib.ag_ladder_supports(s):
        raise ValueError(f"the ladder kernels take side widths that are "
                         f"multiples of 8 up to 128 (heads of d = 8), got "
                         f"{s}")
    ptr = functools.partial(_ladder_tensor, dtype=dtype)
    vec = functools.partial(_ladder_tensor, dtype=torch.float32)
    xp = ptr(x, (nb, m, s), name="x")
    ln = [None, None]
    if lnw is not None:
        ln = [vec(lnw, (nb, s), name="ln weight"),
              vec(lnb, (nb, s), name="ln bias")]
    qp = mp = w2p = b2p = None
    tn = inter = 0
    if stage == LADDER_QKV:
        wp, bp = ptr(w, (nb, 3 * s, s), name="wqkv"), vec(b, (nb, 3 * s),
                                                            name="bqkv")
        flags = int(lnw is not None)
        out_shape = (nb, m, 3 * s)
    elif stage == LADDER_ATTENTION:
        if batch <= 0 or m % batch:
            raise ValueError(f"M={m} is not a whole number of {batch} images")
        tn = m // batch
        qp = ptr(qkv, (nb, m, 3 * s), name="qkv")
        mask, mask_bf16 = _mask_rows(mask.to(device=x.device), (batch, tn),
                                     dtype)
        mp = mask.data_ptr()
        wp, bp = ptr(w, (nb, s, s), name="wo"), vec(b, (nb, s), name="bo")
        if post and lnw is None:
            raise ValueError("post-norm needs LN1")
        flags = int(post) | (2 if mul else 0) | 4 * mask_bf16
        out_shape = (nb, m, s)
    elif stage == LADDER_MLP:
        inter = w.shape[1]
        if inter <= 0 or inter % 8:
            raise ValueError(f"the MLP stage takes widths that are multiples "
                             f"of 8, got {inter}")
        wp, bp = ptr(w, (nb, inter, s), name="w1"), vec(b, (nb, inter),
                                                          name="b1")
        w2p, b2p = ptr(w2, (nb, s, inter), name="w2"), vec(b2, (nb, s),
                                                             name="b2")
        if lnw is None:
            raise ValueError("the MLP stage needs LN2")
        flags = int(post)
        out_shape = (nb, m, s)
    else:
        raise ValueError(f"unknown ladder stage {stage}")
    out = torch.empty(out_shape, device=x.device, dtype=dtype)
    _check(lib.ag_ladder_stage(_dtype_code(x), stage, flags, s, inter, xp,
                               qp, mp, wp, bp, w2p, b2p, *ln, eps,
                               out.data_ptr(), m, nb, batch, tn, _stream()),
           "ag_ladder_stage")
    return out


# head dims the attention core is compiled for
# (`csrc/attention.cu:ag_attention_supports`); it takes any T
CORE_HEAD_DIMS = (8, 16, 32, 64, 128)


def core_head_dim(d: int) -> Optional[int]:
    """The compiled head dim a head of width d runs at: d itself, or the
    next larger one, to which q, k and v are zero-padded; None past 128."""
    return next((c for c in CORE_HEAD_DIMS if c >= d), None) if d >= 1 \
        else None


def attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask_row: torch.Tensor, mode: str,
                    out: torch.Tensor) -> torch.Tensor:
    """The masked attention core on split-head views: q, k, v and out are
    <N, h, T, D> CUDA tensors of one dtype with any (batch, head, row)
    strides and contiguous rows; mask_row <N, T> is a 0/1 row ("mul") or
    an additive bias ("add").  q, k and v are read in 16-byte pieces:
    their pointers and strides must be whole multiples of 16 bytes.  A
    head dim the core is not compiled for (up to 128) is zero-padded to the
    next compiled one, with the true 1/sqrt(D) scale, and the output's
    padded columns dropped: exact.  Writes out and returns it."""
    if mode not in ("mul", "add"):
        raise ValueError(f"unknown mask mode {mode!r}")
    n, nh, t, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        if not x.is_cuda or x.shape != (n, nh, t, d) or x.stride(3) != 1 \
                or x.dtype != q.dtype:
            raise ValueError(
                f"{name} must be a CUDA {q.dtype} <{n}, {nh}, {t}, {d}> "
                f"view with contiguous rows, got {x.dtype} "
                f"{tuple(x.shape)} strides {x.stride()}")
    dc = core_head_dim(d)
    if dc is None or t < 1:
        raise ValueError(f"attention core is built for head dims "
                         f"{CORE_HEAD_DIMS} (a narrower head is zero-padded "
                         f"to one) and T >= 1, got d={d}, T={t}")
    if n > 65535 or nh > 65535:
        raise ValueError(f"the core's grid takes at most 65535 images and "
                         f"heads, got {n} x {nh}")
    target = out
    if dc != d:
        q, k, v = (torch.nn.functional.pad(x, (0, dc - d)) for x in (q, k, v))
        target = torch.empty((n, nh, t, dc), device=q.device, dtype=q.dtype)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _aligned16(x, name, x.stride()[:3])
    lib = load()
    mask, mask_bf16 = _mask_rows(mask_row.to(device=q.device), (n, t),
                                 q.dtype)
    strides = (ctypes.c_longlong * 12)(
        *(s for x in (q, k, v, target) for s in x.stride()[:3]))
    _check(lib.ag_attention(_dtype_code(q), int(mode == "mul"), q.data_ptr(),
                            k.data_ptr(), v.data_ptr(), strides,
                            mask.data_ptr(), mask_bf16, target.data_ptr(), n,
                            t, nh, dc, d, _stream()), "ag_attention")
    if target is not out:
        out.copy_(target[..., :d])
    return out


def attention_core(qkv: torch.Tensor, mask_row: torch.Tensor, b: int, t: int,
                   h: int, n_heads: int, mode: str) -> torch.Tensor:
    """Packed projections <B*T, 3H> (q | k | v) + mask <B, T> -> the
    head-merged masked-attention context <B*T, H>."""
    ld = _rows(qkv, "qkv")
    if qkv.shape != (b * t, 3 * h) or h % n_heads:
        raise ValueError(f"qkv must be ({b * t}, {3 * h}) with H divisible "
                         f"by {n_heads} heads, got {tuple(qkv.shape)}")
    d = h // n_heads
    q, k, v = (qkv.as_strided((b, n_heads, t, d), (t * ld, d, ld, 1),
                              qkv.storage_offset() + part * h)
               for part in range(3))
    ctx = torch.empty((b * t, h), device=qkv.device, dtype=qkv.dtype)
    attention_heads(q, k, v, mask_row, mode,
                    ctx.view(b, t, n_heads, d).transpose(1, 2))
    return ctx


# the most branches, and keys, one launch of `csrc/ladder_attention.cu`
# takes (a block stages the image's mask row in shared memory)
LADDER_ATTENTION_MAX_BRANCHES = 16
LADDER_ATTENTION_MAX_T = 32768


def ladder_attention_narrow(qkv_flat: Sequence[torch.Tensor],
                            mask_row: torch.Tensor, mode: str
                            ) -> Tuple[torch.Tensor, ...]:
    """Every branch's masked attention in one launch of
    `csrc/ladder_attention.cu`: qkv_flat holds q, k, v per branch, each a
    contiguous CUDA <B, T, S> of one dtype, read as S / 8 heads of d = 8
    (S a multiple of 8 up to 128, at most LADDER_ATTENTION_MAX_BRANCHES
    branches, T up to LADDER_ATTENTION_MAX_T); mask_row <B, T> a 0/1 row ("mul") or an additive bias
    ("add") -> the per-branch head-merged contexts <B, T, S>."""
    if mode not in ("mul", "add"):
        raise ValueError(f"unknown mask mode {mode!r}")
    if not qkv_flat or len(qkv_flat) % 3:
        raise ValueError("qkv_flat must hold a (q, k, v) triple per branch")
    q0 = qkv_flat[0]
    if q0.dim() != 3:
        raise ValueError(f"q must be <B, T, S>, got {tuple(q0.shape)}")
    b, t, s = q0.shape
    nb = len(qkv_flat) // 3
    lib = load()
    if not lib.ag_ladder_attention_supports(s, s // 8, nb):
        raise ValueError(
            f"the one-launch ladder attention takes S a multiple of 8 up to "
            f"128 in heads of d = 8 and 1 to {LADDER_ATTENTION_MAX_BRANCHES} "
            f"branches, got S={s}, {nb} branches")
    if b > 65535 or not 1 <= t <= LADDER_ATTENTION_MAX_T:
        raise ValueError(f"at most 65535 images and 1 <= T <= "
                         f"{LADDER_ATTENTION_MAX_T}, got {b} x {t}")
    for i, x in enumerate(qkv_flat):
        if not x.is_cuda or x.shape != q0.shape or x.dtype != q0.dtype \
                or not x.is_contiguous():
            raise ValueError(
                f"q/k/v {i} must be a contiguous CUDA {q0.dtype} "
                f"<{b}, {t}, {s}>, got {x.dtype} {tuple(x.shape)} strides "
                f"{x.stride()}")
        _aligned16(x, f"q/k/v {i}", ())
    mask, mask_bf16 = _mask_rows(mask_row.to(device=q0.device), (b, t),
                                 q0.dtype)
    outs = tuple(torch.empty_like(q0) for _ in range(nb))
    ptrs = [(_P * nb)(*(x.data_ptr() for x in qkv_flat[part::3]))
            for part in range(3)]
    _check(lib.ag_ladder_attention(
        _dtype_code(q0), int(mode == "mul"), nb, *ptrs,
        (_P * nb)(*(o.data_ptr() for o in outs)), mask.data_ptr(),
        mask_bf16, b, t, s, _stream()), "ag_ladder_attention")
    return outs


# ------------------------------------------------------------ autograd


# backward passes of `_KernelFn`: each recomputes a plain version
RECOMPUTES = LaunchCounter("plain_recompute")


class _KernelFn(torch.autograd.Function):
    """Forward runs the kernel; backward differentiates the plain version
    (recompute, counted by RECOMPUTES), the counterpart of the JAX
    package's custom_vjp."""

    @staticmethod
    def forward(ctx, kernel, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return kernel(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        RECOMPUTES.add()
        tensors = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(t.is_floating_point())
                      for t in tensors]
            outs = ctx.plain(*inputs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            diff = [x for x in inputs if x.requires_grad]
            got = iter(torch.autograd.grad(outs, diff, grads,
                                           allow_unused=True))
        return (None, None, *(next(got) if x.requires_grad else None
                              for x in inputs))


def dispatch(launch: Callable, plain: Callable, counter,
             tensors: Sequence[torch.Tensor], static: dict,
             grad: Optional[Callable] = None):
    """The one routing rule of every kernel op: CPU tensors take the plain
    version; CUDA tensors launch the kernel (and count the call), with the
    plain version as the gradient; any other device raises, and so does a
    tensor-parallel weight shard (`parallel/tp.py`).

    `grad`, when given, is the function whose autograd is the gradient on
    both devices (the int8 ops: the unquantized math, as the JAX package's
    custom_vjp backward; rounding would zero the gradients).

    Where no gradient is wanted (grad mode off, as in a no-grad teacher
    sweep, or no input requiring one) the call skips the autograd
    function, so no input is kept for a backward.

    Under `torch.export` the call is the op's custom op
    (`kernels/library.py`), whose CUDA implementation is `launch`, counted,
    and whose CPU implementation is `plain`: the same routes, at the
    exported program's run time."""
    if any(getattr(t, "tp_shard", None) is not None for t in tensors):
        raise ValueError(
            f"{getattr(counter, 'name', 'kernel op')}: a tensor-parallel "
            "shard of a weight reached a kernel op, which would compute on "
            "a partial sum; a sharded model runs pallas mode \"0\" "
            "(parallel.mesh.mesh_safe_pallas)")
    if torch.compiler.is_exporting():
        from .library import call

        return call(launch, tensors, static)
    device = tensors[0].device
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)
    if device.type == "cpu":
        if grad is None or not needs_grad:
            return plain(*tensors, **static)
        return _KernelFn.apply(functools.partial(plain, **static),
                               functools.partial(grad, **static), *tensors)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")

    def kernel(*ts):
        out = launch(*ts, **static)
        counter.add()
        return out

    if not needs_grad:
        return kernel(*tensors)
    return _KernelFn.apply(kernel, functools.partial(grad or plain, **static),
                           *tensors)
