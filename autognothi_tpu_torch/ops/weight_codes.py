"""What the kernels read of the weights, made once per weight version: the
int8 ops' per-output-channel weight codes, and the float ops' packed
weights, fp32 vectors and tf32 planes.

The int8 ops' weight codes are a pure function of the live weights (the
JAX ops compute them with `quant_cols` at every call,
`autognothi_tpu/ops/attention_block.py:231-234`,
`autognothi_tpu/ops/ladder_block.py:506-507`).  `weight_codes` computes
the same function with the same quantizer, and keeps the result until a
source weight changes: the key is each source tensor's identity (for a
view, such as a K8 tile's slice of b1, made anew at each call,
the identity of the tensor it views and where it lies in it), held
through a `weakref` (the cache keeps no weight alive and forgets an entry
when one of its weights dies), and its `_version` (which a view shares
with its base) and `data_ptr`.  Any in-place update bumps
`_version` (AdamW's step, `copy_`, a checkpoint loaded in place), so the
next call recomputes.  The weights stay runtime arguments: this is not
the constant fold of an export, whose codes drift from the live weights.

The K8q chain (the int8 split MLP) takes every tile's codes and fp32
vectors in one lookup (`split_codes`).  The float kernels (K6's products,
K5's ladder step, the K8 tiles) take the same cache for what they would
otherwise make at every call: the packed Q|K|V weight and bias, the fp32
copies of bias and LN vectors, every ladder branch's weights stacked per
kind, and the tf32 hi and lo planes of the fp32 weights (`tf32_planes`, a
plain torch function on the bits).

A write that bypasses the version counter (through `.data`) is not seen;
nothing in the port writes weights that way.  Inference tensors have no
version counter: their codes are computed at each call.

Under `torch.export` (`torch.compiler.is_exporting()`) nothing is cached
and no key is read (a traced tensor has no data pointer): each function
computes its result from the traced weights, so what it makes is a part
of the exported program, computed from the program's weight arguments at
each call, as the JAX program quantizes its weight arguments.  The
kernel ops' own lookups run inside their custom ops
(`kernels/library.py`), at the program's run time, on its real weights,
and cache as on the live path.
"""

from __future__ import annotations

import functools
import threading
import weakref
from typing import Callable, Dict, Sequence, Tuple

import torch

from ..kernels.primitives import quant_rows

# reentrant: a weight's weakref callback (`forget`) may run in this thread
# while it holds the lock, when the garbage collector frees a dead weight
# in the middle of a cache update
_lock = threading.RLock()
_entries: Dict[tuple, tuple] = {}


def _key_state(sources: Sequence[torch.Tensor]):
    """-> (the tensors whose identity keys the sources, the key's part for
    the sources, their state).  A source is keyed on its own identity, or
    a view on the identity of the tensor it views and where it lies in it;
    its state is its version and data pointer (a dtype, device or shape
    change through `.data` moves the pointer)."""
    owners, where, state = [], [], []
    for w in sources:
        base = w._base
        if base is None:
            owners.append(w)
            where.append(id(w))
        else:
            owners.append(base)
            where.append((id(base), w.storage_offset(), tuple(w.shape),
                          w.stride()))
        state.append(w._version)
        state.append(w.data_ptr())
    return owners, tuple(where), tuple(state)


def cached(sources: Sequence[torch.Tensor], tag: tuple,
           make: Callable[[], object]):
    """`make()`, computed once per version of the `sources` (keyed with
    `tag`, the rest of what the result depends on)."""
    if torch.compiler.is_exporting() or any(w.is_inference()
                                            for w in sources):
        return make()  # traced, or no version counter to key on
    owners, where, state = _key_state(sources)
    key = (tag, where)
    with _lock:
        hit = _entries.get(key)
    if hit is not None:
        refs, seen, value = hit
        if seen == state and all(r() is o for r, o in zip(refs, owners)):
            return value
    value = make()

    def forget(_ref, key=key):
        with _lock:
            _entries.pop(key, None)

    entry = (tuple(weakref.ref(o, forget) for o in owners), state, value)
    with _lock:
        _entries[key] = entry
    return value


def _quantize(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight recipe: the row quantizer's kernel on the card (reading a
    column slice in place through its row stride), its plain version
    (`quant_cols`) on the CPU."""
    if w.is_cuda:
        return quant_rows(w if w.stride(-1) == 1 else w.contiguous(),
                          weight=True)
    from .mlp_block import quant_cols

    return quant_cols(w)


def weight_codes(weights: Sequence[torch.Tensor], dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes <sum of rows, in>, fp32 scales) of torch-layout weights
    cast to `dtype`, their rows stacked (Q | K | V): per output channel, so
    the stacked codes are each weight's own."""
    def make():
        with torch.no_grad():
            ws = [w.to(dtype) for w in weights]
            return _quantize(ws[0] if len(ws) == 1 else torch.cat(ws))

    return cached(weights, ("codes", dtype), make)


def split_codes(w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor, n_tiles: int, dtype: torch.dtype
                ) -> Tuple[torch.Tensor, ...]:
    """What the kernels of a K8q chain (`mlp_block.mlp_block_int8_tiled`)
    read of its weights, for every tile in one lookup: (codes of W1 cast to
    `dtype`, per output channel <inter, H> (a tile's are its rows'), their
    scales <inter>, b1 in fp32 <inter>, the codes of each tile's W2 column
    slice per output row of the slice <n_tiles, H, tile> (quantized in
    place through its row stride), their scales <n_tiles, H>, each tile's
    b2 in fp32 <n_tiles, H>: zeros but on the last tile).  Every tensor is
    made here, so the cache keeps none of the weights alive."""
    def make():
        with torch.no_grad():
            w1c, w2c = w1.to(dtype), w2.to(dtype)
            width = w1.shape[0] // n_tiles
            q1, s1 = _quantize(w1c)
            parts = [_quantize(w2c[:, k * width:(k + 1) * width])
                     for k in range(n_tiles)]
            b2s = torch.zeros((n_tiles, b2.shape[0]), device=b2.device,
                              dtype=torch.float32)
            b2s[-1] = b2
            return (q1, s1, b1.to(torch.float32, copy=True),
                    torch.stack([q for q, _ in parts]),
                    torch.stack([s for _, s in parts]), b2s)

    return cached((w1, b1, w2, b2), ("split codes", dtype, n_tiles), make)


def zero_bias(b: torch.Tensor) -> torch.Tensor:
    """zeros_like(b), made once per version of b (the split MLP's b2 on
    every tile but the last).  Made outside inference mode, so a forward
    that differentiates may save it."""
    def make():
        with torch.inference_mode(False):
            return torch.zeros_like(b)

    return cached((b,), ("zeros",), make)


def identity_ln(n: int, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ones, zeros) fp32 <n> on `device`: the LayerNorm vectors an op
    without LN hands its kernel and plain version, made once (outside
    inference mode, so a forward that differentiates may save them), not
    at every call; made in the program under export."""
    if torch.compiler.is_exporting():
        return (torch.ones(n, device=device),
                torch.zeros(n, device=device))
    return _identity_ln(n, torch.device(device))


@functools.lru_cache(maxsize=None)
def _identity_ln(n: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    with torch.inference_mode(False), torch.no_grad():
        return (torch.ones(n, device=device),
                torch.zeros(n, device=device))


def packed_bias(biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fp32 concatenation of bias vectors (the packed Q | K | V bias)."""
    def make():
        with torch.no_grad():
            return torch.cat([b.float() for b in biases])

    return cached(biases, ("bias",), make)


def size() -> int:
    """The number of cached results."""
    with _lock:
        return len(_entries)


def tf32_planes(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split of an fp32 tensor, as the kernels make it (`csrc/
    common.cuh:split_tf32`): hi = rna_tf32(x) and lo = rna_tf32(x - hi),
    each rounded half away from zero to 10 significand bits by integer ops
    on the bits; -> (hi, lo), fp32 tensors whose low 13 bits are zero."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32 planes are made from fp32, got {x.dtype}")

    def rna(v: torch.Tensor) -> torch.Tensor:
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def vec32(v: torch.Tensor) -> torch.Tensor:
    """v as a contiguous fp32 vector: v itself where it is one, else its
    fp32 copy, once per version of v."""
    if v.dtype == torch.float32 and v.is_contiguous():
        return v

    def make():
        with torch.no_grad():
            return v.float().contiguous()

    return cached((v,), ("vec32",), make)


def float_weight(weights: Sequence[torch.Tensor], dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, ...]:
    """Torch-layout weights with their rows stacked (Q | K | V), as the
    float GEMM reads them: bf16 -> (the packed bf16 matrix,); fp32 -> its
    tf32 (hi, lo) planes.  One bf16 weight whose rows are contiguous is
    taken as it is: the GEMM reads any row stride (a column slice in
    place)."""
    if dtype != torch.float32 and len(weights) == 1 and \
            weights[0].dtype == dtype and weights[0].stride(-1) == 1:
        return (weights[0],)  # nothing to make (and none to keep alive)

    def make():
        with torch.no_grad():
            ws = [w.to(dtype) for w in weights]
            packed = torch.cat(ws) if len(ws) > 1 else ws[0].contiguous()
            return tf32_planes(packed) if dtype == torch.float32 \
                else (packed,)

    return cached(weights, ("float", dtype), make)
