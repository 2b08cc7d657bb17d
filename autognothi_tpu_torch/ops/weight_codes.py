"""Per-output-channel int8 weight codes, made once per weight version.

The int8 ops' weight codes are a pure function of the live weights (the
JAX ops compute them with `quant_cols` at every call,
`autognothi_tpu/ops/attention_block.py:231-234`,
`autognothi_tpu/ops/ladder_block.py:506-507`).  `weight_codes` computes
the same function with the same quantizer, and keeps the result until a
source weight changes: the key is each source tensor's identity (for a
view, such as the K8q chain's column slice of W2, made anew at each call,
the identity of the tensor it views and where it lies in it), held
through a `weakref` (the cache keeps no weight alive and forgets an entry
when one of its weights dies), and its `_version` (which a view shares
with its base), `data_ptr`, dtype and device.  Any in-place update bumps
`_version` (AdamW's step, `copy_`, a checkpoint loaded in place), so the
next call recomputes.  The weights stay runtime arguments: this is not
the constant fold of an export, whose codes drift from the live weights.

A write that bypasses the version counter (through `.data`) is not seen;
nothing in the port writes weights that way.  Inference tensors have no
version counter: their codes are computed at each call.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, Sequence, Tuple

import torch

from ..kernels.primitives import quant_rows

_lock = threading.Lock()
_entries: Dict[tuple, tuple] = {}


def _owner(w: torch.Tensor) -> torch.Tensor:
    """The tensor whose identity keys `w`: itself, or the tensor it views."""
    return w if w._base is None else w._base


def _where(w: torch.Tensor) -> tuple:
    return (id(_owner(w)), w.storage_offset(), tuple(w.shape), w.stride())


def _state(w: torch.Tensor) -> tuple:
    return (w._version, w.data_ptr(), w.dtype, w.device)


def cached(sources: Sequence[torch.Tensor], tag: tuple,
           make: Callable[[], object]):
    """`make()`, computed once per version of the `sources` (keyed with
    `tag`, the rest of what the result depends on)."""
    if any(w.is_inference() for w in sources):
        return make()  # no version counter to key on
    owners = [_owner(w) for w in sources]
    key = (tag, *(_where(w) for w in sources))
    state = tuple(_state(w) for w in sources)
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

    refs = tuple(weakref.ref(o, forget) for o in owners)
    with _lock:
        _entries[key] = (refs, state, value)
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
