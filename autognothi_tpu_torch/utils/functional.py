"""Streaming re-batcher: pipe variable-sized work items through a fixed-size
batched operation (the port's copy of `autognothi_tpu/utils/functional.py`,
numpy only).

Fixed-shape batches keep a batched operation's shapes, and so its kernels'
launch shapes, the same from call to call.  `iter_fixed_batches` and
`pad_to` cut parallel arrays into such slabs; `batched` is the
generator-style port of the reference implementation's
`utils.functional.batched`.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np

__all__ = ["batched", "pad_to", "iter_fixed_batches"]


def pad_to(x: np.ndarray, size: int, axis: int = 0) -> np.ndarray:
    """Pad `x` along `axis` with repeats of its last slice up to `size`."""
    cur = x.shape[axis]
    if cur == size:
        return x
    if cur > size:
        raise ValueError(f"cannot pad {cur} down to {size}")
    pad_widths = [(0, 0)] * x.ndim
    pad_widths[axis] = (0, size - cur)
    return np.pad(x, pad_widths, mode="edge")


def batched(
    inp: Callable[[], Iterable[np.ndarray]],
    decorator: Callable[[np.ndarray], np.ndarray],
    operation: Callable[[np.ndarray], np.ndarray],
    batch_size: int,
) -> Iterator[np.ndarray]:
    """For each input item, `decorator` expands it into a <x, ...> workload;
    workloads are concatenated, re-chunked into fixed `batch_size` slabs
    (final slab padded), pushed through `operation`, and the outputs are
    re-split so each yielded array aligns 1:1 with an input item."""

    item_sizes: List[int] = []
    pending_in: List[np.ndarray] = []
    pending_out: List[np.ndarray] = []
    out_cursor = 0

    def flush_one(exact: bool) -> bool:
        nonlocal pending_in
        if not pending_in:
            return False
        total = sum(t.shape[0] for t in pending_in)
        limit = batch_size if exact else total
        if total < limit:
            return False
        stacked = np.concatenate(pending_in, axis=0)
        take, rest = stacked[:limit], stacked[limit:]
        pending_in = [rest] if rest.shape[0] else []
        padded = pad_to(take, batch_size, axis=0) if take.shape[0] < batch_size else take
        out = np.asarray(operation(padded))[: take.shape[0]]
        pending_out.append(out)
        return True

    def pop_item() -> Optional[np.ndarray]:
        nonlocal pending_out, out_cursor
        if not item_sizes:
            return None
        need = item_sizes[0]
        if need == 0:
            # a zero-row workload still yields one (empty) output per item
            # — np.concatenate([]) would raise; reference yields per-item
            item_sizes.pop(0)
            if pending_out:
                return pending_out[0][:0]
            return np.empty((0,), dtype=np.float32)
        have = sum(o.shape[0] for o in pending_out) - out_cursor
        if have < need:
            return None
        pieces: List[np.ndarray] = []
        while need > 0:
            head = pending_out[0]
            avail = head.shape[0] - out_cursor
            take = min(avail, need)
            pieces.append(head[out_cursor : out_cursor + take])
            out_cursor += take
            need -= take
            if out_cursor == head.shape[0]:
                pending_out.pop(0)
                out_cursor = 0
        item_sizes.pop(0)
        return np.concatenate(pieces, axis=0)

    for raw in inp():
        work = np.asarray(decorator(raw))
        item_sizes.append(work.shape[0])
        if work.shape[0]:  # empty workloads never enter the slab packer
            pending_in.append(work)
        while flush_one(exact=True):
            pass
        while (done := pop_item()) is not None:
            yield done
    while flush_one(exact=False):
        pass
    while (done := pop_item()) is not None:
        yield done


def iter_fixed_batches(
    arrays: List[np.ndarray], batch_size: int, drop_remainder: bool = False
) -> Iterator[tuple]:
    """Yield (batch, real_length) tuples of fixed-shape slabs from parallel arrays,
    padding the final partial batch with edge repeats."""
    n = arrays[0].shape[0]
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        real = stop - start
        if real < batch_size and drop_remainder:
            return
        chunk = tuple(pad_to(a[start:stop], batch_size, axis=0) for a in arrays)
        yield chunk, real
