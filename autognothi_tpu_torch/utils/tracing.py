"""Named spans of the port's host work: the one tracing primitive of every
layer.

    with tracing.span("batcher.run"):
        ...

Off (no `torch.profiler` session open in the process, as in every
deployment) a span costs a flag read at each end, two clock reads and one
add to its name's total (`totals()`: count and host seconds, which the
server's `/statz` reports under `spans`).

On (a session is open, on any thread) a span also

- enters `record_function(name)` where the profiler records the calling
  thread, so the profiler's own trace carries it under the same name, with
  its projection on the device timeline;
- appends `(name, thread, start_ns, end_ns)` to a bounded in-process log
  (`snapshot()`), from every thread, the threads the profiler does not
  record included.  The log keeps the newest `LOG_SPANS` spans and counts
  the ones it drops.

Timestamps are `time.time_ns()`: nanoseconds since the Unix epoch, the
clock of the profiler's host events and of the device activities it
converts, so a logged span can be laid on the profiler's timeline.  The
flag is the profiler's process-wide `_is_profiler_enabled`; whether it
records the calling thread is the thread-local `_profiler_enabled()`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

# at least 250,000: a traced 51-s window of a serving cell logs ~30,000
LOG_SPANS = 1 << 18

Span = Tuple[str, int, int, int]        # name, thread, start_ns, end_ns


class Snapshot(NamedTuple):
    spans: List[Span]
    dropped: int                        # spans the log let go, ever
    dropped_end_ns: Optional[int]       # the newest of those ended here


class _Registry:
    """The process's span totals and span log."""

    def __init__(self, capacity: int):
        self.lock = threading.Lock()
        self.totals: Dict[str, List[float]] = {}
        self.log: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.dropped_end_ns: Optional[int] = None

    def add(self, name: str, t0: int, t1: int, logged: bool) -> None:
        with self.lock:
            total = self.totals.get(name)
            if total is None:
                total = self.totals[name] = [0, 0.0]
            total[0] += 1
            total[1] += (t1 - t0) * 1e-9
            if logged:
                if len(self.log) == self.log.maxlen:
                    self.dropped += 1
                    self.dropped_end_ns = self.log[0][3]
                self.log.append((name, threading.get_native_id(), t0, t1))

    def clear(self) -> None:
        with self.lock:
            self.totals.clear()
            self.log.clear()
            self.dropped, self.dropped_end_ns = 0, None


_REGISTRY = _Registry(LOG_SPANS)


class span:
    """A named stretch of host work on the calling thread (a context
    manager; the module docstring says what it records)."""

    __slots__ = ("name", "t0", "on", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self.on = _profiler._is_profiler_enabled
        self.range = None
        if self.on and torch._C._autograd._profiler_enabled():
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _REGISTRY.add(self.name, self.t0, t1,
                      self.on or _profiler._is_profiler_enabled)
        return False


def totals() -> Dict[str, Dict[str, float]]:
    """Every span name's count and host seconds since the process started
    (or the last `clear`)."""
    with _REGISTRY.lock:
        return {name: {"count": int(c), "seconds": s}
                for name, (c, s) in sorted(_REGISTRY.totals.items())}


def snapshot() -> Snapshot:
    """The span log as it stands: the spans that ended while a profiler
    session was open, oldest first, and what the log dropped."""
    with _REGISTRY.lock:
        return Snapshot(list(_REGISTRY.log), _REGISTRY.dropped,
                        _REGISTRY.dropped_end_ns)


def clear() -> None:
    """Forget every total and logged span."""
    _REGISTRY.clear()
