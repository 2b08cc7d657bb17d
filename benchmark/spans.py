"""The program's span log over a traced window (`--trace 1`), beside the
profiler's reading (`trace.py`).

The program (`autognothi_tpu_torch.utils.tracing`) logs every span that
ends while a `torch.profiler` session is open, from every thread, as
`(name, thread, start_ns, end_ns)` on the profiler's clock.  This reads
that log after the window, clips it to the window, and lays it over the
device's idle time.  A program without the log, a trace without device
activity, or a log that dropped spans inside the window reads None."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from .trace import Interval, Trace

# the dispatcher's spans, which tile its loop
LAUNCHING = ("batcher.pack", "batcher.run")
WAITING = ("batcher.wait",)
BLOCKED = ("batcher.blocked",)


class Spans:
    def __init__(self, trace: Trace, spans: List[tuple]):
        self.trace = trace
        lo, hi = trace.window
        self.by_name: Dict[str, List[Interval]] = {}
        for name, _, s, e in spans:
            if e > lo and s < hi:
                self.by_name.setdefault(name, []).append(
                    (max(s, lo), min(e, hi)))

    def count(self, name: str) -> int:
        return len(self.by_name.get(name, []))

    def host_s(self, names: Iterable[str]) -> float:
        """Seconds of the named spans inside the window, summed over
        threads."""
        return sum(e - s for n in names for s, e in self.by_name.get(n, [])) \
            / 1e9

    def idle_share(self, names: Iterable[str]) -> float:
        """% of the window in which the device is idle and one of the named
        spans is open."""
        covered = merge(iv for n in names for iv in self.by_name.get(n, []))
        ns = overlap_ns(idle_intervals(self.trace), covered)
        return 100.0 * ns / (self.trace.window[1] - self.trace.window[0])


def read(layer: dict) -> Optional[Spans]:
    trace = layer.get("trace")
    if trace is None or trace.window_s <= 0 or not trace.kernels:
        return None
    try:
        from autognothi_tpu_torch.utils import tracing
    except ImportError:
        return None
    snapshot = getattr(tracing, "snapshot", None)
    if snapshot is None:
        return None
    log = snapshot()
    if log.dropped_end_ns is not None and log.dropped_end_ns > \
            trace.window[0]:
        return None
    return Spans(trace, log.spans)


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_intervals(trace: Trace) -> List[Interval]:
    """The window less the device's busy intervals."""
    lo, hi = trace.window
    out, t = [], lo
    for s, e in trace.busy_intervals():
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def overlap_ns(a: List[Interval], b: List[Interval]) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
