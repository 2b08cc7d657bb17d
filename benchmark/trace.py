"""The profiler's reading of a traced window (`--trace 1`).

`torch.profiler` traces the host and the card over the window.  From its
raw events this keeps: every device activity (kernels, copies, fills)
with its start and length, the host's user ranges (`record_function`:
the program's "teacher", "forward", "backward", "adamw" and the
harness's own) and their projection on the device timeline, and the
host's operators.  From them it works out the device's busy time (the
union of its activities), the longest idle gaps labelled by what the
host was doing, and the device operations that took most time."""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

Interval = Tuple[int, int]          # [start, end) in ns


@dataclasses.dataclass
class Trace:
    window: Interval
    kernels: List[Tuple[str, int, int]]          # device activities
    gpu_ranges: List[Tuple[str, int, int]]       # user ranges on the device
    cpu_ranges: List[Tuple[str, int, int, int]]  # user ranges: name, s, e, tid
    cpu_ops: List[Tuple[str, int, int, int]]     # host operators

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Interval]:
        spans = sorted((max(s, self.window[0]), min(s + d, self.window[1]))
                       for _, s, d in self.kernels)
        merged: List[List[int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_s_in(self, ranges: List[Interval]) -> float:
        """Device seconds of the activities that start inside `ranges`."""
        ranges = sorted(ranges)
        total, i = 0, 0
        for _, s, d in sorted(self.kernels, key=lambda k: k[1]):
            while i < len(ranges) and ranges[i][1] <= s:
                i += 1
            if i < len(ranges) and ranges[i][0] <= s:
                total += d
        return total / 1e9

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for name, _, d in self.kernels:
            by[name] = by.get(name, 0) + d
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], d / 1e9] for name, d in ranked]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle time on the device, summed by what the host was doing at
        the middle of each gap of LABEL_MIN_NS or more: the innermost user
        range open there, or else the host operator that started last
        before it; the shorter gaps are summed under one label."""
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for se in busy for x in se] \
            + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        ranges = sorted((r for r in self.cpu_ranges if r[0] != WINDOW),
                        key=lambda r: r[1])
        ops = sorted(self.cpu_ops, key=lambda r: r[1])
        r_starts = [r[1] for r in ranges]
        o_starts = [o[1] for o in ops]
        short = f"gaps under {LABEL_MIN_NS // 1000} us"
        by: Dict[str, int] = {}
        for s, e in gaps:
            if e - s < LABEL_MIN_NS:
                by[short] = by.get(short, 0) + (e - s)
                continue
            mid = (s + e) // 2
            label = _innermost(ranges, r_starts, mid) \
                or _last_started(ops, o_starts, mid) or "host (no operator)"
            by[label] = by.get(label, 0) + (e - s)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:120], d / 1e9] for name, d in ranked]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}


LABEL_MIN_NS = 20_000
SCAN = 4096


def _innermost(ranges, starts, t: int) -> Optional[str]:
    """The latest-started range that is open at t (looking back at most
    SCAN ranges)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - SCAN), -1):
        if ranges[j][2] >= t:
            return ranges[j][0]
    return None


def _last_started(ops, starts, t: int) -> Optional[str]:
    i = bisect.bisect_right(starts, t) - 1
    return ops[i][0] if i >= 0 else None


WINDOW = "bench.window"


def read(prof) -> Trace:
    """The raw events of a finished `torch.profiler.profile` session whose
    measured window the harness marked with the user range `WINDOW`."""
    from torch.autograd import DeviceType

    kernels, gpu_ranges, cpu_ranges, cpu_ops = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        name, s, d = e.name(), int(e.start_ns()), int(e.duration_ns())
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                gpu_ranges.append((name, s, s + d))
            else:
                kernels.append((name, s, d))
        elif e.is_user_annotation():
            cpu_ranges.append((name, s, s + d, int(e.start_thread_id())))
        elif not name.startswith(("cuda", "Activity Buffer",
                                  "Buffer Flush")):
            cpu_ops.append((name, s, s + d, int(e.start_thread_id())))
    marks = ranges_named(cpu_ranges, WINDOW)
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} {WINDOW} ranges")
    return Trace(marks[0], kernels, gpu_ranges, cpu_ranges, cpu_ops)


def ranges_named(ranges, name: str) -> List[Interval]:
    return [(r[1], r[2]) for r in ranges if r[0] == name]
