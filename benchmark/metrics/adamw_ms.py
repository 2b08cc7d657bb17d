"""Host milliseconds a step in the train step's `adamw` range (the
per-tensor update's launches; the host paces it)."""

from ..trace import ranges_named


def read(layer: dict):
    trace = layer.get("trace")
    if trace is None:
        return None
    spans = ranges_named(trace.cpu_ranges, "adamw")
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e in spans) / len(spans) / 1e9
