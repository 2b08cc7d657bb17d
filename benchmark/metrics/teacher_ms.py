"""Device milliseconds a step of the activities launched under the train
step's `teacher` range (its projection on the device timeline)."""

from ..trace import ranges_named


def read(layer: dict):
    trace = layer.get("trace")
    if trace is None:
        return None
    spans = ranges_named(trace.gpu_ranges, "teacher")
    if not spans:
        return None
    return 1e3 * trace.kernel_s_in(spans) / len(spans)
