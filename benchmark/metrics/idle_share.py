"""Share of the traced window in which no device activity ran (%), from the
profiler's timeline."""


def read(layer: dict):
    trace = layer.get("trace")
    if trace is None or trace.window_s <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
