"""Host milliseconds a slab of the batcher's dispatcher issuing it:
`batcher.pack` + `batcher.run` (to set beside the device's busy ms a
slab)."""

from .. import spans


def read(layer: dict):
    log = spans.read(layer)
    if log is None or not log.count("batcher.run"):
        return None
    return 1e3 * log.host_s(spans.LAUNCHING) / log.count("batcher.run")
