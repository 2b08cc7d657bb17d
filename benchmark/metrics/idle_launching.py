"""Share of the traced window with the device idle while the batcher's
dispatcher is issuing a slab: in `batcher.pack` or `batcher.run` (%)."""

from .. import spans


def read(layer: dict):
    log = spans.read(layer)
    if log is None or not log.count("batcher.run"):
        return None
    return log.idle_share(spans.LAUNCHING)
