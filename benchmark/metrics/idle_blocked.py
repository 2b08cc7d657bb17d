"""Share of the traced window with the device idle while the batcher's
dispatcher is blocked handing a slab to the full in-flight queue, in
`batcher.blocked`: the completer sets the pace (%)."""

from .. import spans


def read(layer: dict):
    log = spans.read(layer)
    if log is None or not log.count("batcher.run"):
        return None
    return log.idle_share(spans.BLOCKED)
