"""Share of the traced window with the device idle while the batcher's
dispatcher waits for rows, in `batcher.wait`: the callers or the traffic
set the pace (%)."""

from .. import spans


def read(layer: dict):
    log = spans.read(layer)
    if log is None or not log.count("batcher.run"):
        return None
    return log.idle_share(spans.WAITING)
