"""Host milliseconds an answered request on the callers' threads: the
payload to rows (`serve.payload`) and the answer to lists
(`serve.respond`)."""

from .. import spans

CALLER = ("serve.payload", "serve.respond")


def read(layer: dict):
    log = spans.read(layer)
    if log is None or not log.count("serve.respond"):
        return None
    return 1e3 * log.host_s(CALLER) / log.count("serve.respond")
