"""The least time the device could take for the work it did in the traced
window, each logical op at max(operations / peak of its arithmetic,
bytes / 3.35 TB/s), over the device's busy time in that window (%).  The
work is whole slabs (padding included: the device computed it) or whole
train steps, counted by `work/`."""

from .. import core
from ..work import common


def done_ops(layer: dict):
    cell = layer["cell"]
    work = core.module("work", cell.family)
    if "steps" in layer:
        return common.scaled(work.train_ops(cell.model, layer["b"],
                                            layer["m"]), layer["steps"])
    return common.scaled(work.final_ops(cell.model, layer["batch"],
                                        layer["int8"]), layer["slabs"])


def read(layer: dict):
    trace = layer.get("trace")
    if trace is None:
        return None
    busy = trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * common.least_s(done_ops(layer)) / busy
