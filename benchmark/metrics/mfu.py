"""The model's operations completed in the window (answered rows, or whole
train steps), each at the published dense peak of its arithmetic, over
the window's wall time (%).  Recomputed products and padding are not
counted (`work/`)."""

from .. import core
from ..work import common


def model_ops(layer: dict):
    """The logical ops of the useful work of the window."""
    cell = layer["cell"]
    work = core.module("work", cell.family)
    if "steps" in layer:
        return common.scaled(work.train_ops(cell.model, layer["b"],
                                            layer["m"]), layer["steps"])
    return work.final_ops(cell.model, layer["answered_rows"],
                          layer["int8"])


def read(layer: dict):
    if not layer.get("window_s"):
        return None
    return 100.0 * common.peak_s(model_ops(layer)) / layer["window_s"]
