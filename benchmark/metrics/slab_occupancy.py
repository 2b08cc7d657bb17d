"""Share of the slab rows dispatched in the window that carried a request's
row and not padding (`MicroBatcher`'s row and slab counts, %)."""


def read(layer: dict):
    capacity = layer.get("slabs", 0) * layer.get("batch", 0)
    if not capacity:
        return None
    return 100.0 * layer["rows"] / capacity
