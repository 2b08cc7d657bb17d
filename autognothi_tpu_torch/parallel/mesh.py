"""A single-device stand-in for `autognothi_tpu/parallel/mesh.py`'s
data-parallel helpers, which three reports call (`measure_faithfulness`,
`measure_accuracy`, `measure_cls_acc`).

It is not a mesh: `setup_data_parallel` returns no mesh and two functions
that place a model's parameters and a batch on the one device, and
`sharded_eval_fn` and `sharded_call` return the function unchanged, so the
reports compute exactly what they compute unsharded.  Multi-device
evaluation replaces this module.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch


def setup_data_parallel(device: torch.device
                        ) -> Tuple[None, Callable[[Any], Any],
                                   Callable[[Any], Any]]:
    """-> (mesh = None, place_params, place_batch): a module is moved to
    `device`, a tensor or numpy batch becomes a tensor there."""

    def place_params(model: torch.nn.Module) -> torch.nn.Module:
        return model.to(device)

    def place_batch(x: Any) -> torch.Tensor:
        return torch.as_tensor(x).to(device)

    return None, place_params, place_batch


def sharded_eval_fn(fn: Callable, mesh: Optional[Any],
                    in_axes: Any = None) -> Callable:
    """`fn` itself: one device holds the whole batch."""
    del mesh, in_axes
    return fn


def sharded_call(fn: Callable, mesh: Optional[Any], in_axes: Any = None,
                 out_axes: Any = None) -> Callable:
    """`fn` itself: one device computes every coalition."""
    del mesh, in_axes, out_axes
    return fn
