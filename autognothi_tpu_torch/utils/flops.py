"""FLOPs of one forward call, counted by `torch.utils.flop_counter`
(the port's counterpart of `autognothi_tpu/utils/flops.py`, which walks a
jaxpr).

Both count matmul-class work only, 2*M*N*K per product and 2*out*kernel
per convolution, so the two packages' GFLOP cells compare directly.  The
counter sees the aten products a forward dispatches, and the port's CUDA
kernels launch through ctypes, where it cannot see them; so the forward is
counted on the CPU, where every kernel op takes its plain version: the
same function, and so the same count (the JAX package likewise counts the
products inside its Pallas kernels' bodies).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import FlopCounterMode


def fn_flops(fn: Callable[[], object]) -> float:
    """FLOPs of one call of `fn()`, which must run on CPU tensors (the
    plain versions of the kernel ops)."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())
