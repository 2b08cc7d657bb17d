"""Shared training machinery (port of `autognothi_tpu/pipeline/training.py`):
AdamW with the optax arithmetic and freeze masks, the cosine learning
rate, ragged-batch padding, the compute dtype, and the SIGTERM-graceful
batch loop.

- Freezing is partitioning, as `optax.multi_transform` with `set_to_zero`
  does it: a frozen parameter gets no update and no weight decay.  The
  port's frozen parameters do not require grad at all, so the frozen
  trunk is not differentiated; the trainable gradients are the same.
- `update_mask` (per-parameter 0 or 1) multiplies both the gradients and
  the updates, so a masked parameter's moments decay towards 0 and it does
  not move, while the one global Adam count still advances (the JAX
  package's known deviation from torch's per-parameter counts, kept).
- `torch.optim.AdamW` is not used: it keeps one step count per parameter
  and would decay a masked parameter.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import signal
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# torch.optim.AdamW defaults; the reference never overrides them
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-2


class AdamW:
    """optax `inject_hyperparams(adamw)` over the trainable parameters,
    `set_to_zero` over the rest, written out in tensor ops:
        count += 1
        mu = (1 - b1) g + b1 mu          nu = (1 - b2) g^2 + b2 nu
        u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
        p += -lr (u + wd p) * update_mask
    with g already multiplied by update_mask.  Moments are fp32 tensors
    beside each trainable parameter; updates are applied in place."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 trainable: Callable[[str], bool]):
        self.names = [k for k in params if trainable(k)]
        self.mu = {k: torch.zeros_like(params[k]) for k in self.names}
        self.nu = {k: torch.zeros_like(params[k]) for k in self.names}
        self.count = 0

    @torch.no_grad()
    def update(self, params: Mapping[str, torch.Tensor],
               grads: Mapping[str, Optional[torch.Tensor]], lr: float,
               update_mask: Mapping[str, float]) -> None:
        """One step.  `grads[k]` None means a zero gradient (a parameter
        the loss does not reach)."""
        b1, b2 = ADAMW_BETAS
        self.count += 1
        one = torch.ones((), dtype=torch.float32)
        # 1 - b^count in fp32, as optax computes it
        corr1 = one - torch.tensor(b1, dtype=torch.float32) ** self.count
        corr2 = one - torch.tensor(b2, dtype=torch.float32) ** self.count
        for k in self.names:
            p, m = params[k], float(update_mask[k])
            g = grads.get(k)
            g = torch.zeros_like(p) if g is None else g * m
            mu = self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            nu = self.nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
            upd = (mu / corr1.to(p.device)) / (
                torch.sqrt(nu / corr2.to(p.device)) + ADAMW_EPS)
            upd = (upd + ADAMW_WEIGHT_DECAY * p) * (-lr)
            p.add_(upd * m)


def ones_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: 1.0 for k in params}


def filter_mask(params: Mapping[str, torch.Tensor],
                keep: Callable[[str], bool]) -> Dict[str, float]:
    return {k: 1.0 if keep(k) else 0.0 for k in params}


def cosine_lr(base_lr: float, epoch: int, total_epochs: int) -> float:
    """torch CosineAnnealingLR value for 1-indexed `epoch` (the lr used
    during epoch e is the post-(e-1)-step value, eta_min=0)."""
    if total_epochs <= 0:
        return base_lr
    t = epoch - 1
    return base_lr * (1 + math.cos(math.pi * t / total_epochs)) / 2


def compute_dtype() -> torch.dtype:
    """AUTOGNOTHI_COMPUTE_DTYPE=bfloat16 casts float inputs to bf16 so the
    network computes in bf16 (fp32 statistics and accumulation are built
    into the ops); parameters and optimizer state stay fp32."""
    name = os.environ.get("AUTOGNOTHI_COMPUTE_DTYPE", "float32")
    return torch.bfloat16 if name in ("bf16", "bfloat16") else torch.float32


def cast_input(xs: torch.Tensor) -> torch.Tensor:
    """Apply the compute dtype to floating-point inputs (token ids pass)."""
    return xs.to(compute_dtype()) if xs.is_floating_point() else xs


def pad_batch(xs, zs, batch_size: int):
    """Edge-pad a (possibly ragged final) batch up to `batch_size` ->
    (xs, zs, weights <padded> float32 marking the real rows).  The weighted
    losses make the padded result equal the unpadded one."""
    xs = np.asarray(xs)
    real = xs.shape[0]
    target = -(-real // batch_size) * batch_size

    def pad(a):
        if a.shape[0] == target:
            return a
        return np.pad(a, [(0, target - a.shape[0])] + [(0, 0)] * (a.ndim - 1),
                      mode="edge")

    weights = np.zeros((target,), np.float32)
    weights[:real] = 1.0
    return pad(xs), (None if zs is None else pad(np.asarray(zs))), weights


# ------------------------------------------ SIGTERM-graceful interruption

#: exit code for "interrupted cleanly, state durable, rerun to resume"
INTERRUPT_EXIT_CODE = 75

_SHUTDOWN = {"requested": False, "depth": 0, "prev": None}


class TrainingInterrupted(RuntimeError):
    """Raised at a batch boundary after SIGTERM: completed epochs are
    checkpointed; rerunning the same command resumes from the newest one."""


def shutdown_requested() -> bool:
    return _SHUTDOWN["requested"]


def _restore_disposition() -> None:
    prev = _SHUTDOWN["prev"]
    if not (callable(prev) or prev in (signal.SIG_DFL, signal.SIG_IGN)):
        prev = signal.SIG_DFL
    signal.signal(signal.SIGTERM, prev)


def _sigterm_handler(signum, frame):
    if _SHUTDOWN["requested"]:
        # a second TERM gets the previous disposition back
        _restore_disposition()
        signal.raise_signal(signal.SIGTERM)
        return
    _SHUTDOWN["requested"] = True


@contextlib.contextmanager
def graceful_scope():
    """Inside the scope the first SIGTERM requests a stop at the next batch
    boundary (polled by `LossDrain.push`) and a second one takes the
    previous disposition; outside it SIGTERM keeps its usual meaning.
    Re-entrant; a no-op off the main thread."""
    installed = False
    try:
        if _SHUTDOWN["depth"] == 0:
            _SHUTDOWN["prev"] = signal.getsignal(signal.SIGTERM)
            signal.signal(signal.SIGTERM, _sigterm_handler)
        _SHUTDOWN["depth"] += 1
        installed = True
    except (ValueError, AttributeError, OSError):
        pass  # not the main thread: run without the handler
    try:
        yield
    finally:
        if installed:
            _SHUTDOWN["depth"] -= 1
            if _SHUTDOWN["depth"] == 0 and signal.getsignal(
                    signal.SIGTERM) is _sigterm_handler:
                _restore_disposition()


def graceful_training(fn):
    """Run a trainer inside `graceful_scope()`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with graceful_scope():
            return fn(*args, **kwargs)
    return wrapped


class LossDrain:
    """The per-batch loss fetch every trainer shares, and the one point
    where a requested SIGTERM stops the loop at a batch boundary.
    `push(device_vals, host_vals)` fetches one batch's values and calls
    `emit(batch_idx, host_values, host_vals)`; `flush()` ends the epoch."""

    def __init__(self, emit: Callable[[int, Tuple[float, ...], tuple],
                                      None]):
        self._emit = emit
        self._count = 0

    def push(self, device_vals: tuple, host_vals: tuple = ()) -> None:
        if shutdown_requested():
            raise TrainingInterrupted(
                "SIGTERM: stopped at a batch boundary; completed epochs are "
                "checkpointed, rerun the same command to resume")
        self._emit(self._count, tuple(float(v) for v in device_vals),
                   host_vals)
        self._count += 1

    def flush(self) -> None:
        self._count = 0
