"""Shared training machinery (port of `autognothi_tpu/pipeline/training.py`):
AdamW with the optax arithmetic and freeze masks, the train step factory
(`make_train_step`, data-parallel over a mesh), the cross-entropy on
probabilities, the cosine learning rate, ragged-batch padding, the compute
dtype, the deferred loss fetch, the anomaly switch, and the
SIGTERM-graceful batch loop.

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

from ..parallel.distributed import any_rank
from ..parallel.mesh import (all_reduce_sum, data_rows, gather_rows,
                             pad_to_multiple, shard_batch)
from ..utils import tracing

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
    beside each trainable parameter; updates are applied in place.
    `params` keeps the trainable parameters, whose tensor-parallel tags a
    directory checkpoint of the moments reads."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 trainable: Callable[[str], bool]):
        self.names = [k for k in params if trainable(k)]
        self.params = {k: params[k] for k in self.names}
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


def ckpt_of(pp, model: torch.nn.Module, opt: AdamW) -> tuple:
    """-> (the flat parameters, the optimizer) an epoch checkpoint saves:
    the module's and `opt`, or under a pipeline (`pp`, a
    `pp_trainer.PPContext`) the stages gathered to the writer.  Under the
    directory backend (AUTOGNOTHI_CKPT_BACKEND=orbax) the rank's own share
    of its module (`params.owned_state`: its shards, its stage) and its
    `opt`, with no gather.  Every rank calls it."""
    from ..params import dir_backend, owned_state

    if dir_backend():
        return owned_state(model), opt
    if pp is None:
        from ..params import to_flat

        return to_flat(model), opt
    return pp.to_flat(model), pp.opt_for_ckpt(opt)


def defer_loss_fetch() -> bool:
    """AUTOGNOTHI_DEFER_LOSS_FETCH=1 fetches the per-step losses once per
    epoch (`LossDrain.flush`) instead of after every batch, so the host
    does not wait on the device between steps; the log lines are the same
    either way, only when they print changes."""
    return os.environ.get("AUTOGNOTHI_DEFER_LOSS_FETCH") == "1"


def pad_ragged() -> bool:
    """AUTOGNOTHI_PAD_RAGGED=0 opts out of fixed-shape batch padding."""
    return os.environ.get("AUTOGNOTHI_PAD_RAGGED", "1") != "0"


def maybe_enable_debug_nans() -> None:
    """AUTOGNOTHI_DEBUG_NANS=1: autograd anomaly detection on every train
    op (the reference's `torch.autograd.set_detect_anomaly(True)`); off by
    default, since it slows every step."""
    if os.environ.get("AUTOGNOTHI_DEBUG_NANS") == "1":
        torch.autograd.set_detect_anomaly(True)


def cross_entropy_on_probs(probs: torch.Tensor, labels: torch.Tensor,
                           weights: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """torch `F.cross_entropy` applied to the models' softmax outputs, that
    is a log-softmax over *probabilities* (the reference's observable
    behaviour, kept).  `weights` <batch> marks real rows (0 = padding): a
    weighted mean."""
    logp = torch.log_softmax(probs, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if weights is None:
        return nll.mean()
    w = weights.to(nll.dtype)
    return (w * nll).sum() / torch.clamp(w.sum(), min=1.0)


def dp_split(mesh, in_axes, batch: tuple):
    """A data-parallel step's inputs -> (this rank's batch, its share of
    the global weight sum), or (batch, None) where the step runs whole on
    every rank (no mesh, or a batch that does not divide "data").

    Every rank holds the global batch; each `in_axes` 0 argument gives
    its r-th n-th part along dim 0 (rows of <B*M, ...> arguments follow
    their batch rows), None passes whole.  The last argument is the
    <B> weights marking real rows (None: all real).  A weighted mean over
    the rank's rows times the share is the rank's weighted sum over the
    GLOBAL weight sum, so the sum over ranks is the one-device value even
    where padding rows fill a whole rank."""
    lead = next(a for a, ax in zip(batch, in_axes) if ax == 0)
    rows = data_rows(mesh, lead.shape[0])
    if rows is None:
        return batch, None
    weights = batch[-1]
    if weights is None:
        weights = torch.ones(lead.shape[:1], device=lead.device)
        batch = (*batch[:-1], weights)
    share = weights[rows].float().sum() / torch.clamp(
        weights.float().sum(), min=1.0)
    return tuple(a if ax is None else shard_batch(a, mesh)
                 for a, ax in zip(batch, in_axes)), share


def dp_merge(mesh, share, loss: torch.Tensor, aux, grads: tuple = ()):
    """The global (loss, aux, grads) of a data-parallel step from this
    rank's: the loss and every 0-d aux value are weighted means, taken
    times the share; they and the gradients are summed over "data" in one
    all-reduce; row outputs (aux with a batch dim) are all-gathered."""
    leaves = list(aux) if isinstance(aux, tuple) else [aux]
    scalars = [i for i, a in enumerate(leaves)
               if isinstance(a, torch.Tensor) and a.dim() == 0]
    summed = all_reduce_sum(
        [*grads, loss * share, *(leaves[i] * share for i in scalars)],
        mesh.get_group("data"))
    grads, loss = tuple(summed[:len(grads)]), summed[len(grads)]
    for i, v in zip(scalars, summed[len(grads) + 1:]):
        leaves[i] = v
    leaves = [gather_rows(a, mesh) if isinstance(a, torch.Tensor)
              and a.dim() > 0 else a for a in leaves]
    return loss, (tuple(leaves) if isinstance(aux, tuple) else leaves[0]), \
        grads


def make_train_step(loss_fn: Callable[..., Tuple[torch.Tensor, object]],
                    mesh=None, in_axes: Optional[tuple] = None) -> Callable:
    """-> step(model, opt, lr, update_mask, *batch) -> (loss, aux), the
    JAX `make_train_step` on a module trained in place:
    `loss_fn(model, *batch) -> (loss, aux)` (a 0-d loss with a graph), the
    gradients of the trainable parameters (those that require grad) by
    `torch.autograd.grad`, then `opt.update` with `update_mask` (which
    multiplies gradients and updates).  aux is returned detached.  The
    spans "forward", "backward" and "adamw" are `utils.tracing.span`s.

    With a data `mesh` (`parallel.mesh.setup_data_parallel`) each rank
    runs its rows of the batch (`dp_split`: `in_axes` per batch argument,
    the last one the weights), and the gradients, the loss and the 0-d aux
    losses are summed over "data" before the update (`dp_merge`), so every
    rank applies the same update and the parameters stay bit-identical."""

    def step(model: torch.nn.Module, opt: AdamW, lr: float,
             update_mask: Mapping[str, float], *batch):
        params = dict(model.named_parameters())
        trainable = {k: p for k, p in params.items() if p.requires_grad}
        share = None
        if mesh is not None:
            batch, share = dp_split(mesh, in_axes, batch)
        with tracing.span("forward"):
            loss, aux = loss_fn(model, *batch)
        with tracing.span("backward"):
            # a section that trains nothing (the vanilla classifier) has
            # no graph to differentiate
            grads = torch.autograd.grad(
                loss if share is None else loss * share,
                list(trainable.values()),
                allow_unused=True) if trainable else ()
        loss, aux = loss.detach(), _detached(aux)
        if share is not None:
            grads = tuple(torch.zeros_like(p) if g is None else g
                          for g, p in zip(grads, trainable.values()))
            loss, aux, grads = dp_merge(mesh, share, loss, aux, grads)
        with tracing.span("adamw"):
            opt.update(params, dict(zip(trainable, grads)), lr, update_mask)
        return loss, aux

    return step


def make_eval_step(eval_fn: Callable[..., tuple], mesh=None,
                   in_axes: Optional[tuple] = None) -> Callable:
    """-> eval(*batch) -> eval_fn(*batch)'s (loss, ...) without a graph,
    data-parallel as `make_train_step` over a mesh: the first output and
    every other 0-d one are weighted means summed over "data", row
    outputs are all-gathered."""

    def call(*batch):
        share = None
        if mesh is not None:
            batch, share = dp_split(mesh, in_axes, batch)
        with torch.no_grad():
            loss, *rest = eval_fn(*batch)
        if share is None:
            return (loss, *rest)
        loss, rest, _ = dp_merge(mesh, share, loss, tuple(rest))
        return (loss, *rest)

    return call


def _detached(aux):
    if isinstance(aux, torch.Tensor):
        return aux.detach()
    if isinstance(aux, tuple):
        return tuple(_detached(a) for a in aux)
    return aux


def pad_batch(xs, zs, batch_size: int):
    """Edge-pad a (possibly ragged final) batch up to `batch_size` ->
    (xs, zs, weights <padded> float32 marking the real rows).  The weighted
    losses make the padded result equal the unpadded one.  With
    AUTOGNOTHI_PAD_RAGGED=0 the batch stays as it is, all weights 1."""
    xs = np.asarray(xs)
    real = xs.shape[0]
    if not pad_ragged():
        return xs, (None if zs is None else np.asarray(zs)), \
            np.ones((real,), np.float32)
    xs = pad_to_multiple(xs, batch_size)
    zs_p = None if zs is None else pad_to_multiple(np.asarray(zs), batch_size)
    weights = np.zeros((xs.shape[0],), np.float32)
    weights[:real] = 1.0
    return xs, zs_p, weights


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
    `push(device_vals, host_vals)` records one batch and `flush()` ends the
    epoch; `emit(batch_idx, host_values, host_vals)` runs in batch order.
    Each batch's values are fetched at once, or, with
    AUTOGNOTHI_DEFER_LOSS_FETCH=1 (`defer_loss_fetch`), all of the epoch's
    at `flush()`; the emitted lines are the same either way."""

    def __init__(self, emit: Callable[[int, Tuple[object, ...], tuple],
                                      None]):
        self._emit = emit
        self.deferred = defer_loss_fetch()
        self._pend: list = []
        self._count = 0

    @staticmethod
    def _fetch(vals: tuple) -> tuple:
        return tuple(v.item() if isinstance(v, torch.Tensor) and v.dim() == 0
                     else v.detach().cpu().numpy()
                     if isinstance(v, torch.Tensor) else float(v)
                     for v in vals)

    def push(self, device_vals: tuple, host_vals: tuple = ()) -> None:
        # in a world of ranks every rank stops at the same batch, or one
        # would wait for the others in the next collective
        if any_rank(shutdown_requested()):
            raise TrainingInterrupted(
                "SIGTERM: stopped at a batch boundary; completed epochs are "
                "checkpointed, rerun the same command to resume")
        if self.deferred:
            self._pend.append((device_vals, host_vals))
        else:
            self._emit(self._count, self._fetch(device_vals), host_vals)
        self._count += 1

    def flush(self) -> None:
        for i, (vals, host) in enumerate(self._pend):
            self._emit(i, self._fetch(vals), host)
        self._pend.clear()
        self._count = 0
