"""The explainer train step, the hot loop of training (port of
`autognothi_tpu/parallel/train_step.py`).

One step: paired-complement coalition masks drawn from a generator (or
given by the caller), the no-grad teacher sweep over the B*M masked
surrogate forwards (embeddings computed once per image), the grand
coalition v_1, the differentiated explainer forward and its Shapley
regression loss, the backward, and the AdamW update in place.

- The teacher runs under `torch.no_grad()` and `quant_override` of
  `_teacher_quant()`: W8A8 unless AUTOGNOTHI_INT8_TEACHER=0 (int8 takes
  effect in pallas mode "2" only).  The differentiated forward runs under
  `quant_override("none")`, so its gradients are the float math's.
- `update_mask` (per-parameter 0 or 1) multiplies gradients and updates;
  `ltt_active` is the recipe's `ltt_active_layers` where the recipe
  supports progressive training.
- Frozen parameters do not require grad, so the trunk is not
  differentiated; the JAX step differentiates everything and zeroes the
  frozen updates, and the trainable gradients are the same either way.
- The spans "teacher", "forward", "backward" and "adamw" are
  `utils.tracing.span`s (profiler ranges under a trace), for the step's
  breakdown.
- Over a mesh (`parallel/mesh.py`) the masks are drawn for the global
  batch on every rank from the one generator, and each rank then runs
  the whole step on its rows along "data" (`pipeline.training.dp_split`):
  the teacher with its kernels on a pure data mesh (as the JAX
  `_make_teacher` runs it under shard_map), the differentiated forward in
  pallas mode "0" (`mesh_safe_pallas`), the loss over the global weight
  sum; then one all-reduce sums the gradients and the loss over "data",
  and every rank applies the same AdamW update.  The step gathers
  nothing.  A batch that does not divide "data" runs whole on every rank
  in mode "0", as a Megatron (tensor-parallel) mesh always does.
- On a pipe mesh (`pp`, `pipeline/pp_trainer.py`) the same step runs the
  rank's pipeline stage: the teacher on the rank's "data" rows with its
  kernels (all the rows where "data" is 1), the pipelined forward and
  backward, the loss from the last stage.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Optional

import torch

from ..models.common import pallas_override, quant_override
from ..ops.shapley import loss_shapley, mask_shapley
from ..pipeline.training import AdamW, dp_merge, dp_split
from ..recipes.types import ModelRecipe, surrogate_coalition_values
from ..utils import tracing
from .distributed import world_size
from .mesh import axis_size, sharded_call


def mesh_safe_pallas():
    """Forwards that the JAX package partitions over its mesh (the
    differentiated and eval forwards) run its XLA math there; in a world
    of more than one rank the port's run the same arithmetic, pallas mode
    "0".  One device keeps the kernels."""
    if world_size() > 1:
        return pallas_override("0")
    return contextlib.nullcontext()


def _teacher_quant() -> str:
    """The frozen no-grad teacher sweep runs W8A8 unless
    AUTOGNOTHI_INT8_TEACHER=0; the differentiated forward never does."""
    return "none" if os.environ.get("AUTOGNOTHI_INT8_TEACHER") == "0" \
        else "int8"


def _ltt_kwargs(recipe: ModelRecipe, ltt_active: Optional[int]) -> dict:
    if recipe.progressive_trainable is not None:
        return {"ltt_active_layers": ltt_active}
    return {}


def _teacher(recipe, m_config, srg_model, xs, masks):
    """-> (v_s <B*M, C>, v_1 <B, C>) without a graph."""
    mask_1 = torch.ones((masks.shape[0], masks.shape[2]), dtype=masks.dtype,
                        device=masks.device)
    with torch.no_grad(), quant_override(_teacher_quant()):
        v_s = surrogate_coalition_values(recipe, m_config, srg_model, xs,
                                         masks)
        v_1, _ = recipe.fw_surrogate(m_config, srg_model, xs, mask_1)
    return v_s, v_1


def _teacher_on(mesh, sharded: bool):
    """The teacher's pallas scope: the kernels on the rank's rows of a mesh
    without a "model" axis past 1 (its rows the whole batch where "data"
    is 1, as on a pipe mesh), or on one device; mode "0" wherever the JAX
    teacher runs its XLA path (a Megatron mesh, a batch run whole on every
    rank of several data ranks)."""
    if mesh is not None and axis_size(mesh, "model") == 1 and (
            sharded or axis_size(mesh, "data") == 1):
        return contextlib.nullcontext()
    return mesh_safe_pallas()


def make_teacher(recipe, m_config, mesh=None) -> Callable:
    """-> teacher(srg_model, xs, masks) -> (v_s, v_1) over the GLOBAL
    batch: on a pure data mesh each rank sweeps its rows with the kernels
    and the values are all-gathered (`sharded_call`), as the JAX
    `_make_teacher` (on a mesh of one data rank the rank sweeps the whole
    batch with the kernels); otherwise the whole batch, in mode "0" past
    one rank."""

    def teacher(srg_model, xs, masks):
        n = axis_size(mesh, "data") if mesh is not None else 1
        if mesh is not None and axis_size(mesh, "model") == 1 and n == 1:
            # one data rank (a pipe mesh): its rows are the batch
            return _teacher(recipe, m_config, srg_model, xs, masks)
        if mesh is not None and axis_size(mesh, "model") == 1 \
                and xs.shape[0] % n == 0 and xs.shape[0] >= n:
            return sharded_call(
                lambda m, x, k: _teacher(recipe, m_config, m, x, k), mesh,
                in_axes=(None, 0, 0))(srg_model, xs, masks)
        with mesh_safe_pallas():
            return _teacher(recipe, m_config, srg_model, xs, masks)

    return teacher


def _sample_masks(generator: torch.Generator, b: int, n_mask_samples: int,
                  n_players: int, device: torch.device) -> torch.Tensor:
    masks = mask_shapley(generator, b * n_mask_samples, n_players)
    return masks.reshape(b, n_mask_samples, n_players).to(device)


def _explainer_fw(recipe: ModelRecipe, m_config: Any, pp) -> Callable:
    """-> fw(model, xs, mask, grand, null, **kw) -> (attributions, obs):
    the recipe's, or on a pipe mesh the pipelined one of the rank's stage
    (`pipeline/pp_trainer.PPContext`)."""
    if pp is not None:
        return pp.fw_explainer
    return lambda *args, **kw: recipe.fw_explainer(m_config, *args, **kw)


def make_explainer_train_step(recipe: ModelRecipe, m_config: Any,
                              n_players: int, n_mask_samples: int,
                              mesh=None, pp=None) -> Callable:
    """-> step(model, opt, srg_model, surrogate_null, xs, generator, lr,
               update_mask, ltt_active, weights=None, masks=None) -> loss

    `model` is trained in place: its trainable parameters require grad
    and `opt` is the `AdamW` over them.  `generator` draws the coalition
    masks and then the dropout masks; `masks` <B, M, P>, when given,
    replaces the drawn coalitions (the tests and the chip smoke run hand
    both versions the same masks).  Returns the loss, a 0-d tensor (the
    global batch's over a mesh: module docstring).

    `pp` (`pipeline/pp_trainer.PPContext`, with `mesh` its pipe mesh):
    `model` is the rank's stage, the forward is pipelined, the last stage
    computes the loss and every stage returns it."""
    fw_explainer = _explainer_fw(recipe, m_config, pp)

    def step(model: torch.nn.Module, opt: AdamW, srg_model: torch.nn.Module,
             surrogate_null: torch.Tensor, xs: torch.Tensor,
             generator: Optional[torch.Generator], lr: float,
             update_mask: Dict[str, float], ltt_active: Optional[int],
             weights: Optional[torch.Tensor] = None,
             masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        if masks is None:
            masks = _sample_masks(generator, xs.shape[0], n_mask_samples,
                                  n_players, xs.device)
        share = None
        if mesh is not None:
            (xs, masks, weights), share = dp_split(mesh, (0, 0, 0),
                                                   (xs, masks, weights))
        b = xs.shape[0]
        with tracing.span("teacher"), _teacher_on(mesh, share is not None):
            v_s, v_1 = _teacher(recipe, m_config, srg_model, xs, masks)
        params = dict(model.named_parameters())
        trainable = {k: p for k, p in params.items() if p.requires_grad}
        mask_1 = torch.ones((b, n_players), dtype=masks.dtype,
                            device=xs.device)
        with tracing.span("forward"), mesh_safe_pallas(), \
                quant_override("none"):
            phi, _ = fw_explainer(
                model, xs, mask_1, v_1, surrogate_null,
                deterministic=False, rng=generator,
                **_ltt_kwargs(recipe, ltt_active))
            # before the last pipeline stage phi is the pipe's token
            loss = phi if pp is not None and not pp.last else loss_shapley(
                masks, surrogate_null, v_s, v_1, phi, weights)
        with tracing.span("backward"):
            grads = torch.autograd.grad(
                loss if share is None else loss * share,
                list(trainable.values()), allow_unused=True)
        loss = loss.detach()
        if share is not None:
            grads = tuple(torch.zeros_like(p) if g is None else g
                          for g, p in zip(grads, trainable.values()))
            loss, _, grads = dp_merge(mesh, share, loss, (), grads)
        with tracing.span("adamw"):
            opt.update(params, dict(zip(trainable, grads)), lr, update_mask)
        return loss if pp is None else pp.finish(loss)

    return step


def make_explainer_eval_step(recipe: ModelRecipe, m_config: Any,
                             n_players: int, n_mask_samples: int,
                             mesh=None, pp=None) -> Callable:
    """-> eval(model, srg_model, surrogate_null, xs, generator, ltt_active,
               weights=None, masks=None) -> loss  (deterministic forward,
    the same teacher sweep, no gradient; the global loss over a mesh; `pp`
    as the train step's)."""
    fw_explainer = _explainer_fw(recipe, m_config, pp)

    def eval_step(model: torch.nn.Module, srg_model: torch.nn.Module,
                  surrogate_null: torch.Tensor, xs: torch.Tensor,
                  generator: Optional[torch.Generator],
                  ltt_active: Optional[int],
                  weights: Optional[torch.Tensor] = None,
                  masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        if masks is None:
            masks = _sample_masks(generator, xs.shape[0], n_mask_samples,
                                  n_players, xs.device)
        share = None
        if mesh is not None:
            (xs, masks, weights), share = dp_split(mesh, (0, 0, 0),
                                                   (xs, masks, weights))
        with _teacher_on(mesh, share is not None):
            v_s, v_1 = _teacher(recipe, m_config, srg_model, xs, masks)
        mask_1 = torch.ones((xs.shape[0], n_players), dtype=masks.dtype,
                            device=xs.device)
        # quant pinned off as in the train step's forward
        with torch.no_grad(), mesh_safe_pallas(), quant_override("none"):
            phi, _ = fw_explainer(
                model, xs, mask_1, v_1, surrogate_null,
                **_ltt_kwargs(recipe, ltt_active))
            loss = phi if pp is not None and not pp.last else loss_shapley(
                masks, surrogate_null, v_s, v_1, phi, weights)
        if share is not None:
            loss, _, _ = dp_merge(mesh, share, loss, ())
        return loss if pp is None else pp.finish(loss)

    return eval_step
