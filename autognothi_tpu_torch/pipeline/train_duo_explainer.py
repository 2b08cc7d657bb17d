"""Duo explainer trainer (port of `autognothi_tpu/pipeline/
train_duo_explainer.py`): the joint classification +
Shapley objective, loss = cross-entropy on the explainer's head + the
Shapley regression (`:82-94`), epoch by epoch, resuming from the newest
explainer checkpoint.  `train_explainer` dispatches here for the duo
recipes.

Per batch: paired-complement coalition masks drawn from the epoch's
generator (or injected by the caller), the frozen surrogate's no-grad
teacher sweep (`parallel/train_step.py:_teacher`: W8A8 unless
AUTOGNOTHI_INT8_TEACHER=0), then the explainer's differentiated forward
under `quant_override("none")`, the backward and AdamW.  Each epoch's
generator is seeded with `derive_seed(seed, "train_explainer[epoch=e]
[train|test]")`; it draws the masks, then the dropout masks.  The epoch
log lines and `env.metrics` keys are the JAX package's.  With
AUTOGNOTHI_CKPT_OPT=1 the optimizer state is checkpointed beside each
epoch and reloaded on resume.  In a world of ranks the stage is
data-parallel: the teacher sweeps each rank's rows with its kernels and
the values are all-gathered (`parallel/train_step.py:make_teacher`, the
JAX `_make_teacher`), the step runs each rank's rows in pallas mode "0"
and sums its gradients over "data" (`training.make_train_step`).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models.common import quant_override
from ..ops.shapley import loss_shapley
from ..params import to_flat
from ..parallel.mesh import axis_size, setup_data_parallel
from ..parallel.train_step import (_sample_masks, make_teacher,
                                   mesh_safe_pallas)
from ..recipes.types import ModelRecipe
from ..utils import tracing
from ..utils.devices import resolve_device
from ..utils.seeding import iterative_generator, set_iterative_seed
from .env import ExpEnv
from .resources import (get_recipe, load_cfg_dataset, load_epoch_model,
                        load_misc, maybe_restore_opt_state, save_epoch_ckpt)
from .training import (AdamW, LossDrain, cast_input, cosine_lr,
                       cross_entropy_on_probs, graceful_training,
                       make_eval_step, make_train_step,
                       maybe_enable_debug_nans, ones_mask,
                       pad_batch)


def duo_loss(recipe: ModelRecipe, m_config: Any, n_players: int) -> Callable:
    """-> loss_fn(model, xs, zs, masks, v_0, v_s, v_1, generator, weights)
    -> (cls + shap, (cls, shap, the head's outputs)): the JAX trainer's
    `joint_loss`; a None generator is the deterministic forward."""

    def loss_fn(model, xs, zs, masks, v_0, v_s, v_1, generator, weights):
        mask_1 = torch.ones((masks.shape[0], n_players), dtype=torch.int32,
                            device=xs.device)
        with mesh_safe_pallas(), quant_override("none"):
            phi, base_ys = recipe.fw_explainer(
                m_config, model, xs, mask_1, v_1, v_0,
                deterministic=generator is None, rng=generator)
        loss_cls = cross_entropy_on_probs(base_ys, zs, weights)
        loss_shap = loss_shapley(masks, v_0, v_s, v_1, phi, weights)
        return loss_cls + loss_shap, (loss_cls, loss_shap, base_ys)

    return loss_fn


def make_duo_explainer_steps(recipe: ModelRecipe, m_config: Any,
                             n_players: int, n_mask_samples: int,
                             mesh=None):
    """-> (step, eval_step):
    step(model, opt, srg_model, surrogate_null, xs, zs, generator, lr,
         update_mask, weights=None, masks=None) -> (loss, (cls, shap, ys))
    eval_step(model, srg_model, surrogate_null, xs, zs, generator,
              weights=None, masks=None) -> the same, without a graph.
    `generator` draws the coalition masks (unless `masks` <B, M, P> is
    given) and then the train step's dropout masks; over a `mesh` the
    masks are the global batch's on every rank."""
    loss_fn = duo_loss(recipe, m_config, n_players)
    in_axes = (0, 0, 0, None, 0, 0, None, 0)
    train = make_train_step(loss_fn, mesh, in_axes)
    teacher = make_teacher(recipe, m_config, mesh)

    def sweep(srg_model, xs, generator, masks):
        if masks is None:
            masks = _sample_masks(generator, xs.shape[0], n_mask_samples,
                                  n_players, xs.device)
        with tracing.span("teacher"):
            v_s, v_1 = teacher(srg_model, xs, masks)
        return masks, v_s, v_1

    def step(model: torch.nn.Module, opt: AdamW, srg_model: torch.nn.Module,
             surrogate_null: torch.Tensor, xs: torch.Tensor,
             zs: torch.Tensor, generator: Optional[torch.Generator],
             lr: float, update_mask, weights: Optional[torch.Tensor] = None,
             masks: Optional[torch.Tensor] = None):
        masks, v_s, v_1 = sweep(srg_model, xs, generator, masks)
        return train(model, opt, lr, update_mask, xs, zs, masks,
                     surrogate_null, v_s, v_1, generator, weights)

    def flat_eval(model, *batch):
        loss, aux = loss_fn(model, *batch)
        return (loss, *aux)

    def eval_step(model: torch.nn.Module, srg_model: torch.nn.Module,
                  surrogate_null: torch.Tensor, xs: torch.Tensor,
                  zs: torch.Tensor, generator: Optional[torch.Generator],
                  weights: Optional[torch.Tensor] = None,
                  masks: Optional[torch.Tensor] = None):
        masks, v_s, v_1 = sweep(srg_model, xs, generator, masks)
        loss, *aux = make_eval_step(
            functools.partial(flat_eval, model), mesh, in_axes)(
                xs, zs, masks, surrogate_null, v_s, v_1, None, weights)
        return loss, tuple(aux)

    return step, eval_step


@graceful_training
def train_duo_explainer(env: ExpEnv, device: str = "cuda") -> None:
    env.log("[[[ train duo explainer ]]]")
    maybe_enable_debug_nans()
    config = env.config
    recipe, m_config = get_recipe(config)
    t_cfg = config.train_explainer
    if t_cfg is None:
        raise ValueError("the experiment config has no train_explainer")
    dev = resolve_device(device)
    d_loader = load_cfg_dataset(config.dataset)
    n_players = recipe.n_players(m_config)
    m_misc = load_misc(env, recipe, m_config)
    gen_input = recipe.gen_input(m_config, m_misc)

    _, srg_model = load_epoch_model(env, recipe, "surrogate", dev)
    epoch_start, model = load_epoch_model(env, recipe, "explainer", dev)
    if epoch_start >= t_cfg.epochs:
        env.log("[[[ explainer already trained ]]]")
        return
    mesh, place_params, _ = setup_data_parallel(dev)
    if mesh is not None:
        env.log(f"[[[ data-parallel over {axis_size(mesh, 'data')} "
                "devices ]]]")
        model, srg_model = place_params(model), place_params(srg_model)
    srg_model.requires_grad_(False)
    trainable = recipe.trainable(m_config, "explainer")
    for name, p in model.named_parameters():
        p.requires_grad_(trainable(name))
    params = dict(model.named_parameters())
    # exact resume (AUTOGNOTHI_CKPT_OPT=1); otherwise fresh moments
    opt = maybe_restore_opt_state(env.model_path, "explainer", epoch_start,
                                  AdamW(params, trainable))
    step, eval_step = make_duo_explainer_steps(recipe, m_config, n_players,
                                               t_cfg.n_mask_samples, mesh)
    with torch.no_grad():
        nil_xs = torch.from_numpy(recipe.gen_null(m_config, m_misc)).to(dev)
        surrogate_null, _ = recipe.fw_surrogate(
            m_config, srg_model, nil_xs,
            torch.ones((1, n_players), dtype=torch.int32, device=dev))

    def run_epoch(epoch: int, gen: torch.Generator, lr: float, update_mask,
                  train: bool):
        state = {"cls": 0.0, "reg": 0.0, "tot": 0.0, "correct": 0,
                 "total": 0}
        tag = "train" if train else "test"

        def emit(batch_idx, vals, host):
            cls_v, reg_v, tot_v, base = vals
            zs_np, batch = host
            state["cls"] += cls_v
            state["reg"] += reg_v
            state["tot"] += tot_v
            state["correct"] += int(np.sum(
                np.argmax(base[:batch], axis=1) == zs_np))
            state["total"] += batch
            env.log(f"  > epoch {epoch} :{batch_idx}:{tag} // "
                    f"loss: cls {cls_v / batch:.6f} shap {reg_v / batch:.6f} "
                    f"tot {tot_v / batch:.6f} // "
                    f"acc: {100.0 * state['correct'] / state['total']:.3f}%, "
                    f"{state['correct']}/{state['total']}")

        drain = LossDrain(emit)
        items = (d_loader.train(t_cfg.batch_size) if train
                 else d_loader.test(t_cfg.batch_size))
        for _inputs, _targets in items:
            xs, zs = gen_input(_inputs, _targets)
            batch = xs.shape[0]
            xs, zs_p, weights = pad_batch(xs, zs, t_cfg.batch_size)
            xs = cast_input(torch.from_numpy(xs).to(dev))
            labels = torch.from_numpy(zs_p).to(dev)
            w = torch.from_numpy(weights).to(dev)
            if train:
                loss, (cls, shap, base_ys) = step(
                    model, opt, srg_model, surrogate_null, xs, labels, gen,
                    lr, update_mask, w)
            else:
                loss, (cls, shap, base_ys) = eval_step(
                    model, srg_model, surrogate_null, xs, labels, gen, w)
            drain.push((cls, shap, loss, base_ys), (np.asarray(zs), batch))
        drain.flush()
        total = max(state["total"], 1)
        return (state["cls"] / total, state["reg"] / total,
                state["tot"] / total, state["correct"] / total)

    for epoch in range(epoch_start + 1, t_cfg.epochs + 1):
        key = f"train_explainer[epoch={epoch}]"
        set_iterative_seed(config.seed, key)
        env.log(f"### epoch {epoch}")
        update_mask = ones_mask(params)
        lr = cosine_lr(t_cfg.lr, epoch, t_cfg.epochs)
        ts_begin = time.time()
        tr_cls, tr_reg, tr_tot, tr_acc = run_epoch(
            epoch, iterative_generator(config.seed, key + "[train]", dev),
            lr, update_mask, train=True)
        te_cls, te_reg, te_tot, te_acc = run_epoch(
            epoch, iterative_generator(config.seed, key + "[test]", dev),
            lr, update_mask, train=False)
        ts_delta = time.time() - ts_begin
        env.metrics({"epoch": epoch, "train_cls_loss": tr_cls,
                     "train_reg_loss": tr_reg, "train_loss": tr_tot,
                     "train_cls_acc": tr_acc, "test_cls_loss": te_cls,
                     "test_reg_loss": te_reg, "test_loss": te_tot,
                     "test_cls_acc": te_acc, "test_plots": []})
        env.log(f"  > epoch {epoch} done in {ts_delta:.2f}s // "
                f"train_loss: shap {tr_reg:.6f} // "
                f"test_loss: shap {te_reg:.6f}")
        save_epoch_ckpt(env.model_path, "explainer", t_cfg, epoch,
                        to_flat(model), opt=opt)
        env.flush_cfg()
