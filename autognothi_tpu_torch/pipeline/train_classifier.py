"""Classifier training stage (port of `autognothi_tpu/pipeline/
train_classifier.py`).  For the LTT recipes the trunk is
frozen and the stage trains the side branch 0 and its classifier on the
labels (progressively, one more ladder layer per epoch, when
EXPERIMENTAL_progressive_training is set), epoch by epoch, resuming from
the newest classifier checkpoint.

    python -m autognothi_tpu_torch train_classifier <experiment_dir> \\
        --device cuda

The loss is `cross_entropy_on_probs` of `fw_classifier`'s first output,
the side branch's probabilities.  The differentiated forward runs under
`quant_override("none")`; with dropout active it is the unfused math, and
without it the kernels, whose backward is autograd through their plain
versions.  Dropout masks are drawn from a generator on the training
device seeded with `derive_seed(seed, "train_classifier[epoch=e][train]")`
(the stage draws no coalition masks).  In a world of ranks the stage is
data-parallel (`parallel/mesh.py:setup_data_parallel`,
`training.make_train_step`), its forwards in pallas mode "0"
(`mesh_safe_pallas`).  With AUTOGNOTHI_PP the stage is pipeline-
parallel (`pp_trainer.setup_pp_classifier`; vanilla kinds only).
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from ..models.common import quant_override
from ..params import from_jax_params
from ..parallel.mesh import axis_size, setup_data_parallel
from ..parallel.pipeline import pp_config_from_env
from ..parallel.train_step import mesh_safe_pallas
from ..utils.devices import resolve_device
from ..utils.seeding import iterative_generator, set_iterative_seed
from .env import ExpEnv
from .resources import (get_recipe, load_cfg_dataset, load_epoch_params,
                        load_misc, maybe_restore_opt_state, save_epoch_ckpt)
from .training import (AdamW, LossDrain, cast_input, cosine_lr,
                       cross_entropy_on_probs, filter_mask, graceful_training,
                       make_eval_step, make_train_step,
                       ckpt_of, maybe_enable_debug_nans, ones_mask,
                       pad_batch)


def classifier_loss(recipe, m_config, is_ltt: bool):
    """-> loss_fn(model, xs, mask, labels, generator, ltt_active, weights)
    -> (loss, probs): the JAX stage's `loss_fn` (`:87-101`)."""

    def loss_fn(model, xs, mask, labels, generator, ltt_active, weights):
        kw = {"ltt_active_layers": ltt_active} if is_ltt else {}
        with mesh_safe_pallas(), quant_override("none"):
            probs, _ = recipe.fw_classifier(m_config, model, xs, mask,
                                            deterministic=False,
                                            rng=generator, **kw)
        return cross_entropy_on_probs(probs, labels, weights), probs

    return loss_fn


@graceful_training
def train_classifier(env: ExpEnv, device: str = "cuda",
                     unfreeze_all: bool = False) -> None:
    env.log("[[[ train classifier ]]]")
    maybe_enable_debug_nans()
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.training.support_classifier:
        env.log("[[[ skip: classifier cannot be trained ]]]")
        return
    t_cfg = config.train_classifier
    if t_cfg is None:
        raise ValueError("the experiment config has no train_classifier")
    dev = resolve_device(device)
    d_loader = load_cfg_dataset(config.dataset)
    n_players = recipe.n_players(m_config)
    m_misc = load_misc(env, recipe, m_config)
    gen_input = recipe.gen_input(m_config, m_misc)

    epoch_start, flat = load_epoch_params(env, "classifier")
    if epoch_start >= t_cfg.epochs:
        env.log("[[[ classifier already trained ]]]")
        return
    trainable = ((lambda name: True) if unfreeze_all
                 else recipe.trainable(m_config, "classifier"))
    is_ltt = recipe.progressive_trainable is not None
    full_depth = getattr(m_config, "num_hidden_layers", 0)
    pp_cfg = pp_config_from_env()
    if pp_cfg is not None:
        from .pp_trainer import setup_pp_classifier

        pp, step, eval_fwd = setup_pp_classifier(
            env, config, m_config, flat, trainable, *pp_cfg, device=dev)
        model = pp.model
        params = dict(model.named_parameters())
        opt = pp.restore_opt(env.model_path, "classifier", epoch_start,
                             pp.opt)
    else:
        pp = None
        model = from_jax_params(flat, m_config, dev, section="classifier")
        mesh, place_params, _ = setup_data_parallel(dev)
        if mesh is not None:
            env.log(f"[[[ data-parallel over {axis_size(mesh, 'data')} "
                    "devices ]]]")
            model = place_params(model)
        for name, p in model.named_parameters():
            p.requires_grad_(trainable(name))
        params = dict(model.named_parameters())
        # exact resume (AUTOGNOTHI_CKPT_OPT=1); otherwise fresh moments
        opt = maybe_restore_opt_state(env.model_path, "classifier",
                                      epoch_start, AdamW(params, trainable))
        loss_fn = classifier_loss(recipe, m_config, is_ltt)
        step = make_train_step(loss_fn, mesh,
                               in_axes=(0, 0, 0, None, None, 0))

        def eval_loss(xs, mask, labels, ltt_active, weights):
            kw = {"ltt_active_layers": ltt_active} if is_ltt else {}
            with mesh_safe_pallas(), quant_override("none"):
                probs, _ = recipe.fw_classifier(m_config, model, xs, mask,
                                                **kw)
                return cross_entropy_on_probs(probs, labels, weights), probs

        eval_fwd = make_eval_step(eval_loss, mesh,
                                  in_axes=(0, 0, 0, None, 0))

    def run_epoch(epoch: int, gen: Optional[torch.Generator], lr: float,
                  update_mask, ltt_active: int, train: bool):
        state = {"loss": 0.0, "correct": 0, "total": 0}
        tag = "train" if train else "test"

        def emit(batch_idx, vals, host):
            loss_val, probs = vals
            zs, batch = host
            state["loss"] += loss_val
            state["correct"] += int(np.sum(
                np.argmax(probs[:batch], axis=1) == zs))
            state["total"] += batch
            env.log(f"  > epoch {epoch} :{batch_idx}:{tag} // "
                    f"loss: cls {loss_val / batch:.6f} // "
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
            mask_1 = torch.ones((xs.shape[0], n_players), dtype=torch.int32,
                                device=dev)
            if train:
                loss, probs = step(model, opt, lr, update_mask, xs, mask_1,
                                   labels, gen, ltt_active, w)
            else:
                loss, probs = eval_fwd(xs, mask_1, labels, ltt_active, w)
            drain.push((loss, probs), (np.asarray(zs), batch))
        drain.flush()
        total = max(state["total"], 1)
        return state["loss"] / total, state["correct"] / total

    for epoch in range(epoch_start + 1, t_cfg.epochs + 1):
        key = f"train_classifier[epoch={epoch}]"
        set_iterative_seed(config.seed, key)
        env.log(f"### epoch {epoch}")
        update_mask = ones_mask(params)
        ltt_active = full_depth
        if t_cfg.EXPERIMENTAL_progressive_training and is_ltt:
            unfrozen = min(math.ceil(epoch / 1), m_config.num_hidden_layers)
            env.log(f"  > freeze side branches exc. first {unfrozen} layers")
            update_mask = filter_mask(params, recipe.progressive_trainable(
                m_config, "classifier", unfrozen))
            ltt_active = unfrozen
        lr = cosine_lr(t_cfg.lr, epoch, t_cfg.epochs)
        ts_begin = time.time()
        train_loss, train_acc = run_epoch(
            epoch, iterative_generator(config.seed, key + "[train]", dev),
            lr, update_mask, ltt_active, train=True)
        test_loss, test_acc = run_epoch(epoch, None, lr, update_mask,
                                        ltt_active, train=False)
        ts_delta = time.time() - ts_begin
        env.metrics({"epoch": epoch, "train_cls_loss": train_loss,
                     "train_cls_acc": train_acc, "test_cls_loss": test_loss,
                     "test_cls_acc": test_acc})
        env.log(f"  > epoch {epoch} done in {ts_delta:.2f}s // "
                f"train_loss: cls {train_loss:.6f} // "
                f"test_loss: cls {test_loss:.6f} // test_acc: {test_acc:.3f}")
        save_epoch_ckpt(env.model_path, "classifier", t_cfg, epoch,
                        *ckpt_of(pp, model, opt))
        env.flush_cfg()
