"""Surrogate training stage (port of `autognothi_tpu/pipeline/
train_surrogate.py`): KL distillation of the frozen
classifier under random coalition masks, epoch by epoch, resuming from the
newest surrogate checkpoint.

    python -m autognothi_tpu_torch train_surrogate <experiment_dir> \\
        --device cuda

Per batch: the teacher, the classifier's trunk probabilities
(`fw_classifier`'s second output) on the all-on mask, without a graph and
in the arithmetic AUTOGNOTHI_INT8 picks (W8A8 with it: K1 and K2 in pallas
mode "2"); then the student's branch-0 probabilities on a
`mask_purely_uniform` coalition, under `quant_override("none")`, the KL
loss (`loss_logits_kl_divergence`) and, on the same forward, the
cross-entropy metric.  Each epoch draws its masks, and then its dropout
masks, from a generator on the training device seeded with
`derive_seed(seed, "train_surrogate[epoch=e][train|test]")`.  With
EXPERIMENTAL_progressive_training one more ladder layer unfreezes every
three epochs.  In a world of ranks the stage is data-parallel
(`parallel/mesh.py:setup_data_parallel`, `training.make_train_step`):
the teacher and the student run on each rank's rows in pallas mode "0"
(`mesh_safe_pallas`), as the JAX stage runs them on its mesh.  With
AUTOGNOTHI_PP the student is pipeline-parallel (`pp_trainer.
setup_pp_surrogate`; vanilla kinds only) and the teacher runs on each
rank's "data" rows of the pipe mesh.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..models.common import quant_override
from ..ops.shapley import loss_logits_kl_divergence, mask_purely_uniform
from ..params import from_jax_params
from ..parallel.mesh import axis_size, setup_data_parallel, sharded_eval_fn
from ..parallel.pipeline import pp_config_from_env
from ..parallel.train_step import mesh_safe_pallas
from ..utils.devices import resolve_device
from ..utils.seeding import iterative_generator, set_iterative_seed
from .env import ExpEnv
from .resources import (get_recipe, load_cfg_dataset, load_epoch_model,
                        load_epoch_params, load_misc,
                        maybe_restore_opt_state, save_epoch_ckpt)
from .training import (AdamW, LossDrain, cast_input, cosine_lr,
                       cross_entropy_on_probs, filter_mask, graceful_training,
                       make_eval_step, make_train_step,
                       ckpt_of, maybe_enable_debug_nans, ones_mask,
                       pad_batch)


def surrogate_loss(recipe, m_config, is_ltt: bool):
    """-> loss_fn(model, xs, mask, orig_ys, labels, generator, ltt_active,
    weights) -> (kld, (cls, adapt_ys)): the JAX stage's `loss_fn`
    (`:90-102`)."""

    def loss_fn(model, xs, mask, orig_ys, labels, generator, ltt_active,
                weights):
        kw = {"ltt_active_layers": ltt_active} if is_ltt else {}
        with mesh_safe_pallas(), quant_override("none"):
            adapt_ys, _ = recipe.fw_surrogate(m_config, model, xs, mask,
                                              deterministic=False,
                                              rng=generator, **kw)
        kld = loss_logits_kl_divergence(orig_ys, adapt_ys, weights)
        return kld, (cross_entropy_on_probs(adapt_ys, labels, weights),
                     adapt_ys)

    return loss_fn


def surrogate_teacher(recipe, m_config, mesh=None):
    """-> teacher(cls_model, xs, mask) -> the classifier's trunk
    probabilities, without a graph, in the arithmetic AUTOGNOTHI_INT8 picks
    (no override: not the explainer step's AUTOGNOTHI_INT8_TEACHER).  Over
    a mesh each rank computes its rows in mode "0" and the probabilities
    are all-gathered."""

    def fw(cls_model, xs, mask):
        return recipe.fw_classifier(m_config, cls_model, xs, mask)[1]

    sharded = sharded_eval_fn(fw, mesh, in_axes=(None, 0, 0))

    def teacher(cls_model, xs, mask):
        with torch.no_grad(), mesh_safe_pallas():
            return sharded(cls_model, xs, mask)

    return teacher


@graceful_training
def train_surrogate(env: ExpEnv, device: str = "cuda") -> None:
    env.log("[[[ train surrogate ]]]")
    maybe_enable_debug_nans()
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.training.support_surrogate:
        env.log("[[[ skip: surrogate cannot be trained ]]]")
        return
    t_cfg = config.train_surrogate
    if t_cfg is None:
        raise ValueError("the experiment config has no train_surrogate")
    dev = resolve_device(device)
    d_loader = load_cfg_dataset(config.dataset)
    n_players = recipe.n_players(m_config)
    m_misc = load_misc(env, recipe, m_config)
    gen_input = recipe.gen_input(m_config, m_misc)

    _, cls_model = load_epoch_model(env, recipe, "classifier", dev)
    epoch_start, flat = load_epoch_params(env, "surrogate")
    if epoch_start >= t_cfg.epochs:
        env.log("[[[ surrogate already trained ]]]")
        return
    cls_model.requires_grad_(False)
    trainable = recipe.trainable(m_config, "surrogate")
    is_ltt = recipe.progressive_trainable is not None
    full_depth = getattr(m_config, "num_hidden_layers", 0)
    pp_cfg = pp_config_from_env()
    if pp_cfg is not None:
        from .pp_trainer import setup_pp_surrogate

        pp, cls_model, step, eval_fwd = setup_pp_surrogate(
            env, config, m_config, flat, cls_model, trainable, *pp_cfg,
            device=dev)
        model, mesh = pp.model, pp.mesh
        params = dict(model.named_parameters())
        opt = pp.restore_opt(env.model_path, "surrogate", epoch_start,
                             pp.opt)
    else:
        pp = None
        model = from_jax_params(flat, m_config, dev, section="surrogate")
        mesh, place_params, _ = setup_data_parallel(dev)
        if mesh is not None:
            env.log(f"[[[ data-parallel over {axis_size(mesh, 'data')} "
                    "devices ]]]")
            model, cls_model = place_params(model), place_params(cls_model)
        for name, p in model.named_parameters():
            p.requires_grad_(trainable(name))
        params = dict(model.named_parameters())
        # exact resume (AUTOGNOTHI_CKPT_OPT=1); otherwise fresh moments
        opt = maybe_restore_opt_state(env.model_path, "surrogate",
                                      epoch_start, AdamW(params, trainable))
        step = make_train_step(surrogate_loss(recipe, m_config, is_ltt),
                               mesh, in_axes=(0, 0, 0, 0, None, None, 0))

        def eval_loss(xs, mask, orig_ys, labels, ltt_active, weights):
            kw = {"ltt_active_layers": ltt_active} if is_ltt else {}
            with mesh_safe_pallas(), quant_override("none"):
                adapt_ys, _ = recipe.fw_surrogate(m_config, model, xs, mask,
                                                  **kw)
                return (loss_logits_kl_divergence(orig_ys, adapt_ys,
                                                  weights),
                        cross_entropy_on_probs(adapt_ys, labels, weights),
                        adapt_ys)

        eval_fwd = make_eval_step(eval_loss, mesh,
                                  in_axes=(0, 0, 0, 0, None, 0))
    teacher = surrogate_teacher(recipe, m_config, mesh)

    def run_epoch(epoch: int, gen: torch.Generator, lr: float, update_mask,
                  ltt_active: int, train: bool):
        state = {"kld": 0.0, "cls": 0.0, "correct": 0, "total": 0}
        tag = "train" if train else "test"

        def emit(batch_idx, vals, host):
            kld_val, cls_val, adapt = vals
            zs, batch = host
            state["kld"] += kld_val
            state["cls"] += cls_val
            state["correct"] += int(np.sum(
                np.argmax(adapt[:batch], axis=1) == zs))
            state["total"] += batch
            env.log(f"  > epoch {epoch} :{batch_idx}:{tag} // "
                    f"loss: kld {kld_val / batch:.6f} cls "
                    f"{cls_val / batch:.6f} // "
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
            padded = xs.shape[0]
            mask_1 = torch.ones((padded, n_players), dtype=torch.int32,
                                device=dev)
            mask_rand = mask_purely_uniform(gen, padded, n_players)
            orig_ys = teacher(cls_model, xs, mask_1)
            if train:
                kld, (cls, adapt_ys) = step(model, opt, lr, update_mask, xs,
                                            mask_rand, orig_ys, labels, gen,
                                            ltt_active, w)
            else:
                kld, cls, adapt_ys = eval_fwd(xs, mask_rand, orig_ys, labels,
                                              ltt_active, w)
            drain.push((kld, cls, adapt_ys), (np.asarray(zs), batch))
        drain.flush()
        total = max(state["total"], 1)
        return (state["kld"] / total, state["cls"] / total,
                state["correct"] / total)

    for epoch in range(epoch_start + 1, t_cfg.epochs + 1):
        key = f"train_surrogate[epoch={epoch}]"
        set_iterative_seed(config.seed, key)
        env.log(f"### epoch {epoch}")
        update_mask = ones_mask(params)
        ltt_active = full_depth
        if t_cfg.EXPERIMENTAL_progressive_training and is_ltt:
            unfrozen = min(math.ceil(epoch / 3), m_config.num_hidden_layers)
            env.log(f"  > freeze side branches exc. first {unfrozen} layers")
            update_mask = filter_mask(params, recipe.progressive_trainable(
                m_config, "surrogate", unfrozen))
            ltt_active = unfrozen
        lr = cosine_lr(t_cfg.lr, epoch, t_cfg.epochs)
        ts_begin = time.time()
        train_kld, train_cls, train_acc = run_epoch(
            epoch, iterative_generator(config.seed, key + "[train]", dev),
            lr, update_mask, ltt_active, train=True)
        test_kld, test_cls, test_acc = run_epoch(
            epoch, iterative_generator(config.seed, key + "[test]", dev),
            lr, update_mask, ltt_active, train=False)
        ts_delta = time.time() - ts_begin
        env.metrics({"epoch": epoch, "train_kld_loss": train_kld,
                     "train_cls_loss": train_cls, "train_cls_acc": train_acc,
                     "test_kld_loss": test_kld, "test_cls_loss": test_cls,
                     "test_cls_acc": test_acc})
        env.log(f"  > epoch {epoch} done in {ts_delta:.2f}s // "
                f"train_loss: kld {train_kld:.6f} cls {train_cls:.6f} // "
                f"test_loss: kld {test_kld:.6f} cls {test_cls:.6f} // "
                f"test_acc: {test_acc:.3f}")
        save_epoch_ckpt(env.model_path, "surrogate", t_cfg, epoch,
                        *ckpt_of(pp, model, opt))
        env.flush_cfg()
