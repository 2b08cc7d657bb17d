"""Explainer training stage (port of `autognothi_tpu/pipeline/
train_explainer.py`): Shapley regression of the explainer
against the masked surrogate values, epoch by epoch, resuming from the
newest explainer checkpoint and writing one per epoch in the JAX package's
npz format.

    python -m autognothi_tpu_torch train_explainer <experiment_dir> \\
        --device cuda

The step is `parallel/train_step.py:make_explainer_train_step`.  Each
epoch draws its coalition (and dropout) masks from a generator on the
training device seeded with `derive_seed(seed, "train_explainer[epoch=e]
[train|test]")`.  The duo recipes train with `train_duo_explainer.py`
(the joint classification + Shapley loss), the KernelSHAP recipe with
`train_kernel_shap_explainer.py` (k-means), as in the JAX package.  In a
world of ranks the stage is data-parallel (`parallel/mesh.py:
setup_data_parallel`; the step's docstring says how).  With AUTOGNOTHI_PP
the explainer is pipeline-parallel (`pp_trainer.setup_pp_explainer`;
vanilla kinds only).  With AUTOGNOTHI_CKPT_OPT=1 the optimizer state is
checkpointed beside each epoch and reloaded on resume.
"""

from __future__ import annotations

import math
import time

import torch

from ..params import from_jax_params
from ..parallel.mesh import axis_size, setup_data_parallel
from ..parallel.pipeline import pp_config_from_env
from ..parallel.train_step import (make_explainer_eval_step,
                                   make_explainer_train_step)
from ..utils.devices import resolve_device
from ..utils.seeding import iterative_generator, set_iterative_seed
from .env import ExpEnv
from .resources import (get_recipe, load_cfg_dataset, load_epoch_model,
                        load_epoch_params, load_misc,
                        maybe_restore_opt_state, save_epoch_ckpt)
from .training import (AdamW, LossDrain, cast_input, ckpt_of, cosine_lr,
                       filter_mask, graceful_training,
                       maybe_enable_debug_nans, ones_mask, pad_batch)


def _surrogate_null(recipe, m_config, m_misc, srg_model, dev):
    """The surrogate on the all-on null input, once."""
    n_players = recipe.n_players(m_config)
    with torch.no_grad():
        nil_xs = torch.from_numpy(recipe.gen_null(m_config, m_misc)).to(dev)
        null, _ = recipe.fw_surrogate(
            m_config, srg_model, nil_xs,
            torch.ones((1, n_players), dtype=torch.int32, device=dev))
    return null


@graceful_training
def train_explainer(env: ExpEnv, device: str = "cuda") -> None:
    env.log("[[[ train explainer ]]]")
    maybe_enable_debug_nans()
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.training.support_explainer:
        env.log("[[[ skip: explainer cannot be trained ]]]")
        return
    if recipe.training.exp_variant_duo:
        from .train_duo_explainer import train_duo_explainer

        return train_duo_explainer(env, device=device)
    if recipe.training.exp_variant_kernel_shap:
        from .train_kernel_shap_explainer import train_kernel_shap_explainer

        return train_kernel_shap_explainer(env, device=device)
    t_cfg = config.train_explainer
    if t_cfg is None:
        raise ValueError("the experiment config has no train_explainer")
    dev = resolve_device(device)
    d_loader = load_cfg_dataset(config.dataset)
    n_players = recipe.n_players(m_config)
    m_misc = load_misc(env, recipe, m_config)
    gen_input = recipe.gen_input(m_config, m_misc)

    _, srg_model = load_epoch_model(env, recipe, "surrogate", dev)
    epoch_start, flat = load_epoch_params(env, "explainer")
    if epoch_start >= t_cfg.epochs:
        env.log("[[[ explainer already trained ]]]")
        return
    srg_model.requires_grad_(False)
    trainable = recipe.trainable(m_config, "explainer")
    pp_cfg = pp_config_from_env()
    if pp_cfg is not None:
        from .pp_trainer import setup_pp_explainer

        # the null before a tensor-parallel stage shards the surrogate
        surrogate_null = _surrogate_null(recipe, m_config, m_misc,
                                         srg_model, dev)
        pp, srg_model, step, eval_step = setup_pp_explainer(
            env, config, m_config, flat, srg_model, recipe, *pp_cfg,
            device=dev)
        model = pp.model
        params = dict(model.named_parameters())
        opt = pp.restore_opt(env.model_path, "explainer", epoch_start,
                             pp.opt)
    else:
        pp = None
        model = from_jax_params(flat, m_config, dev, section="explainer")
        # multi-device: replicate the models, shard the batch/coalition rows
        mesh, place_params, _ = setup_data_parallel(dev)
        if mesh is not None:
            env.log(f"[[[ data-parallel over {axis_size(mesh, 'data')} "
                    "devices ]]]")
            model, srg_model = place_params(model), place_params(srg_model)
        for name, p in model.named_parameters():
            p.requires_grad_(trainable(name))
        params = dict(model.named_parameters())
        # exact resume (AUTOGNOTHI_CKPT_OPT=1); otherwise fresh moments
        opt = maybe_restore_opt_state(env.model_path, "explainer",
                                      epoch_start, AdamW(params, trainable))
        step = make_explainer_train_step(recipe, m_config, n_players,
                                         t_cfg.n_mask_samples, mesh=mesh)
        eval_step = make_explainer_eval_step(recipe, m_config, n_players,
                                             t_cfg.n_mask_samples, mesh=mesh)
        surrogate_null = _surrogate_null(recipe, m_config, m_misc,
                                         srg_model, dev)

    full_depth = getattr(m_config, "num_hidden_layers", 0)

    def run_epoch(epoch: int, gen: torch.Generator, lr: float, update_mask,
                  ltt_active: int, train: bool) -> float:
        state = {"sum": 0.0, "total": 0}
        tag = "train" if train else "test"

        def emit(batch_idx, vals, host):
            loss_val, (batch,) = vals[0], host
            state["sum"] += loss_val
            state["total"] += batch
            env.log(f"  > epoch {epoch} :{batch_idx}:{tag} // "
                    f"loss: shap {loss_val / batch:.6f}, "
                    f"fin {state['total']}")

        drain = LossDrain(emit)
        items = (d_loader.train(t_cfg.batch_size) if train
                 else d_loader.test(t_cfg.batch_size))
        for _inputs, _targets in items:
            xs, _zs = gen_input(_inputs, _targets)
            batch = xs.shape[0]
            xs, _, weights = pad_batch(xs, None, t_cfg.batch_size)
            xs = cast_input(torch.from_numpy(xs).to(dev))
            w = torch.from_numpy(weights).to(dev)
            if train:
                loss = step(model, opt, srg_model, surrogate_null, xs, gen,
                            lr, update_mask, ltt_active, w)
            else:
                loss = eval_step(model, srg_model, surrogate_null, xs, gen,
                                 ltt_active, w)
            drain.push((loss,), (batch,))
        drain.flush()
        return state["sum"] / max(state["total"], 1)

    for epoch in range(epoch_start + 1, t_cfg.epochs + 1):
        key = f"train_explainer[epoch={epoch}]"
        set_iterative_seed(config.seed, key)
        env.log(f"### epoch {epoch}")
        update_mask = ones_mask(params)
        ltt_active = full_depth
        if t_cfg.EXPERIMENTAL_progressive_training and \
                recipe.progressive_trainable is not None:
            unfrozen = min(math.ceil(epoch / 2), m_config.num_hidden_layers)
            env.log(f"  > freeze side branches exc. first {unfrozen} layers")
            update_mask = filter_mask(params, recipe.progressive_trainable(
                m_config, "explainer", unfrozen))
            ltt_active = unfrozen
        lr = cosine_lr(t_cfg.lr, epoch, t_cfg.epochs)
        ts_begin = time.time()
        train_loss = run_epoch(
            epoch, iterative_generator(config.seed, key + "[train]", dev),
            lr, update_mask, ltt_active, train=True)
        test_loss = run_epoch(
            epoch, iterative_generator(config.seed, key + "[test]", dev),
            lr, update_mask, ltt_active, train=False)
        ts_delta = time.time() - ts_begin
        env.metrics({"epoch": epoch, "train_reg_loss": train_loss,
                     "test_reg_loss": test_loss})
        env.log(f"  > epoch {epoch} done in {ts_delta:.2f}s // "
                f"train_loss: shap {train_loss:.6f} // "
                f"test_loss: shap {test_loss:.6f}")
        save_epoch_ckpt(env.model_path, "explainer", t_cfg, epoch,
                        *ckpt_of(pp, model, opt))
        env.flush_cfg()
