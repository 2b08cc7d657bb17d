"""Dual-task gradient similarity (port of `autognothi_tpu/pipeline/
measure_dual_task_similarity.py`): the cosine similarity between the
embedding-output gradients of the classification loss and of the
Shapley loss, per test input and explainer epoch, for the duo family
(trained on both tasks at once).

    python -m autognothi_tpu_torch measure_dual_task_similarity <exp> \\
        --device cuda

For every checkpointed explainer epoch and test batch: coalition masks
from `mask_shapley` with a CPU generator seeded with `derive_seed(seed,
"dual_task[epoch=<e>,batch=<i>]")` (the JAX package draws from
`jax.random` under the same key name; its masks are not these), the
surrogate's masked values (`surrogate_coalition_values`) and grand
coalition without a graph, then the recipe's `grad_probe` (two
`torch.autograd.grad` calls).  The report holds each epoch's mean and
standard deviation (ddof 1) of the per-input cosines.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..data.loader import DatasetLoader
from ..ops.shapley import mask_shapley
from ..params import from_jax_params
from ..recipes.types import surrogate_coalition_values
from ..utils.devices import resolve_device
from ..utils.seeding import iterative_generator
from .env import ExpEnv
from .resources import (get_epoch_ckpts, get_recipe, load_cfg_dataset,
                        load_epoch_ckpt, load_epoch_model, load_misc)


@dataclasses.dataclass
class MeasureDualTaskSimilarityReport:
    """Requires: surrogate [-1], explainer [ep], the duo family."""

    epochs: List[int]
    cos_sim_avg: List[float]
    cos_sim_std: List[float]


def measure_dual_task_similarity(
        env: ExpEnv, d_loader: Optional[DatasetLoader] = None,
        device: str = "cuda") -> MeasureDualTaskSimilarityReport:
    env.log("loading models...")
    config = env.config
    recipe, m_config = get_recipe(config)
    inspector = recipe.measurements.allow_dual_task_similarity
    if inspector is False or inspector is None:
        raise ValueError("unsupported recipe action")
    dev = resolve_device(device)
    eval_cfg = config.eval_dual_task_similarity

    if d_loader is None:
        env.log("loading dataset...")
        d_loader = load_cfg_dataset(
            eval_cfg.dataset if eval_cfg is not None
            and eval_cfg.dataset is not None else config.dataset)

    m_misc = load_misc(env, recipe, m_config)
    n_players = recipe.n_players(m_config)
    n_mask_samples = config.train_explainer.n_mask_samples
    gen_input = recipe.gen_input(m_config, m_misc)
    batch_size = eval_cfg.batch_size if eval_cfg is not None \
        else config.train_explainer.batch_size

    _, srg_model = load_epoch_model(env, recipe, "surrogate", dev)
    with torch.no_grad():
        nil_xs = torch.from_numpy(recipe.gen_null(m_config, m_misc)).to(dev)
        surrogate_null, _ = recipe.fw_surrogate(
            m_config, srg_model, nil_xs,
            torch.ones((1, n_players), dtype=torch.int32, device=dev))

    def teacher(xs: torch.Tensor, masks: torch.Tensor):
        mask_1 = torch.ones((xs.shape[0], n_players), dtype=torch.int32,
                            device=dev)
        with torch.no_grad():
            v_s = surrogate_coalition_values(recipe, m_config, srg_model,
                                             xs, masks)
            v_1, _ = recipe.fw_surrogate(m_config, srg_model, xs, mask_1)
        return v_s, v_1

    env.log("[[[ running measurement... ]]]")
    all_epochs: List[int] = []
    all_avg: List[float] = []
    all_std: List[float] = []
    for loading_epoch in get_epoch_ckpts(env.model_path, "explainer",
                                         config.train_explainer.epochs):
        epoch_exp, arrays = load_epoch_ckpt(env.model_path, "explainer",
                                            loading_epoch, required=True)
        model = from_jax_params(arrays, m_config, dev, section="explainer")
        model.requires_grad_(False)

        ts_begin = time.time()
        cos_sims: List[float] = []
        for batch_idx, (_inputs, _targets) in enumerate(
                d_loader.test(batch_size)):
            xs, zs = gen_input(_inputs, _targets)
            batch = xs.shape[0]
            xs = torch.from_numpy(xs).to(dev)
            zs = torch.from_numpy(np.asarray(zs)).to(dev)
            gen = iterative_generator(
                config.seed, f"dual_task[epoch={epoch_exp},batch={batch_idx}]")
            masks = mask_shapley(gen, batch * n_mask_samples, n_players)
            masks = masks.reshape(batch, n_mask_samples, n_players).to(dev)
            v_s, v_1 = teacher(xs, masks)
            g_cls, g_exp = inspector.grad_probe(
                m_config, model, xs,
                torch.ones((batch, n_players), dtype=torch.int32,
                           device=dev),
                v_1, surrogate_null, zs, masks, surrogate_null, v_s, v_1)
            g_cls = g_cls.float().reshape(batch, -1).cpu().numpy()
            g_exp = g_exp.float().reshape(batch, -1).cpu().numpy()
            denom = np.linalg.norm(g_cls, axis=1) \
                * np.linalg.norm(g_exp, axis=1)
            cos = (g_cls * g_exp).sum(axis=1) / np.maximum(denom, 1e-12)
            cos_sims.extend(float(c) for c in cos)
            env.log(f"  > epoch {epoch_exp} :{batch_idx}:sim // "
                    f"{np.mean(cos):.6f}, fin {len(cos_sims)}")
        arr = np.asarray(cos_sims)
        std = float(arr.std(ddof=1)) if len(arr) > 1 else 0.0
        all_epochs.append(epoch_exp)
        all_avg.append(float(arr.mean()))
        all_std.append(std)
        env.log(f"  > epoch {epoch_exp} done in "
                f"{time.time() - ts_begin:.2f}s // "
                f"cos_sim: avg {all_avg[-1]:.6f} std {all_std[-1]:.6f}")

    return MeasureDualTaskSimilarityReport(
        epochs=all_epochs, cos_sim_avg=all_avg, cos_sim_std=all_std)
