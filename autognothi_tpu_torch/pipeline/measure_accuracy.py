"""Masked accuracy: the surrogate's accuracy against the number of masked
players (port of `autognothi_tpu/pipeline/measure_accuracy.py`).

    python -m autognothi_tpu_torch measure_accuracy <exp> --device cuda

At `resolution` counts spread over [0, n_players] (`np.linspace`, int64),
each test batch gets masks with exactly that many players off, at
positions drawn by `mask_uniform_selective` from a CPU generator seeded
with `derive_seed(seed, "measure_accuracy[mask=<n>,batch=<i>]")`, so a run
on the card and one on the CPU draw the same masks.  (The JAX package
draws from `jax.random` under the same key name; its masks are not these.)
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..data.loader import DatasetLoader
from ..ops.shapley import mask_uniform_selective
from ..parallel.mesh import setup_data_parallel, sharded_eval_fn
from ..utils.devices import resolve_device
from ..utils.seeding import iterative_generator
from .env import ExpEnv
from .resources import (get_recipe, load_cfg_dataset, load_epoch_model,
                        load_misc)


@dataclasses.dataclass
class MeasureAccuracyReport:
    """Surrogate accuracy at `resolution` masked-player counts spread over
    [0, n_players].  Requires: surrogate [ep]."""

    masked_players: List[int]
    accuracy: List[float]


def measure_accuracy(env: ExpEnv, d_loader: Optional[DatasetLoader] = None,
                     device: str = "cuda") -> MeasureAccuracyReport:
    env.log("[[[ measuring model accuracy ]]]")
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.measurements.allow_accuracy:
        raise ValueError("unsupported recipe action")
    if config.eval_accuracy is None:
        raise ValueError("the experiment config has no eval_accuracy")
    dev = resolve_device(device)

    if d_loader is None:
        env.log("loading dataset...")
        d_loader = load_cfg_dataset(config.eval_accuracy.dataset
                                    or config.dataset)

    m_misc = load_misc(env, recipe, m_config)
    n_players = recipe.n_players(m_config)
    gen_input = recipe.gen_input(m_config, m_misc)
    _, srg_model = load_epoch_model(env, recipe, "surrogate", dev)

    mesh, place_params, place_batch = setup_data_parallel(dev)
    srg_model = place_params(srg_model)
    fwd = sharded_eval_fn(
        lambda model, xs, mask: recipe.fw_surrogate(m_config, model, xs,
                                                    mask)[0],
        mesh, in_axes=(None, 0, 0))

    env.log("[[[ measuring surrogate... ]]]")
    all_masked = np.linspace(0, n_players, config.eval_accuracy.resolution,
                             dtype=np.int64).tolist()
    all_acc: List[float] = []
    for n_masked in all_masked:
        ts_begin = time.time()
        correct, total = 0, 0
        with torch.no_grad():
            for batch_idx, (_inputs, _targets) in enumerate(
                    d_loader.test(config.train_surrogate.batch_size)):
                xs, zs = gen_input(_inputs, _targets)
                batch = xs.shape[0]
                gen = iterative_generator(
                    config.seed,
                    f"measure_accuracy[mask={n_masked},batch={batch_idx}]")
                mask = mask_uniform_selective(gen, batch, n_players,
                                              int(n_masked))
                probs = fwd(srg_model, place_batch(xs), place_batch(mask))
                correct += int(np.sum(np.argmax(
                    probs.float().cpu().numpy(), axis=1) == zs))
                total += batch
                env.log(f"  > mask {n_masked} :{batch_idx}:test // "
                        f"acc: {100.0 * correct / total:.3f}%, "
                        f"{correct}/{total}")
        acc = correct / max(total, 1)
        all_acc.append(acc)
        env.log(f"  > mask {n_masked} done in "
                f"{time.time() - ts_begin:.2f}s // test_acc: {acc:.3f}")

    return MeasureAccuracyReport(masked_players=all_masked, accuracy=all_acc)
