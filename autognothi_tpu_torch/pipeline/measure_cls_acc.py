"""Classifier accuracy over the explainer's epochs (port of
`autognothi_tpu/pipeline/measure_cls_acc.py`): for each retained explainer
checkpoint (filtered by the `on_exp_epochs` cadence DSL; without one, only
the last epoch), the final model is built again from it
(`conv_explainer_final`) and its argmax accuracy measured on the test set.

    python -m autognothi_tpu_torch measure_cls_acc <exp> --device cuda
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..data.loader import DatasetLoader
from ..params import from_jax_params
from ..parallel.mesh import setup_data_parallel, sharded_eval_fn
from ..utils.devices import resolve_device
from ..utils.seeding import iterative_generator
from ..utils.strings import ranged_modulo_test
from .env import ExpEnv
from .resources import (get_epoch_ckpts, get_recipe, load_cfg_dataset,
                        load_epoch_ckpt, load_epoch_params)


@dataclasses.dataclass
class MeasureClsAccReport:
    """Requires: classifier [ep], surrogate [ep], explainer [ep] | final
    [-1]."""

    epochs: List[int]
    accuracy: List[float]


def measure_cls_acc(env: ExpEnv, d_loader: Optional[DatasetLoader] = None,
                    device: str = "cuda") -> MeasureClsAccReport:
    env.log("[[[ measuring classifier accuracy ]]]")
    config = env.config
    recipe, m_config = get_recipe(config)
    if recipe.measurements is None or not recipe.measurements.allow_cls_acc:
        raise ValueError("unsupported recipe action")
    if config.eval_cls_acc is None:
        raise ValueError("the experiment config has no eval_cls_acc")
    dev = resolve_device(device)

    if d_loader is None:
        env.log("loading dataset...")
        d_loader = load_cfg_dataset(config.eval_cls_acc.dataset
                                    or config.dataset)

    m_misc = (recipe.load_misc(env.model_path, m_config)
              if recipe.load_misc else None)
    gen_input = recipe.gen_input(m_config, m_misc)
    _, cls_params = load_epoch_params(env, "classifier")
    _, srg_params = load_epoch_params(env, "surrogate")

    def measure_on(ep: int) -> bool:
        if config.eval_cls_acc.on_exp_epochs is None:
            return ep == config.train_explainer.epochs
        return ranged_modulo_test(config.eval_cls_acc.on_exp_epochs)(ep)

    mesh, place_params, place_batch = setup_data_parallel(dev)
    fw_final = sharded_eval_fn(
        lambda model, xs: recipe.fw_final(m_config, model, xs)[0], mesh,
        in_axes=(None, 0))

    env.log("[[[ measuring explainers... ]]]")
    all_epochs: List[int] = []
    all_acc: List[float] = []
    for loading_epoch in get_epoch_ckpts(env.model_path, "explainer",
                                         config.train_explainer.epochs):
        if not measure_on(loading_epoch):
            continue
        epoch_exp, exp_params = load_epoch_ckpt(
            env.model_path, "explainer", loading_epoch, required=True)
        gen = iterative_generator(config.seed,
                                  f"measure_cls_acc[epoch={epoch_exp}]")
        final_flat = recipe.conv_explainer_final(
            m_config, m_misc, cls_params, srg_params, exp_params, gen, dev)
        final_model = place_params(from_jax_params(final_flat, m_config, dev,
                                                   section="final"))

        ts_begin = time.time()
        correct, total = 0, 0
        with torch.no_grad():
            for batch_idx, (_inputs, _targets) in enumerate(
                    d_loader.test(config.train_classifier.batch_size)):
                xs, zs = gen_input(_inputs, _targets)
                probs = fw_final(final_model, place_batch(xs))
                correct += int(np.sum(np.argmax(
                    probs.float().cpu().numpy(), axis=1) == zs))
                total += xs.shape[0]
                env.log(f"  > epoch {epoch_exp} :{batch_idx}:test // "
                        f"acc: {100.0 * correct / total:.3f}%, "
                        f"{correct}/{total}")
        acc = correct / max(total, 1)
        all_epochs.append(epoch_exp)
        all_acc.append(acc)
        env.log(f"  > epoch {epoch_exp} done in "
                f"{time.time() - ts_begin:.2f}s // test_acc: {acc:.3f}")

    return MeasureClsAccReport(epochs=all_epochs, accuracy=all_acc)
