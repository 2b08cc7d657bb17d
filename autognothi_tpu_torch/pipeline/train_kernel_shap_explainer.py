"""KernelSHAP "trainer" (port of `autognothi_tpu/pipeline/
train_kernel_shap_explainer.py`): k-means over the training set's token
rows on the host (`ops/kernel_shap.py:kmeans_compress`), the centres
stored as the explainer's background `Xs_train` at the last explainer
epoch.  `train_explainer` dispatches here for the KernelSHAP recipe.

The centres are stored as int32, as the JAX package stores them (its
int64 centres become int32 without x64).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..ops.kernel_shap import kmeans_compress
from ..utils.devices import resolve_device
from .env import ExpEnv
from .resources import (get_recipe, load_cfg_dataset, load_epoch_params,
                        load_misc, save_epoch_ckpt)


def train_kernel_shap_explainer(env: ExpEnv, device: str = "cuda") -> None:
    config = env.config
    recipe, m_config = get_recipe(config)
    resolve_device(device)  # the verb's device check; k-means runs here
    t_cfg = config.train_explainer
    if t_cfg is None:
        raise ValueError("the experiment config has no train_explainer")
    d_loader = load_cfg_dataset(config.dataset)
    gen_input = recipe.gen_input(m_config, load_misc(env, recipe, m_config))

    epoch_exp, exp_params = load_epoch_params(env, "explainer")
    if epoch_exp >= t_cfg.epochs:
        env.log("[[[ explainer already trained ]]]")
        return

    env.log("> loading data...")
    all_xs: List[np.ndarray] = []
    for _inputs, _targets in d_loader.train(t_cfg.batch_size):
        xs, _zs = gen_input(_inputs, _targets)
        all_xs.append(np.asarray(xs))
    data = np.concatenate(all_xs, axis=0)
    env.log(f"> received bulk data: {data.shape}")

    centers, _weights = kmeans_compress(
        data, m_config.kernel_shap_data_size, seed=config.seed)
    env.log(f"> compressed data: {centers.shape}")

    exp_params = dict(exp_params)
    exp_params["Xs_train"] = centers.astype(np.int32)
    env.log("> loaded precomputed parameters")
    save_epoch_ckpt(env.model_path, "explainer", t_cfg, t_cfg.epochs,
                    exp_params)
    env.flush_cfg()
