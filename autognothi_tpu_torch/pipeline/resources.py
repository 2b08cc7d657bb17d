"""Recipe registry, dataset dispatch and checkpoint I/O (the ported part of
`autognothi_tpu/pipeline/resources.py`).  Checkpoints are the JAX
package's: `{section}-epoch-{e}.ckpt`, an npz of the flat parameter dict,
written atomically; the newest epoch up to the section's epoch count is
the one loaded; retention keeps epoch 0, the last epoch and the epochs
matching the `ckpt_when` cadence."""

from __future__ import annotations

import os
import pathlib
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.loader import DatasetLoader, load_cv_samples
from ..params import from_jax_params, load_params_file, save_params
from ..recipes.types import ModelRecipe
from ..utils.strings import ranged_modulo_test
from .config import Config_Dataset, Config_Train, ExpConfig


def get_recipe(config: ExpConfig) -> Tuple[ModelRecipe, Any]:
    """-> (recipe, the model config built from `net.params`)."""
    if config.net.kind == "ltt_vit":
        from ..recipes.ltt_vit import ltt_vit_recipe

        recipe = ltt_vit_recipe()
    elif config.net.kind == "ltt_bert":
        from ..recipes.ltt_bert import ltt_bert_recipe

        recipe = ltt_bert_recipe()
    else:
        raise NotImplementedError(
            f"net kind {config.net.kind!r} is not ported yet")
    if config.net.version != recipe.version:
        raise ValueError(
            f"mismatch recipe version: (config) {config.net.version} != "
            f"(code) {recipe.version}")
    return recipe, recipe.t_config(**config.net.params)


def load_cfg_dataset(cfg: Optional[Config_Dataset]) -> DatasetLoader:
    """The experiment's dataset; only the offline `cv_samples` set is
    ported."""
    if cfg is None:
        raise ValueError("the experiment config has no dataset block")
    if cfg.kind != "cv_samples":
        raise NotImplementedError(
            f"dataset kind {cfg.kind!r} is not ported yet (ported: "
            f"cv_samples)")
    f = cfg.fields
    return load_cv_samples(
        train_size=int(f["train_size"]), test_size=int(f["test_size"]),
        img_px_size=int(f["img_px_size"]),
        num_classes=int(f["num_classes"]), seed=int(f.get("seed", 1234)))


# --------------------------------------------------------- checkpoint I/O


def ckpt_path(path: pathlib.Path, section: str, epoch: int) -> pathlib.Path:
    return pathlib.Path(path) / f"{section}-epoch-{epoch}.ckpt"


def latest_epoch(path: pathlib.Path, section: str,
                 max_epochs: int) -> Optional[int]:
    """Newest checkpointed epoch <= max_epochs (an existence probe)."""
    for epoch in range(max_epochs, -1, -1):
        if ckpt_path(path, section, epoch).exists():
            return epoch
    return None


def _max_epochs(config: ExpConfig, section: str) -> int:
    if section == "final":
        return 0
    if section == "explainer":
        return config.train_explainer.epochs
    if section == "surrogate":
        raw = config.raw.get("train_surrogate")
        if raw is None:
            raise ValueError("the experiment config has no train_surrogate")
        return int(raw["epochs"])
    raise NotImplementedError(
        f"loading the {section!r} section is not ported yet")


def load_epoch_model(env, recipe: ModelRecipe, section: str,
                     device: torch.device,
                     dtype: torch.dtype = torch.float32
                     ) -> Tuple[int, torch.nn.Module]:
    """Newest checkpoint of `section` ("surrogate", "explainer" or
    "final"), loaded strictly onto `device` in eval mode."""
    m_config = recipe.t_config(**env.config.net.params)
    epoch = latest_epoch(env.model_path, section,
                         _max_epochs(env.config, section))
    if epoch is None:
        raise FileNotFoundError(
            f"no checkpoint found for '{section}' under '{env.model_path}'")
    flat = load_params_file(ckpt_path(env.model_path, section, epoch))
    return epoch, from_jax_params(flat, m_config, device, dtype, section)


def refuse_opt_ckpt() -> None:
    """AUTOGNOTHI_CKPT_OPT=1 asks for the optimizer state beside the
    parameters (exact resume); the port does not write it yet, so a
    trainer refuses before it trains."""
    if os.environ.get("AUTOGNOTHI_CKPT_OPT", "0") == "1":
        raise NotImplementedError(
            "AUTOGNOTHI_CKPT_OPT=1 (optimizer-state checkpoints) is not "
            "ported yet")


def save_epoch_ckpt(path: pathlib.Path, section: str, cfg: Config_Train,
                    epoch: int, params: Mapping[str, np.ndarray]) -> None:
    """Save atomically, then delete the previous epoch's file unless the
    retention keeps it (epoch 0, the last epoch, the `ckpt_when` cadence)."""
    path = pathlib.Path(path)
    save_params(ckpt_path(path, section, epoch), params)
    prev = epoch - 1
    if not (prev == 0 or prev == cfg.epochs
            or ranged_modulo_test(cfg.ckpt_when)(prev)):
        ckpt_path(path, section, prev).unlink(missing_ok=True)
