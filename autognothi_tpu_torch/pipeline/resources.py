"""Recipe registry, dataset dispatch and checkpoint I/O (the ported part of
`autognothi_tpu/pipeline/resources.py`).  Checkpoints are the JAX
package's: `{section}-epoch-{e}.ckpt`, an npz of the flat parameter dict,
written atomically; the newest epoch up to the section's epoch count is
the one loaded; retention keeps epoch 0, the last epoch and the epochs
matching the `ckpt_when` cadence.

With AUTOGNOTHI_CKPT_OPT=1 a trainer also writes its optimizer state
beside each epoch's parameters, `{section}-epoch-{e}.opt.ckpt` (npz with
the port's own named leaves: `count`, `mu/<name>`, `nu/<name>`), and a
resumed run reloads it, so that it is bit-identical to an uninterrupted
one; only the newest opt file is kept.  A file of the JAX package's
(optax leaves by position, `leaf_*`) is refused, never mapped."""

from __future__ import annotations

import os
import pathlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.loader import DatasetLoader, load_cv_samples
from ..params import from_jax_params, load_params_file, save_params
from ..recipes.types import ModelRecipe
from ..utils.strings import ranged_modulo_test
from .config import Config_Dataset, Config_Train, ExpConfig
from .training import AdamW


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


def get_epoch_ckpts(path: pathlib.Path, section: str,
                    max_epochs: int) -> List[int]:
    """Every checkpointed epoch of `section` up to max_epochs, ascending."""
    return [e for e in range(max_epochs + 1)
            if ckpt_path(path, section, e).exists()]


def load_epoch_ckpt(path: pathlib.Path, section: str, max_epochs: int,
                    required: bool = False
                    ) -> Tuple[Optional[int], Optional[Dict[str, np.ndarray]]]:
    """The newest checkpoint of `section` up to max_epochs -> (epoch, flat
    dict); (None, None) where there is none, or FileNotFoundError with
    `required`."""
    epoch = latest_epoch(path, section, max_epochs)
    if epoch is not None:
        return epoch, load_params_file(ckpt_path(path, section, epoch))
    if required:
        raise FileNotFoundError(
            f"no checkpoint found for '{section}' under '{path}'")
    return None, None


def _max_epochs(config: ExpConfig, section: str) -> int:
    if section == "final":
        return 0
    t_cfg = getattr(config, f"train_{section}", None) \
        if section in ("classifier", "surrogate", "explainer") else None
    if t_cfg is None:
        raise ValueError(f"the experiment config has no train_{section}")
    return t_cfg.epochs


def load_epoch_params(env, section: str
                      ) -> Tuple[int, Dict[str, np.ndarray]]:
    """Newest checkpoint of `section` as a flat dict of numpy arrays."""
    epoch = latest_epoch(env.model_path, section,
                         _max_epochs(env.config, section))
    if epoch is None:
        raise FileNotFoundError(
            f"no checkpoint found for '{section}' under '{env.model_path}'")
    return epoch, load_params_file(ckpt_path(env.model_path, section, epoch))


def load_epoch_model(env, recipe: ModelRecipe, section: str,
                     device: torch.device,
                     dtype: torch.dtype = torch.float32
                     ) -> Tuple[int, torch.nn.Module]:
    """Newest checkpoint of `section` ("classifier", "surrogate",
    "explainer" or "final"), loaded strictly onto `device` in eval mode."""
    m_config = recipe.t_config(**env.config.net.params)
    epoch, flat = load_epoch_params(env, section)
    return epoch, from_jax_params(flat, m_config, device, dtype, section)


# ------------------------------------------- optimizer-state checkpoints


def opt_ckpt_enabled() -> bool:
    """AUTOGNOTHI_CKPT_OPT=1: checkpoint the optimizer state beside the
    parameters, for a bit-identical resume (off by default: the reference
    rebuilds the moments from zero on resume)."""
    return os.environ.get("AUTOGNOTHI_CKPT_OPT", "0") == "1"


def opt_path(path: pathlib.Path, section: str, epoch: int) -> pathlib.Path:
    # not matched by `latest_epoch`'s exact-name probe
    return pathlib.Path(path) / f"{section}-epoch-{epoch}.opt.ckpt"


def save_opt_state(path: pathlib.Path, section: str, epoch: int,
                   opt: AdamW) -> None:
    """`opt`'s count and moments under their names, atomically."""
    leaves = {"count": np.asarray(opt.count, np.int64)}
    for k in opt.names:
        leaves[f"mu/{k}"] = opt.mu[k].detach().cpu().numpy()
        leaves[f"nu/{k}"] = opt.nu[k].detach().cpu().numpy()
    save_params(opt_path(path, section, epoch), leaves)


def maybe_restore_opt_state(path: pathlib.Path, section: str, epoch: int,
                            opt: AdamW) -> AdamW:
    """Exact resume: load the optimizer state saved at `epoch` into `opt`
    (the freshly built one, in place).  A no-op when AUTOGNOTHI_CKPT_OPT is
    off, at epoch 0, or without an opt file.  Raises where the file's
    names or shapes are not `opt`'s, and for a JAX-written file."""
    file = opt_path(path, section, epoch)
    if not opt_ckpt_enabled() or epoch <= 0 or not file.exists():
        return opt
    arrays = load_params_file(file)
    if any(k.startswith("leaf_") for k in arrays):
        raise ValueError(
            f"optimizer checkpoint {file.name} was written by the JAX "
            f"package (optax leaves by position); the port reads only its "
            f"own named moments: delete it to resume with fresh moments")
    want = {"count", *(f"{m}/{k}" for m in ("mu", "nu") for k in opt.names)}
    if set(arrays) != want:
        raise ValueError(
            f"optimizer checkpoint {file.name} holds other parameters than "
            f"the rebuilt optimizer (missing {sorted(want - set(arrays))}, "
            f"extra {sorted(set(arrays) - want)}): the config or freeze "
            f"rules changed since it was written; delete it to resume with "
            f"fresh moments")
    for k in opt.names:
        for m, store in (("mu", opt.mu), ("nu", opt.nu)):
            got = arrays[f"{m}/{k}"]
            if got.shape != tuple(store[k].shape):
                raise ValueError(
                    f"optimizer checkpoint {file.name}: {m}/{k} has shape "
                    f"{got.shape}, expected {tuple(store[k].shape)}")
            with torch.no_grad():
                store[k].copy_(torch.from_numpy(got))
    opt.count = int(arrays["count"])
    return opt


def save_epoch_ckpt(path: pathlib.Path, section: str, cfg: Config_Train,
                    epoch: int, params: Mapping[str, np.ndarray],
                    opt: Optional[AdamW] = None) -> None:
    """Save atomically, then delete the previous epoch's file unless the
    retention keeps it (epoch 0, the last epoch, the `ckpt_when` cadence).
    With AUTOGNOTHI_CKPT_OPT=1 and an `opt`, its state is saved beside the
    parameters, and the previous epoch's opt file goes whatever the
    retention: a resume only ever continues from the newest epoch."""
    path = pathlib.Path(path)
    save_params(ckpt_path(path, section, epoch), params)
    if opt is not None and opt_ckpt_enabled():
        save_opt_state(path, section, epoch, opt)
    prev = epoch - 1
    if not (prev == 0 or prev == cfg.epochs
            or ranged_modulo_test(cfg.ckpt_when)(prev)):
        ckpt_path(path, section, prev).unlink(missing_ok=True)
    opt_path(path, section, prev).unlink(missing_ok=True)
