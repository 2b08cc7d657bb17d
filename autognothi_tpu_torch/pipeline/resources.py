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

import importlib
import os
import pathlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.loader import (CvTransforms, DatasetLoader, load_cv_samples,
                           load_imagenette, load_nlp_samples,
                           load_yelp_polarity, load_yelp_polarity_mini)
from ..parallel.distributed import barrier, is_writer
from ..params import (dir_backend, from_jax_params, load_params_file,
                      owned, remove_ckpt, save_params)
from ..recipes.types import ModelRecipe
from ..utils.strings import ranged_modulo_test
from .config import (NET_KINDS, Config_Dataset, Config_Train,
                     ExpConfig)
from .training import AdamW


def get_recipe(config: ExpConfig) -> Tuple[ModelRecipe, Any]:
    """-> (recipe, the model config built from `net.params`): the recipe
    of net kind <kind> is `recipes/<kind>.py:<kind>_recipe()`."""
    kind = config.net.kind
    if kind not in NET_KINDS:
        raise ValueError(f"unknown net kind {kind!r}")
    recipe = getattr(importlib.import_module(f"..recipes.{kind}",
                                             __package__),
                     f"{kind}_recipe")()
    if config.net.version != recipe.version:
        raise ValueError(
            f"mismatch recipe version: (config) {config.net.version} != "
            f"(code) {recipe.version}")
    return recipe, recipe.t_config(**config.net.params)


DATASET_KINDS = ("cv_samples", "nlp_samples", "yelp_polarity_mini",
                 "yelp_polarity", "imagenette")


def load_misc(env, recipe: ModelRecipe, m_config: Any) -> Any:
    """The recipe's `misc` for the experiment (the BERT recipes' tokenizer,
    `<exp>/tokenizer/`); None for a recipe without one."""
    if recipe.load_misc is None:
        return None
    return recipe.load_misc(env.model_path, m_config)


def load_id_dataset(kind: str,
                    img_px_size: Optional[int] = None) -> DatasetLoader:
    """A dataset named on the command line (`--dataset`), at the JAX
    package's sizes (`:84-102`): the whole of `yelp_polarity` and of
    `imagenette` (resized to the model's `img_px_size`), test seed 42;
    `cv_samples` at its defaults and the model's `img_px_size`."""
    if kind == "nlp_samples":
        return load_nlp_samples()
    if kind == "yelp_polarity_mini":
        return load_yelp_polarity_mini()
    if kind == "yelp_polarity":
        return load_yelp_polarity(train_size=560000, test_size=38000,
                                  test_seed=42)
    if kind in ("imagenette", "cv_samples") and img_px_size is None:
        raise ValueError(f"dataset {kind!r} needs the model's img_px_size")
    if kind == "imagenette":
        return load_imagenette(
            train_size=9469, test_size=3925, test_seed=42,
            transforms=CvTransforms(resize={"height": img_px_size,
                                            "width": img_px_size}))
    if kind == "cv_samples":
        return load_cv_samples(img_px_size=img_px_size)
    raise ValueError(f"unknown dataset kind: {kind}")


def load_cfg_dataset(cfg: Optional[Config_Dataset]) -> DatasetLoader:
    """The experiment's dataset (`:105-130`)."""
    if cfg is None:
        raise ValueError("the experiment config has no dataset block")
    f = cfg.fields
    if cfg.kind == "cv_samples":
        return load_cv_samples(
            train_size=int(f["train_size"]), test_size=int(f["test_size"]),
            img_px_size=int(f["img_px_size"]),
            num_classes=int(f["num_classes"]),
            seed=int(f.get("seed", 1234)))
    if cfg.kind == "nlp_samples":
        return load_nlp_samples()
    if cfg.kind == "yelp_polarity_mini":
        return load_yelp_polarity_mini()
    if cfg.kind == "yelp_polarity":
        return load_yelp_polarity(train_size=int(f["train_size"]),
                                  test_size=int(f["test_size"]),
                                  test_seed=int(f["test_seed"]))
    if cfg.kind == "imagenette":
        return load_imagenette(train_size=int(f["train_size"]),
                               test_size=int(f["test_size"]),
                               test_seed=int(f["test_seed"]),
                               transforms=f["transforms"])
    raise ValueError(f"unknown dataset kind {cfg.kind!r} (known: "
                     f"{', '.join(DATASET_KINDS)})")


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
    """`opt`'s count and moments under their names, atomically.  Under the
    directory backend every rank calls it with its own `opt`, and a
    moment of a tensor-parallel shard is written as that shard."""
    leaves = {"count": np.asarray(opt.count, np.int64)}
    for k in opt.names:
        for m, store in (("mu", opt.mu), ("nu", opt.nu)):
            leaves[f"{m}/{k}"] = (
                owned(store[k], of=opt.params[k]) if dir_backend()
                else store[k].detach().cpu().numpy())
    save_params(opt_path(path, section, epoch), leaves)


def maybe_restore_opt_state(path: pathlib.Path, section: str, epoch: int,
                            opt: AdamW, names: Optional[list] = None,
                            take: Optional[Callable] = None) -> AdamW:
    """Exact resume: load the optimizer state saved at `epoch` into `opt`
    (the freshly built one, in place).  A no-op when AUTOGNOTHI_CKPT_OPT is
    off, at epoch 0, or without an opt file.  Raises where the file's
    names or shapes are not `opt`'s, and for a JAX-written file.  A
    pipeline stage holds part of the moments: `names` are the file's
    (default `opt.names`), and `take(name, array)` cuts a moment to the
    rank's tensor-parallel shard."""
    file = opt_path(path, section, epoch)
    if not opt_ckpt_enabled() or epoch <= 0 or not file.exists():
        return opt
    arrays = load_params_file(file)
    if any(k.startswith("leaf_") for k in arrays):
        raise ValueError(
            f"optimizer checkpoint {file.name} was written by the JAX "
            f"package (optax leaves by position); the port reads only its "
            f"own named moments: delete it to resume with fresh moments")
    want = {"count", *(f"{m}/{k}" for m in ("mu", "nu")
                       for k in (opt.names if names is None else names))}
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
            if take is not None:
                got = np.ascontiguousarray(take(k, got))
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
    retention: a resume only ever continues from the newest epoch.  In a
    world of ranks, rank 0 writes and every rank waits for it; under the
    directory backend (AUTOGNOTHI_CKPT_BACKEND=orbax) every rank writes
    its own share (`params`: what `training.ckpt_of` gives it), and rank 0
    alone deletes, behind a barrier."""
    path = pathlib.Path(path)
    if dir_backend() or is_writer():
        save_params(ckpt_path(path, section, epoch), params)
        if opt is not None and opt_ckpt_enabled():
            save_opt_state(path, section, epoch, opt)
    if is_writer():
        prev = epoch - 1
        if not (prev == 0 or prev == cfg.epochs
                or ranged_modulo_test(cfg.ckpt_when)(prev)):
            remove_ckpt(ckpt_path(path, section, prev))
        remove_ckpt(opt_path(path, section, prev))
    barrier()
