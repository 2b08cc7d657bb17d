"""Parameter exchange with the JAX package: flat dicts of numpy arrays
under torch-style names, stored as npz checkpoints in the same format as
`autognothi_tpu/pipeline/resources.py` (`save_params` / `load_params_file`).
A state dict saved with `torch.save` (the torch reference's checkpoints)
is read too; an Orbax directory is not (it needs `orbax`).
"""

from __future__ import annotations

import os
import pathlib
import zipfile
from typing import Dict, Mapping, Union

import numpy as np
import torch

from .models.ltt_bert import LttBert, LttBertConfig
from .models.ltt_vit import LttViT, LttViTConfig

MODELS = {LttViTConfig: LttViT, LttBertConfig: LttBert}


def from_jax_params(flat: Mapping[str, np.ndarray],
                    cfg: Union[LttViTConfig, LttBertConfig],
                    device: torch.device,
                    dtype: torch.dtype = torch.float32,
                    section: str = "final") -> torch.nn.Module:
    """A flat JAX parameter dict of a checkpoint section ("surrogate",
    "explainer" or "final") -> its LTT ViT or LTT BERT model (by the
    config's type) on `device`, in eval mode.  Strict: every key must land
    on a parameter of the same shape, and the model must have no
    parameter the dict lacks."""
    model = MODELS[type(cfg)](cfg, section)
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
             for k, v in flat.items()}
    model.load_state_dict(state, strict=True)
    return model.to(device=device, dtype=dtype).eval()


def to_flat(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The inverse, for any section: state dict -> flat dict of fp32 numpy
    arrays under the JAX names."""
    return {k: v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}


def save_params(file: pathlib.Path, params: Mapping[str, np.ndarray]) -> None:
    """Atomic npz write: a kill mid-write never leaves a truncated .ckpt."""
    file = pathlib.Path(file)
    tmp = file.with_name(file.name + ".tmp")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in params.items()})
        os.replace(tmp, file)
    finally:
        tmp.unlink(missing_ok=True)


def _is_torch_archive(file: pathlib.Path) -> bool:
    """npz and torch checkpoints are both zip files; torch's carries a
    `data.pkl` entry (`autognothi_tpu/pipeline/resources.py:224-233`)."""
    if not zipfile.is_zipfile(file):
        return False
    with zipfile.ZipFile(file) as z:
        return any(name.endswith("data.pkl") for name in z.namelist())


def load_params_file(file: pathlib.Path) -> Dict[str, np.ndarray]:
    """A checkpoint -> flat dict of numpy arrays: an npz, or a state dict
    (or a module, whose state dict is taken) saved with `torch.save`.  An
    Orbax directory raises: reading one needs `orbax`."""
    file = pathlib.Path(file)
    if file.is_dir():
        raise NotImplementedError(
            f"{file} is an Orbax checkpoint directory; the port reads npz "
            f"and torch.save checkpoints only (Orbax needs `orbax`)")
    if _is_torch_archive(file):
        obj = torch.load(file, map_location="cpu", weights_only=False)
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
        return {k: v.detach().cpu().numpy() for k, v in obj.items()}
    with np.load(file, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
