"""Parameter exchange with the JAX package: flat dicts of numpy arrays
under torch-style names, stored as npz checkpoints in the same format as
`autognothi_tpu/pipeline/resources.py` (`save_params` / `load_params_file`).
"""

from __future__ import annotations

import os
import pathlib
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


def load_params_file(file: pathlib.Path) -> Dict[str, np.ndarray]:
    """An npz checkpoint -> flat dict.  (Torch archives and Orbax
    directories are not read by the port yet.)"""
    with np.load(file, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
