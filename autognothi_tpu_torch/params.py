"""Parameter exchange with the JAX package: flat dicts of numpy arrays
under torch-style names, stored as npz checkpoints in the same format as
`autognothi_tpu/pipeline/resources.py` (`save_params` / `load_params_file`).
A state dict saved with `torch.save` (the torch reference's checkpoints)
is read too.

With AUTOGNOTHI_CKPT_BACKEND=orbax (the JAX package's variable and value)
a checkpoint is a directory at the same path, in PyTorch's sharded format
(`torch.distributed.checkpoint`): every rank writes what it owns, a
tensor-parallel shard as its slice of the global tensor (a DTensor over its
"model" group), a pipeline stage its own tensors, a replica once.  The
directory is written as `<name>.tmp/` and renamed by rank 0 once every
rank has written, so a resume scan never sees half of one.  The two
packages' directory formats differ (Orbax is not read here: the card's
host has neither Orbax nor tensorstore); npz is the format both read and
write.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import zipfile
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .models.bert import VanillaBertConfig, vanilla_bert_model
from .models.duo_bert import DuoVanillaBertConfig, duo_bert_model
from .models.duo_vit import DuoVanillaViTConfig, duo_vit_model
from .models.froyo_bert import FroyoBertConfig, froyo_bert_model
from .models.froyo_vit import FroyoViTConfig, froyo_vit_model
from .models.ltt_bert import LttBert, LttBertConfig
from .models.kernel_shap_bert import (KernelShapBertConfig,
                                      kernel_shap_bert_model)
from .models.ltt_vit import LttViT, LttViTConfig
from .models.vit import VanillaViTConfig, vanilla_vit_model

# the model config's type -> (config, section) -> the section's module
MODELS = {LttViTConfig: LttViT, LttBertConfig: LttBert,
          VanillaViTConfig: vanilla_vit_model,
          VanillaBertConfig: vanilla_bert_model,
          FroyoViTConfig: froyo_vit_model, FroyoBertConfig: froyo_bert_model,
          DuoVanillaViTConfig: duo_vit_model,
          DuoVanillaBertConfig: duo_bert_model,
          KernelShapBertConfig: kernel_shap_bert_model}


def _host_array(v: Any) -> np.ndarray:
    """A writable copy: integer arrays as they are, any other as fp32."""
    v = np.asarray(v)
    return np.array(v, dtype=None if np.issubdtype(v.dtype, np.integer)
                    else np.float32)


def from_jax_params(flat: Mapping[str, np.ndarray], cfg: Any,
                    device: torch.device,
                    dtype: torch.dtype = torch.float32,
                    section: str = "final") -> torch.nn.Module:
    """A flat JAX parameter dict of a checkpoint section ("classifier",
    "surrogate", "explainer" or "final") -> its model (by the config's
    type, `MODELS`) on `device`, in eval mode.  Strict: every key must land
    on a parameter of the same shape, and the model must have no
    parameter the dict lacks.  Float arrays load as fp32 and are cast to
    `dtype`; integer buffers (KernelSHAP's `Xs_train`) keep their type."""
    model = MODELS[type(cfg)](cfg, section)
    state = {k: torch.from_numpy(_host_array(v)) for k, v in flat.items()}
    model.load_state_dict(state, strict=True)
    return model.to(device=device, dtype=dtype).eval()


def to_flat(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The inverse, for any section: state dict -> flat dict of numpy
    arrays under the JAX names, fp32 (integer buffers keep their type).  A
    tensor-parallel shard is gathered whole first (`parallel/tp.py`), so
    the dict is the one-device model's."""
    from .parallel.tp import gather_shard

    params = dict(model.named_parameters())
    out = {}
    for k, v in model.state_dict().items():
        v = gather_shard(params.get(k, v)).detach()
        out[k] = (v.float() if v.is_floating_point() else v).cpu().numpy()
    return out


def dir_backend() -> bool:
    """AUTOGNOTHI_CKPT_BACKEND=orbax: checkpoints are directories (the JAX
    package's switch, `pipeline/resources.py:_orbax_backend`); default
    npz."""
    return os.environ.get("AUTOGNOTHI_CKPT_BACKEND", "npz") == "orbax"


# the file that marks the port's directory checkpoint, and those of an
# Orbax one (the JAX package's)
DCP_METADATA = ".metadata"
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt", "_METADATA")

_MESHES: dict = {}


def _model_mesh(group):
    """The 1-D DeviceMesh of a tensor-parallel "model" group, made once."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if group not in _MESHES:
        kind = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
        _MESHES[group] = DeviceMesh.from_group(group, kind)
    return _MESHES[group]


def owned(t: torch.Tensor, of: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What a rank writes of a tensor into a directory checkpoint: a
    tensor-parallel shard (`parallel/tp.py`; `of`: the parameter whose
    shard `t` is shaped as, for an optimizer moment) as a DTensor over its
    "model" group, sharded along its dim, else the tensor itself."""
    from .parallel.tp import tp_shard

    shard = tp_shard(t if of is None else of)
    t = t.detach()
    if shard is None:
        return t
    from torch.distributed.tensor import DTensor, Shard

    shape = list(t.shape)
    shape[shard.dim] = shard.full
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t.contiguous(), _model_mesh(shard.group),
                              [Shard(shard.dim)], run_check=False,
                              shape=torch.Size(shape), stride=stride)


def owned_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The rank's share of a module's state dict for a directory
    checkpoint (`owned` for each tensor): no gather.  A pipeline stage's
    module holds its own tensors only."""
    params = dict(model.named_parameters())
    return {k: owned(params.get(k, v)) for k, v in model.state_dict().items()}


def remove_ckpt(path: pathlib.Path) -> None:
    """Delete a checkpoint file or directory, if there."""
    path = pathlib.Path(path)
    if path.is_dir():
        shutil.rmtree(path)
    else:
        path.unlink(missing_ok=True)


def _save_dir(file: pathlib.Path, params: Mapping[str, Any]) -> None:
    """The directory checkpoint: every rank of the world calls it with what
    it owns (tensors, DTensors or numpy arrays under the flat names);
    written into `<name>.tmp/`, then renamed by rank 0 after a barrier."""
    import torch.distributed.checkpoint as dcp

    from .parallel.distributed import barrier, is_writer, world_size

    tmp = file.with_name(file.name + ".tmp")
    if is_writer():
        remove_ckpt(tmp)
    barrier()
    state = {k: v if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.array(v)) for k, v in params.items()}
    dcp.save(state, checkpoint_id=str(tmp), no_dist=world_size() < 2)
    barrier()
    if is_writer():
        remove_ckpt(file)
        os.replace(tmp, file)
    barrier()


def save_params(file: pathlib.Path, params: Mapping[str, Any]) -> None:
    """Atomic write: a kill mid-write never leaves a truncated .ckpt.  An
    npz by default (params: numpy arrays; the caller writes it on one
    rank); a directory checkpoint under `dir_backend()`, which every rank
    calls with what it owns."""
    file = pathlib.Path(file)
    if dir_backend():
        _save_dir(file, params)
        return
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


def _load_dir(file: pathlib.Path) -> Dict[str, np.ndarray]:
    """The port's directory checkpoint -> the one-device flat dict, every
    tensor whole (tensor-parallel shards reassembled), read by this
    process alone: no collective, so every rank may call it."""
    import torch.distributed.checkpoint as dcp

    reader = dcp.FileSystemReader(str(file))
    meta = reader.read_metadata().state_dict_metadata
    state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
             for k, m in meta.items()}
    dcp.load(state, storage_reader=reader, no_dist=True)
    return {k: v.numpy() for k, v in state.items()}


def load_params_file(file: pathlib.Path) -> Dict[str, np.ndarray]:
    """A checkpoint -> flat dict of numpy arrays, its format detected: an
    npz, a state dict (or a module, whose state dict is taken) saved with
    `torch.save`, or the port's directory checkpoint (its `.metadata`
    file).  An Orbax directory (the JAX package's) raises: reading one
    needs `orbax`."""
    file = pathlib.Path(file)
    if file.is_dir():
        if (file / DCP_METADATA).exists():
            return _load_dir(file)
        if any((file / m).exists() for m in ORBAX_MARKERS):
            raise NotImplementedError(
                f"{file} is an Orbax checkpoint directory (the JAX "
                f"package's AUTOGNOTHI_CKPT_BACKEND=orbax); the port reads "
                f"npz, torch.save and its own directory checkpoints (Orbax "
                f"needs `orbax`): write the checkpoint as npz")
        raise ValueError(f"{file} is a directory but no checkpoint the port "
                         f"knows (no {DCP_METADATA})")
    if _is_torch_archive(file):
        obj = torch.load(file, map_location="cpu", weights_only=False)
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
        return {k: v.detach().cpu().numpy() for k, v in obj.items()}
    with np.load(file, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
