"""The device mesh and its sharding rules (port of `autognothi_tpu/parallel/
mesh.py`) on `torch.distributed`, one process per device.

- The world: the ranks of the default process group
  (`parallel/distributed.py`); rank r computes on `cuda:{local_rank}`.
  Without AUTOGNOTHI_DIST_* the world is one process on one device,
  `setup_data_parallel` returns no mesh and every path is the one-device
  path, bit for bit.
- The mesh: `make_mesh` is a `torch.distributed.device_mesh.DeviceMesh`
  of shape (world / model, model) over ("data", "model"); a "model" group
  is model consecutive ranks, as the JAX package reshapes its devices.
  With a "pipe" axis (`parallel/pipeline.py:make_pipe_mesh`) it is
  ("data", "pipe") or ("data", "pipe", "model").
- Data parallelism: every rank holds the whole (global) batch, as loaded
  from the same data, and the sharded functions take its rows along
  "data" (`data_rows`): `sharded_call` runs a function on the rank's rows
  and all-gathers its outputs, the train steps reduce their gradients.
  A batch that does not divide the data axis runs whole on every rank,
  in pallas mode "0" (`sharded_eval_fn`, as the JAX package's ragged
  fallback), so every rank decides alike and no collective is skipped.
- Tensor parallelism: `shard_params` keeps each rank's slice of the
  Megatron-sharded weights (`param_pspec`) and the plain layers run the
  f/g pair over the "model" group (`parallel/tp.py`).

One departure from the JAX package: one JAX process meshes every chip of
its host, one process of the port uses one card, and N cards take N
processes (AUTOGNOTHI_DIST_* or torchrun).
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.common import pallas_override
from .distributed import world_size
from .tp import TpShard

Spec = Tuple[Optional[str], ...]


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              pipe: int = 1):
    """DeviceMesh over ("data", "model") of the world's ranks;
    model_parallel=1 is pure data (coalition) parallelism.  With `pipe`
    past 1 the mesh is ("data", "pipe"), or ("data", "pipe", "model") when
    model_parallel > 1, "model" innermost (the pipeline-parallel mesh of
    `parallel/pipeline.py:make_pipe_mesh`)."""
    from torch.distributed.device_mesh import init_device_mesh

    visible = world_size()
    n = n_devices or visible
    if n % (pipe * model_parallel) != 0:
        raise ValueError(
            f"{n} devices not divisible by model={model_parallel}"
            if pipe == 1 else
            f"{n} devices not divisible by pipe={pipe}"
            + (f" x model={model_parallel}" if model_parallel > 1 else ""))
    if n > visible:
        raise ValueError(
            f"requested a {n}-device mesh but only {visible} device(s) "
            "are visible — shrink the mesh or start one process per device "
            "(AUTOGNOTHI_DIST_* or torchrun)")
    if n != visible:
        raise ValueError(
            f"a {n}-device mesh in a world of {visible} processes: the mesh "
            "spans every rank of the world (one process per device)")
    if not dist.is_initialized():
        raise ValueError("a mesh needs an initialized process group "
                         "(parallel.distributed.maybe_initialize_distributed)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if pipe == 1:
        shape, names = ((n // model_parallel, model_parallel),
                        ("data", "model"))
    elif model_parallel == 1:
        shape, names = (n // pipe, pipe), ("data", "pipe")
    else:
        shape, names = ((n // (pipe * model_parallel), pipe, model_parallel),
                        ("data", "pipe", "model"))
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    """The size of a mesh axis, 1 for an axis the mesh lacks; `mesh` is a
    DeviceMesh or a mapping of the axis sizes."""
    if isinstance(mesh, Mapping):
        return int(mesh.get(axis, 1))
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


# ---------------------------------------------------------- param shardings

_TP_OUT_FEATURES = (
    # torch-layout (out, in) weights whose OUT features shard over "model"
    "attention.self.query.weight",
    "attention.self.key.weight",
    "attention.self.value.weight",
    "intermediate.dense.weight",
)
_TP_OUT_BIAS = (
    "attention.self.query.bias",
    "attention.self.key.bias",
    "attention.self.value.bias",
    "intermediate.dense.bias",
)
_TP_IN_FEATURES = (
    # (out, in) weights whose IN features shard over "model" (row parallel)
    "attention.output.dense.weight",
    "output.dense.weight",
)


def param_pspec(name: str, ndim: int) -> Spec:
    """Megatron partition spec of a flat parameter name, one entry per dim
    ("model" or None; all None = replicated).  Biases of row-parallel
    layers stay replicated."""
    for suffix in _TP_OUT_FEATURES:
        if name.endswith(suffix):
            return ("model", None)
    for suffix in _TP_OUT_BIAS:
        if name.endswith(suffix):
            return ("model",)
    for suffix in _TP_IN_FEATURES:
        if name.endswith(suffix):
            return (None, "model")
    return (None,) * ndim


def check_shardable(items, mesh) -> None:
    """Fail closed (one ValueError naming EVERY offending weight) when a
    sharded dim does not divide its mesh axis: a weight is never padded.
    `items`: iterable of (name, shape, spec)."""
    bad = []
    for name, shape, spec in items:
        for dim, axis in zip(shape, spec):
            if axis is not None and dim % axis_size(mesh, axis) != 0:
                bad.append(f"{name}: shape {tuple(shape)} cannot shard "
                           f"{spec} over {axis}={axis_size(mesh, axis)}")
    if bad:
        raise ValueError(
            "tensor-parallel sharding does not divide the mesh — pick a "
            "model_parallel that divides these dims:\n  " + "\n  ".join(bad))


def shard_params(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Keep, in place, this rank's slice of every parameter `param_pspec`
    shards, tagged with its `TpShard` (the plain layers then run tensor-
    parallel); the rest stays replicated.  Fails closed through
    `check_shardable`.  A mesh without a "model" axis past 1 leaves the
    model as it is."""
    named = dict(model.named_parameters())
    check_shardable(((k, tuple(p.shape), param_pspec(k, p.dim()))
                     for k, p in named.items()), mesh)
    size = axis_size(mesh, "model")
    if size == 1:
        return model
    group = mesh.get_group("model")
    index = mesh.get_local_rank("model")
    for name, p in named.items():
        spec = param_pspec(name, p.dim())
        if "model" not in spec:
            continue
        dim = spec.index("model")
        full = p.shape[dim]
        with torch.no_grad():
            p.data = p.data.narrow(dim, index * (full // size),
                                   full // size).contiguous()
        p.tp_shard = TpShard(group, size, index, dim, full)
    return model


def replicate_params(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Every rank's copy of the model's tensors made rank 0's, bit for bit
    (one broadcast per tensor over the world)."""
    del mesh
    with torch.no_grad():
        for t in model.state_dict().values():
            dist.broadcast(t, src=0)
    return model


def data_rows(mesh, batch: int) -> Optional[slice]:
    """This rank's rows of a global batch along "data", or None when the
    batch does not divide the data axis (or is smaller than it): then it
    runs whole on every rank."""
    if mesh is None:
        return None
    n = axis_size(mesh, "data")
    if n == 1 or batch % n or batch < n:
        return None
    r = mesh.get_local_rank("data")
    return slice(r * (batch // n), (r + 1) * (batch // n))


def shard_batch(tree, mesh):
    """This rank's rows (along dim 0, over "data") of every tensor."""

    def take(x):
        x = torch.as_tensor(x)
        rows = data_rows(mesh, x.shape[0])
        if rows is None:
            raise ValueError(f"batch of {x.shape[0]} rows cannot shard over "
                             f"data={axis_size(mesh, 'data')}")
        return x[rows]

    return _tree_map(take, tree)


def setup_data_parallel(device: torch.device):
    """Trainer and report helper -> (mesh, place_params, place_batch).  In a
    world of one process: (None, move to `device`, tensor on `device`).
    Past one: a pure data mesh over the world, place_params moves the
    model to `device` and makes every rank's copy rank 0's
    (`replicate_params`), place_batch puts the WHOLE batch on `device`
    (the sharded functions take their rows)."""

    def place_batch(x: Any) -> torch.Tensor:
        return torch.as_tensor(x).to(device)

    if world_size() < 2:
        return None, (lambda model: model.to(device)), place_batch
    mesh = make_mesh(world_size(), model_parallel=1)

    def place_params(model: torch.nn.Module) -> torch.nn.Module:
        return replicate_params(model.to(device), mesh)

    return mesh, place_params, place_batch


# ------------------------------------------------------- sharded functions


def _tree_map(fn: Callable, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def gather_rows(x: torch.Tensor, mesh, axis: int = 0) -> torch.Tensor:
    """All-gather each rank's `x` over "data" and concatenate along `axis`
    in rank order (the inverse of `data_rows`)."""
    return gather_in(x, mesh.get_group("data"), axis_size(mesh, "data"),
                     axis)


def gather_in(x: torch.Tensor, group, n: int, axis: int = 0) -> torch.Tensor:
    """`gather_rows` over any group of n ranks."""
    if x.dim() <= axis:
        raise ValueError(
            f"sharded_call: output shape {tuple(x.shape)} cannot be gathered "
            f"along axis {axis} over {n} devices — returning it as it is "
            "would silently give one rank's local value; restructure the "
            "output or pass out_axes=None if it is provably identical on "
            "every rank")
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=axis)


def sharded_call(fn: Callable, mesh, in_axes: Sequence[Optional[int]],
                 out_axes: Optional[int] = 0) -> Callable:
    """`fn(*args)` with each rank on its slice of the arguments along "data"
    (the generic form of `sharded_serving_fn`, for the report sweeps).

    in_axes: one entry per positional argument, an axis to split or None
    to pass whole (a module, a replicated tensor).  Every output is
    all-gathered along `out_axes`, so each rank holds the global result;
    an output without that axis raises (it would be one rank's value).
    out_axes=None returns the rank's outputs as they are, for outputs that
    are provably identical on every rank.  A split dim that does not
    divide the mesh raises (`sharded_eval_fn` is the ragged fallback).
    The kernels run per rank, on the rank's rows."""
    n = axis_size(mesh, "data")
    r = mesh.get_local_rank("data")

    def take(a, ax):
        if ax is None:
            return a
        size = a.shape[ax]
        if size % n or size < n:
            raise ValueError(f"sharded_call: argument dim {ax} of shape "
                             f"{tuple(a.shape)} does not divide over {n} "
                             "devices")
        return a.narrow(ax, r * (size // n), size // n)

    def call(*args):
        outs = fn(*(take(a, ax) for a, ax in zip(args, in_axes)))
        if out_axes is None:
            return outs
        return _tree_map(lambda o: gather_rows(o, mesh, out_axes), outs)

    return call


def _shardable(args, in_axes, n: int) -> bool:
    return all(ax is None or (a.dim() > ax and a.shape[ax] % n == 0
                              and a.shape[ax] >= n)
               for a, ax in zip(args, in_axes))


def sharded_eval_fn(fn: Callable, mesh, in_axes: Sequence[Optional[int]],
                    out_axes: Optional[int] = 0) -> Callable:
    """`sharded_call` with the ragged fallback.  mesh None -> `fn` (one
    device, the kernels on).  With a mesh, a batch that divides it runs
    per rank (kernels included); a ragged one runs whole on every rank in
    pallas mode "0" (the plain math, as the JAX package's fallback)."""
    if mesh is None:
        return fn
    n = axis_size(mesh, "data")
    call = sharded_call(fn, mesh, in_axes, out_axes)

    def wrapped(*args):
        if not _shardable(args, in_axes, n):
            with pallas_override("0"):
                return fn(*args)
        return call(*args)

    return wrapped


def sharded_serving_fn(fn: Callable, mesh) -> Callable:
    """`fn(model, xs) -> outputs` with each rank on its rows of xs and the
    outputs all-gathered along dim 0: one all-gather per output, no other
    collective, the kernels per rank."""
    return sharded_call(fn, mesh, in_axes=(None, 0), out_axes=0)


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> list:
    """Sum each tensor over `group` in one all-reduce (the tensors
    flattened into one buffer) -> the summed tensors."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def pad_to_multiple(arr: np.ndarray, multiple: int,
                    axis: int = 0) -> np.ndarray:
    """Edge-pad `axis` up to a multiple (fixed shapes for the mesh)."""
    size = arr.shape[axis]
    target = ((size + multiple - 1) // multiple) * multiple
    if target == size:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - size)
    return np.pad(arr, pad, mode="edge")

