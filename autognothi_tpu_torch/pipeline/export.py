"""Export of the trained final model to one artifact (port of
`autognothi_tpu/pipeline/export.py`).

`export_final` writes the final model (prediction and Shapley
attributions), program and trained weights, into ONE file that a process
loads and calls without the model code or the checkpoints:

    python -m autognothi_tpu_torch export_final <exp> --into final.agx \\
        --batch-size 8 --device cuda

    from autognothi_tpu_torch.pipeline.export import load_exported
    fw = load_exported("final.agx", device="cuda")
    probs, attr = fw(xs)          # <batch, ...> input, as pipeline/serve.py

The artifact: the port's magic, the length of the program, the bytes of
`torch.export.save` of the serving forward, then a JSON header (the
metadata `export_final` returns).  The program holds the final's
parameters as lifted parameters: inputs of its graph that the loaded
module feeds from its state, never constants, so nothing derived from a
weight (an int8 weight code, a packed float weight) is folded on the
host; each is an op of the program, computed from the weights at every
call (`ops/weight_codes.py`), or is made inside a kernel op as on the live
path.  `load_exported(...).pcall(params, xs)` runs it on other weights.

- The default traces the plain math (pallas mode "0", under
  `pallas_override`) in the checkpoint's own precision (quant "none"):
  aten ops alone.  It is stored on the CPU and marked for `cuda` and
  `cpu`: one file serves either, the loader moves the program to the
  device asked for (`torch.export.passes.move_to_device_pass`).
  `--batch-size 0` exports a symbolic batch (`torch.export.Dim`).
- `--kernels` traces the kernel ops (pallas mode "2", and W8A8 where
  `quant_mode()` says so): each launch is a `torch.library` custom op
  (`kernels/library.py`) whose CUDA implementation launches the
  hand-written kernel, counted as on the live path.  It needs a fixed
  `--batch-size` and `--platforms cuda`.
- `--data-parallel N` traces the program at batch / N rows (a fixed
  batch that N divides) and records `nr_devices` N: `load_exported` in a
  world of N or more ranks (`parallel/distributed.py`) has ranks 0..N-1
  each run its N-th of the rows and all-gather the outputs, as the JAX
  package binds its first N devices; a world of fewer ranks refuses it.
- KernelSHAP's final runs on the host (`fw_final_host`): there is no
  program to export.
"""

from __future__ import annotations

import io
import json
import os
import pathlib
import struct
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..models.common import pallas_override, quant_mode, quant_override
from ..parallel.mesh import gather_in
from ..utils.devices import resolve_device
from .env import ExpEnv
from .resources import get_recipe, load_epoch_model, load_misc

DEFAULT_PLATFORMS = ("cuda", "cpu")
PLATFORMS = ("cuda", "cpu")
_MAGIC = b"AGTORCH1"
_JAX_MAGIC = b"AGTPEXP1"  # `autognothi_tpu/pipeline/export.py:_MAGIC`


def _pack(program: bytes, meta: dict) -> bytes:
    return (_MAGIC + struct.pack("<Q", len(program)) + bytes(program)
            + json.dumps(meta).encode())


def _unpack(blob: bytes) -> Tuple[bytes, dict]:
    if blob[:8] == _JAX_MAGIC:
        raise ValueError(
            "this is the JAX package's export_final artifact (a jax.export "
            "program, magic AGTPEXP1): the port loads only its own "
            "torch.export artifacts; export the experiment with "
            "`python -m autognothi_tpu_torch export_final`")
    if blob[:8] != _MAGIC:
        raise ValueError("not an export_final artifact (bad magic)")
    n = struct.unpack("<Q", blob[8:16])[0]
    return blob[16:16 + n], json.loads(blob[16 + n:])


class _Serving(torch.nn.Module):
    """The serving forward as a module: `fw(model, xs)` under the pinned
    (pallas, quant) modes; the model's parameters are the program's."""

    def __init__(self, fw: Callable, model: torch.nn.Module,
                 modes: Tuple[str, str]):
        super().__init__()
        self.model = model
        self._fw, self._modes = fw, modes

    def forward(self, xs):
        with pallas_override(self._modes[0]), quant_override(self._modes[1]):
            return self._fw(self.model, xs)


def build_final_export(fw_final: Callable, model: torch.nn.Module,
                       null: np.ndarray, batch_size: int,
                       modes: Tuple[str, str] = ("0", "none"),
                       data_parallel: int = 1):
    """Trace the serving forward -> (torch.export.ExportedProgram, the
    input shape: a fixed batch, or the symbolic batch's name).

    `fw_final(model, xs) -> (probs, attr)` on the model's device;
    `modes = (pallas_mode, quant_mode)` pin the compute path during the
    trace (see `export_final`); `data_parallel` N traces batch_size / N
    rows, the input shape stays the global batch's."""
    device = next(model.parameters()).device
    if batch_size == 0:
        # batch-polymorphic artifact: one program serves any batch.  The
        # plain path traces with a symbolic leading dim; the kernel ops'
        # launch shapes are static, and so are a rank's rows
        if modes[0] not in ("0", ""):
            raise SystemExit("--kernels needs a fixed --batch-size "
                             "(the kernels' launch shapes are static)")
        if data_parallel > 1:
            raise SystemExit("a batch-polymorphic artifact cannot be "
                             "mesh-sharded — pass a fixed --batch-size")
        example = np.repeat(null, 2, axis=0)
        batch = torch.export.Dim("batch", min=1)
        dynamic = {"xs": {0: batch}}
        in_shape = ["batch", *null.shape[1:]]
    else:
        if batch_size % data_parallel != 0:
            raise SystemExit(
                f"--batch-size {batch_size} is not divisible by "
                f"--data-parallel {data_parallel}: every device must get "
                "equal slab rows")
        example = np.repeat(null, batch_size // data_parallel, axis=0)
        dynamic = None
        in_shape = [batch_size, *null.shape[1:]]
    xs = torch.as_tensor(np.ascontiguousarray(example)).to(device)
    module = _Serving(fw_final, model, modes)
    with torch.no_grad():
        ep = torch.export.export(module, (xs,), dynamic_shapes=dynamic,
                                 strict=False)
    return _drop_noop_casts(ep), in_shape


def _drop_noop_casts(ep):
    """Take out of the program the casts of a tensor to its own dtype
    (`x.float()` of an fp32 x: the tensor itself, on the live path as in
    the program) and the dtype asserts the trace puts beside each cast
    (the program's input is checked on entry).  In the plain forward they
    are ~60% of the nodes, and each costs the host a call at every run,
    at the load and at the save."""
    aten = torch.ops.aten
    graph = ep.graph_module.graph
    for node in list(graph.nodes):
        if node.target == aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif node.target == aten.to.dtype and not node.kwargs \
                and node.args[0].meta["val"].dtype == node.args[1] \
                and all(user.op != "output" for user in node.users):
            # (an output keeps its name: the signature lists it)
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    ep.graph_module.recompile()
    return ep


def export_final(env: ExpEnv, into: pathlib.Path, batch_size: int = 8,
                 platforms: Sequence[str] = DEFAULT_PLATFORMS,
                 kernels: bool = False, data_parallel: int = 1,
                 device: str = "cuda") -> dict:
    """Write the final model as one artifact; -> its metadata.

    `kernels=True` traces the kernel ops instead of the plain math (and
    the W8A8 path when AUTOGNOTHI_INT8=1): the program launches the
    hand-written kernels and runs only on `platforms=["cuda"]`.  The final
    is loaded and traced on `device`; the default program is stored on the
    CPU, for any of its platforms."""
    recipe, m_config = get_recipe(env.config)
    if recipe.fw_final_host:
        raise SystemExit(
            f"net kind {env.config.net.kind!r} computes its final "
            "explanation on the host (KernelSHAP WLS) — there is no device "
            "program to export")
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise SystemExit(f"--platforms takes a comma list of {PLATFORMS}, "
                         f"got {list(platforms)}")
    if kernels:
        if list(platforms) != ["cuda"]:
            raise SystemExit(
                "--kernels embeds the port's CUDA kernel ops — the artifact "
                "only runs on cuda (pass --platforms cuda)")
        with pallas_override("2"):
            modes = ("2", quant_mode())
    else:
        modes = ("0", "none")
    dev = resolve_device(device)
    _, model = load_epoch_model(env, recipe, "final", dev)
    null = np.asarray(recipe.gen_null(m_config,
                                      load_misc(env, recipe, m_config)))
    env.log(f"[[[ export_final: batch {batch_size}, platforms "
            f"{list(platforms)}, kernels={kernels}, quant={modes[1]}, "
            f"data_parallel={data_parallel}, traced on {dev} ]]]")
    ep, in_shape = build_final_export(
        lambda m, xs: recipe.fw_final(m_config, m, xs), model, null,
        batch_size, modes=modes, data_parallel=data_parallel)
    if not kernels and dev.type != "cpu":
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, "cpu")
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    meta = {
        "batch_size": batch_size or "symbolic",
        "platforms": list(platforms),
        "in_shape": in_shape,
        "in_dtype": str(null.dtype),
        "kernels": kernels,
        "quant": modes[1],
        "n_params": len(model.state_dict()),
        "nr_devices": data_parallel,
    }
    blob = _pack(buf.getvalue(), meta)
    into = pathlib.Path(into)
    # atomic: a kill mid-write never leaves a truncated artifact, or
    # corrupts a good one, at the target path
    tmp = into.with_name(into.name + ".tmp")
    try:
        tmp.write_bytes(blob)
        os.replace(tmp, into)
    finally:
        tmp.unlink(missing_ok=True)
    meta = {"path": str(into), "bytes": len(blob), **meta}
    env.log(f"[[[ export_final: wrote {meta['bytes']} bytes -> {into} ]]]")
    return meta


def load_exported(path: pathlib.Path, device: str = "cuda"
                  ) -> Callable[[torch.Tensor], Tuple]:
    """An `export_final` artifact -> a callable on `device` ("cuda" unless
    the caller asks for the CPU), which takes the input batch (a tensor or
    an array) and returns what the recipe's `fw_final` returns.  Refuses a
    device the artifact was not exported for.

    The callable carries `in_shape` (None for a symbolic batch),
    `in_dtype` (numpy), `platforms`, `meta`, `nr_devices`, `params` (the
    bundled weights under their flat names, on the device) and
    `pcall(params, xs)` (the program on other weights of the same names
    and shapes).

    An artifact of `nr_devices` N > 1 needs a world of N or more ranks
    (a ValueError naming the N devices otherwise), and every rank of the
    world loads it: ranks 0..N-1 each run their N-th of the rows of a
    call (every one of them calls with the whole batch) and all-gather
    the outputs; a rank past N-1 computes nothing and gets None."""
    program, meta = _unpack(pathlib.Path(path).read_bytes())
    nr = int(meta.get("nr_devices", 1))
    shard = _artifact_group(path, nr)
    dev = resolve_device(device)
    if dev.type not in meta["platforms"]:
        raise ValueError(
            f"artifact {path} was exported for {meta['platforms']}; it does "
            f"not run on {dev.type}"
            + (" (--kernels: the kernel ops launch CUDA kernels)"
               if meta["kernels"] else ""))
    from ..kernels import library  # noqa: F401  (registers the kernel ops)

    ep = torch.export.load(io.BytesIO(program))
    from torch.export.passes import move_to_device_pass

    ep = move_to_device_pass(ep, dev)
    module = ep.module()
    prefix = "model."  # `_Serving.model`
    params = {k[len(prefix):]: v for k, v in module.state_dict().items()}

    def pcall(weights: dict, xs):
        return sharded(lambda x: torch.func.functional_call(
            module, {prefix + k: v for k, v in weights.items()}, (x,)), xs)

    def call(xs):
        return sharded(module, xs)

    def sharded(fn, xs):
        xs = torch.as_tensor(xs).to(dev)
        with torch.inference_mode():
            if shard is None:
                return fn(xs)
            group, r = shard
            if r >= nr:
                return None
            rows = xs.shape[0] // nr
            outs = fn(xs[r * rows:(r + 1) * rows])
            return tuple(gather_in(o, group, nr) for o in outs)

    call.in_shape = tuple(d if isinstance(d, int) else None
                          for d in meta["in_shape"])
    call.in_dtype = np.dtype(meta["in_dtype"])
    call.platforms = tuple(meta["platforms"])
    call.meta = meta
    call.nr_devices = nr
    call.params = params
    call.pcall = pcall
    return call


def _artifact_group(path, nr: int):
    """-> None for a one-device artifact, else (the group of ranks 0..nr-1,
    this rank); every rank of the world must call (the group is made
    collectively)."""
    if nr == 1:
        return None
    import torch.distributed as dist

    from ..parallel.distributed import rank, world_size

    if world_size() < nr:
        raise ValueError(
            f"artifact {path} was exported for {nr} devices (--data-parallel "
            f"{nr}); this run's world has {world_size()} process(es) — "
            f"start {nr} (AUTOGNOTHI_DIST_* or torchrun, one per device) or "
            "re-export with a smaller --data-parallel")
    group = (dist.group.WORLD if world_size() == nr
             else dist.new_group(list(range(nr))))
    return group, rank()
