"""The kernel ops as `torch.library` custom ops, so that `torch.export`
can trace a forward that runs them (`pipeline/export.py`, `--kernels`).

A kernel launch hands raw pointers to a C function through `ctypes`,
which a trace cannot follow.  So under `torch.compiler.is_exporting()`
the one routing rule of the ops (`primitives.dispatch`) emits, for each
launch it would make, a call of the op's custom op
`autognothi::<counter name>`: its tensors as one `Tensor[]`, its static
keywords as keyword arguments, its outputs as one `Tensor[]`.  Each op
has three implementations:
- CUDA: the op's launcher, which the live path calls, counted on the op's
  `LaunchCounter`, so that an exported program's slab shows in the same
  counters as a live slab;
- CPU: the op's plain version, as `dispatch` routes CPU tensors;
- fake: the shapes, dtypes and strides of the launcher's outputs, for the
  trace.
No backward: the export traces under `torch.no_grad()`.  Outside a trace
`dispatch` launches directly and never goes through these ops.

The K8q tile's launch on the live path is a `functools.partial` that
carries its chain (`mlp_block._Int8Chain`: x's codes and the row-max
buffers shared by a chain's tiles); its op takes only the tile's tensors,
and its CUDA implementation runs the tile as a chain of its own.

Importing this module registers the ops; loading an exported program that
holds them needs it imported first (`pipeline/export.py:load_exported`).
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable, Dict, Sequence

import torch

NAMESPACE = "autognothi"


@dataclasses.dataclass(frozen=True)
class KernelOp:
    """One custom op: the ops module's launcher, plain version and counter
    (by attribute name), the schema of its static keywords, and its fake
    implementation `(tensors, **static) -> list of tensors`; single: the
    launcher returns one tensor, else a tuple.  Its name is its
    counter's."""
    module: str
    launch: str
    plain: str
    counter: str
    static: str
    fake: Callable
    single: bool = True

    def resolve(self):
        mod = importlib.import_module(f"..ops.{self.module}", __package__)
        return (getattr(mod, self.launch), getattr(mod, self.plain),
                getattr(mod, self.counter))


def _like_resid(ts, **_):
    """One output shaped and typed as the first tensor (the residual)."""
    return [ts[0].new_empty(ts[0].shape)]


def _tile(ts, **_):
    """A split-MLP tile: x's dtype, the residual's shape."""
    return [ts[0].new_empty(ts[1].shape)]


def _sides(h, sides):
    """The ladder's updated sides: h's dtype, each side's shape."""
    return [h.new_empty((*h.shape[:-1], s.shape[-1])) for s in sides]


def _ladder(ts, *, n_branches, **_):
    return _sides(ts[0], ts[2:2 + n_branches])


def _mlp_ladder(ts, *, n_branches, **_):
    return [ts[0].new_empty(ts[0].shape),
            *_sides(ts[0], ts[8:8 + n_branches])]


def _ladder_attention(ts, **_):
    return [q.new_empty(q.shape) for q in ts[1::3]]


def _masked_attention(ts, **_):
    # the launcher writes <N, T, h, D> and returns its <N, h, T, D> view
    n, h, t, d = ts[0].shape
    return [ts[0].new_empty((n, t, h, d)).transpose(1, 2)]


def _head(ts, **_):
    x, w3 = ts[0], ts[5]
    return [x.new_empty((*x.shape[:-1], w3.shape[0]))]


_BLOCK = "int n_heads, str mode, str ln_position, float ln_eps"
_MLP = "str ln_position, float ln_eps"
_LADDER = "int n_branches, int n_heads, str mode"

# op name (its counter's) -> what it runs; the twelve routes of `dispatch`
OPS: Dict[str, KernelOp] = {
    "attention_block": KernelOp(
        "attention_block", "attention_block_launch", "attention_block_plain",
        "COUNTER", _BLOCK, _like_resid),
    "attention_block_int8": KernelOp(
        "attention_block", "attention_block_int8_launch",
        "attention_block_int8_plain", "COUNTER_INT8", _BLOCK, _like_resid),
    "mlp_block": KernelOp(
        "mlp_block", "mlp_block_launch", "mlp_block_plain", "COUNTER", _MLP,
        _like_resid),
    "mlp_block_int8": KernelOp(
        "mlp_block", "mlp_block_int8_launch", "mlp_block_int8_plain",
        "COUNTER_INT8", _MLP, _like_resid),
    "mlp_block_tiled": KernelOp(
        "mlp_block", "mlp_tile_launch", "mlp_tile_plain", "COUNTER_TILED",
        "", _tile),
    "mlp_block_int8_tiled": KernelOp(
        "mlp_block", "mlp_tile_int8_launch", "mlp_tile_int8_plain",
        "COUNTER_INT8_TILED", "", _tile),
    "chain_layer_norm": KernelOp(
        "mlp_block", "_chain_ln_launch", "_chain_ln_plain",
        "COUNTER_CHAIN_LN", "float eps", _like_resid),
    "ladder_block": KernelOp(
        "ladder_block", "ladder_block_launch", "ladder_block_plain",
        "COUNTER", f"{_LADDER}, bool pre_norm, float ln_eps", _ladder,
        single=False),
    "mlp_ladder_block": KernelOp(
        "ladder_block", "mlp_ladder_block_launch", "mlp_ladder_block_plain",
        "COUNTER_MLP_LADDER", f"{_LADDER}, float ln_eps", _mlp_ladder,
        single=False),
    "ladder_attention": KernelOp(
        "ladder_block", "ladder_attention_launch", "ladder_attention_plain",
        "COUNTER_ATTENTION", "int n_heads, str mode", _ladder_attention,
        single=False),
    "head_block": KernelOp(
        "head_block", "head_int8_launch", "head_int8_plain", "COUNTER",
        "bool has_ln, float ln_eps", _head),
    "masked_attention": KernelOp(
        "flash_attention", "masked_attention_launch",
        "masked_attention_plain", "COUNTER", "str mode", _masked_attention),
}


def _as_list(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _cuda_impl(launch, counter):
    def run(tensors, **static):
        out = launch(*tensors, **static)
        counter.add()
        return _as_list(out)
    return run


def _cpu_impl(plain):
    def run(tensors, **static):
        return _as_list(plain(*tensors, **static))
    return run


def _register() -> tuple:
    lib = torch.library.Library(NAMESPACE, "DEF")
    by_launch = {}
    for name, op in OPS.items():
        launch, plain, counter = op.resolve()
        if counter.name != name:
            raise RuntimeError(f"op {name} counts on {counter.name}")
        static = f", *, {op.static}" if op.static else ""
        lib.define(f"{name}(Tensor[] tensors{static}) -> Tensor[]")
        lib.impl(name, _cuda_impl(launch, counter), "CUDA")
        lib.impl(name, _cpu_impl(plain), "CPU")
        torch.library.register_fake(f"{NAMESPACE}::{name}", op.fake, lib=lib)
        by_launch[launch] = name
    return lib, by_launch


_LIB, _BY_LAUNCH = _register()


def op_name(launch: Callable) -> str:
    """The custom op of a launcher (a partial's: its function's)."""
    fn = launch.func if isinstance(launch, functools.partial) else launch
    if fn not in _BY_LAUNCH:
        raise ValueError(f"{getattr(fn, '__name__', fn)} is no kernel op's "
                         f"launcher: it has no custom op to export")
    return _BY_LAUNCH[fn]


def call(launch: Callable, tensors: Sequence[torch.Tensor], static: dict):
    """The custom op call that stands for `launch(*tensors, **static)` in a
    trace; -> a tensor or a tuple, as the launcher returns."""
    name = op_name(launch)
    outs = getattr(getattr(torch.ops, NAMESPACE), name)(list(tensors),
                                                        **static)
    return outs[0] if OPS[name].single else tuple(outs)
