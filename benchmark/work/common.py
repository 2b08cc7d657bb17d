"""The frozen count of operations and bytes of the logical ops, and the
table of peaks they are held to.

A logical op is one of the JAX kernels' fusion boundaries (attention
block, MLP block, ladder step, head, masked attention) or a plain piece
beside them (embeddings, classifiers, AdamW).  Its operations are the
products it needs, 2 * M * N * K each, by arithmetic; its bytes count
each input read once and each output written once (weights at the width
they are held in: 1 byte an int8 code plus its fp32 scale, 4 bytes a
float32 value).  So a roofline reads the same work whatever implements
it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): int8 1,979
TOP/s, bf16 989 TFLOP/s, and float32 at TF32's 495 TFLOP/s, the fastest
tensor-core rate any float32-grade product can reach; HBM3 3.35 TB/s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List

PEAK = {"int8": 1979e12, "bf16": 989e12, "fp32": 495e12}
HBM_BYTES_PER_S = 3.35e12


@dataclasses.dataclass
class Op:
    name: str
    flops: Dict[str, float]      # arithmetic -> operations
    bytes: float
    count: float = 1.0           # how many times the op runs

    def scaled(self, k: float) -> "Op":
        return dataclasses.replace(self, count=self.count * k)

    def least_s(self) -> float:
        """The least time of all its runs: compute or bytes, whichever
        bounds it."""
        compute = sum(f / PEAK[a] for a, f in self.flops.items())
        return self.count * max(compute, self.bytes / HBM_BYTES_PER_S)

    def peak_s(self) -> float:
        """Its operations' time at the peak of their arithmetic."""
        return self.count * sum(f / PEAK[a] for a, f in self.flops.items())


def total_flops(ops: Iterable[Op]) -> float:
    return sum(o.count * sum(o.flops.values()) for o in ops)


def least_s(ops: Iterable[Op]) -> float:
    return sum(o.least_s() for o in ops)


def peak_s(ops: Iterable[Op]) -> float:
    return sum(o.peak_s() for o in ops)


def scaled(ops: Iterable[Op], k: float) -> List[Op]:
    return [o.scaled(k) for o in ops]


def product(rows: float, n_in: int, n_out: int) -> float:
    return 2.0 * rows * n_in * n_out


def weight_bytes(n_in: int, n_out: int, int8: bool) -> float:
    """A (out, in) weight and its bias as held: int8 codes and an fp32
    scale per output channel, or float32."""
    w = n_in * n_out * (1 if int8 else 4)
    return w + n_out * 4 + (n_out * 4 if int8 else 0)


def attention_block(b: int, t: int, h: int, heads: int, int8: bool,
                    name: str) -> Op:
    """LN?, Q/K/V, masked attention, output product, residual."""
    rows = b * t
    arith = "int8" if int8 else "fp32"
    flops = {arith: product(rows, h, 3 * h) + product(rows, h, h)}
    flops["fp32"] = flops.get("fp32", 0.0) + 4.0 * b * t * t * h
    byt = 2 * rows * h * 4 + b * t * 4 + weight_bytes(h, 3 * h, int8) \
        + weight_bytes(h, h, int8) + 2 * h * 4
    return Op(name, flops, byt)


def mlp_block(b: int, t: int, h: int, inter: int, int8: bool,
              name: str) -> Op:
    rows = b * t
    arith = "int8" if int8 else "fp32"
    flops = {arith: product(rows, h, inter) + product(rows, inter, h)}
    byt = 2 * rows * h * 4 + weight_bytes(h, inter, int8) \
        + weight_bytes(inter, h, int8) + 2 * h * 4
    return Op(name, flops, byt)


def ladder_step(b: int, t: int, h: int, s: int, inter: int, branches: int,
                name: str) -> Op:
    """Every branch's float side update from the trunk's h: map, GELU,
    the side layer's attention and MLP."""
    rows = b * t
    per = product(rows, h, s) + product(rows, s, 3 * s) \
        + product(rows, s, s) + 4.0 * b * t * t * s \
        + product(rows, s, inter) + product(rows, inter, s)
    wts = weight_bytes(h, s, False) + weight_bytes(s, 3 * s, False) \
        + weight_bytes(s, s, False) + weight_bytes(s, inter, False) \
        + weight_bytes(inter, s, False) + 4 * s * 4
    byt = rows * h * 4 + b * t * 4 + branches * (2 * rows * s * 4 + wts)
    return Op(name, {"fp32": branches * per}, byt)


def backward(op: Op) -> Op:
    """The backward of an op that is differentiated: the gradient of the
    input and of the weights, twice the forward's products; it reads the
    forward's inputs, weights and output gradient and writes the input's
    and weights' gradients (about twice the forward's bytes)."""
    return Op(op.name + ".backward",
              {a: 2.0 * f for a, f in op.flops.items()}, 2.0 * op.bytes,
              op.count)
