"""Random weights from the run's seed, made on the device in two large
draws (one uniform, one normal) and cut into the checkpoint's tensors:

- a linear layer's weight and bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in));
- a LayerNorm's weight U(0.5, 1.5) and bias U(-0.1, 0.1), so that a path
  that drops either shows;
- embedding tables, the CLS token and the position embeddings: N(0, 1);
- the surrogate's null value: U(0.05, 0.15) per class.

The same seed gives the same weights on the same device."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, Tuple[int, ...]]]
NORMAL = ("word_embeddings.weight", "position_embeddings.weight",
          "token_type_embeddings.weight", "cls_token",
          "embeddings.position_embeddings")
NORMS = ("layernorm", "LayerNorm", "s_explainer_mlp.0.")


def _law(name: str, shapes: Dict[str, Tuple[int, ...]]):
    """-> ("normal",) or ("uniform", lo, hi) for one tensor."""
    if name.endswith(NORMAL):
        return ("normal",)
    if name == "surrogate_null":
        return ("uniform", 0.05, 0.15)
    if any(n in name for n in NORMS):
        return ("uniform", 0.5, 1.5) if name.endswith(".weight") \
            else ("uniform", -0.1, 0.1)
    weight = name[:-len("bias")] + "weight" if name.endswith(".bias") \
        else name
    bound = 1.0 / math.sqrt(math.prod(shapes[weight][1:]))
    return ("uniform", -bound, bound)


def make(specs: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The flat float32 parameters of `specs`, drawn from `seed`."""
    shapes = dict(specs)
    laws = {name: _law(name, shapes) for name, _ in specs}
    sizes = {name: math.prod(shape) for name, shape in specs}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pools = {}
    for kind, draw in (("uniform", torch.rand), ("normal", torch.randn)):
        total = sum(sizes[n] for n in sizes if laws[n][0] == kind)
        pools[kind] = draw(total, generator=gen, device=device)
    out, offsets = {}, {"uniform": 0, "normal": 0}
    with torch.no_grad():
        for name, shape in specs:
            law = laws[name]
            at = offsets[law[0]]
            offsets[law[0]] = at + sizes[name]
            x = pools[law[0]][at:at + sizes[name]].view(shape)
            if law[0] == "uniform":
                x.mul_(law[2] - law[1]).add_(law[1])
            out[name] = x
    return out


def to_npz(params: Dict[str, torch.Tensor], path) -> int:
    """Write the parameters as the program's flat npz checkpoint -> bytes
    written."""
    host = {k: v.detach().cpu().numpy() for k, v in params.items()}
    with open(path, "wb") as f:
        np.savez(f, **host)
    return sum(v.nbytes for v in host.values())
