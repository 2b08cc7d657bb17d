"""Deterministic, resumable seeds (port of `autognothi_tpu/utils/seeding.py`).

A fresh 32-bit seed is derived per (master seed, stage key) with sha256,
exactly as the JAX package and the reference derive it, so an interrupted
run re-derives identical seeds on resume.  Where the JAX package turns the
seed into a `jax.random` key, the port seeds a `torch.Generator` with it.
"""

from __future__ import annotations

import hashlib
import random
from typing import Optional, Union

import numpy as np
import torch

__all__ = ["derive_seed", "iterative_generator", "set_iterative_seed"]


def derive_seed(master_seed: int, key: str) -> int:
    """sha256-keyed 32-bit seed, the JAX package's derivation."""
    tag = f"[seed={master_seed},key={key}]"
    digest = hashlib.sha256(tag.encode("utf-8", "ignore")).digest()
    return int.from_bytes(digest[:8], byteorder="big") % 2**32


def iterative_generator(master_seed: int, key: str,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> torch.Generator:
    """A `torch.Generator` on `device` (default CPU) seeded with
    `derive_seed(master_seed, key)`."""
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(derive_seed(master_seed, key))
    return gen


def set_iterative_seed(master_seed: int, key: str) -> int:
    """Seed the host-side generators (python `random`, numpy) for a named
    stage, for host-side choices such as dataset subsetting."""
    seed = derive_seed(master_seed, key)
    random.seed(seed)
    np.random.seed(seed)
    return seed
