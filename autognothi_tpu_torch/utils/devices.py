"""Device selection: an explicit `torch.device`, never a silent fallback."""

from __future__ import annotations

import torch
import torch.distributed


def _pin_fp32() -> None:
    # fp32 means fp32: no TF32 in matmuls or cuDNN, so the port matches the
    # JAX package's fp32 serving numbers
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name: str) -> torch.device:
    """"cuda" (or "cuda:N") or "cpu" -> torch.device.  Asking for CUDA on a
    host without a usable card raises: the port never falls back to the
    CPU behind the caller's back.  In a world of processes (`parallel/
    distributed.py`), "cuda" is this process's card, `cuda:{local_rank}`."""
    _pin_fp32()
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() "
                "is False on this host")
        if dev.index is None and torch.distributed.is_initialized():
            from ..parallel.distributed import local_rank

            dev = torch.device("cuda", local_rank())
        elif dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev
