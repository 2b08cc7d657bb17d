"""Multi-process initialization (port of `autognothi_tpu/parallel/
distributed.py`) on `torch.distributed`.

A run uses one process per device: every process calls
`maybe_initialize_distributed`, after which the default process group's
ranks are the run's devices, `parallel.mesh.make_mesh` builds a
("data", "model") mesh over them, and rank r computes on
`cuda:{local_rank()}` (the CPU where the caller asks for it).

Engaged through the environment, so every CLI verb inherits it without a
flag of its own:

    AUTOGNOTHI_DIST_COORD=host:port   the rendezvous address
                                      (init_method "tcp://host:port");
                                      "auto" takes torchrun's RANK,
                                      WORLD_SIZE and MASTER_* instead
                                      (init_method "env://")
    AUTOGNOTHI_DIST_NPROCS=N          the number of processes
    AUTOGNOTHI_DIST_PROC_ID=i         this process's rank in [0, N)

The backend is NCCL when the run's device is CUDA and gloo on the CPU, as
the JAX package picks gloo for CPU collectives.  Without
AUTOGNOTHI_DIST_COORD nothing is initialized and the run is one process
on one device.  `autognothi_tpu_torch.cli.main` calls it before any device
is chosen.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def distributed_env_configured(env: Optional[dict] = None) -> bool:
    env = os.environ if env is None else env
    return bool(env.get("AUTOGNOTHI_DIST_COORD"))


def world_size() -> int:
    """The number of processes (devices) of the run: 1 outside a world."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """Rank 0 writes the run's files (checkpoints, logs, reports, the
    config); the other ranks wait at a `barrier`."""
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def agree(value):
    """Rank 0's `value` on every rank (a picklable object; itself outside
    a world): a decision that gates collectives must be the same on all."""
    if world_size() < 2:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is True on any (one MAX all-reduce
    of an int tensor; `flag` itself outside a world): a stop that one rank
    sees, such as a SIGTERM, is taken by all at the same batch."""
    if world_size() < 2:
        return flag
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def local_rank(env: Optional[dict] = None) -> int:
    """This process's device index on its host: torchrun's LOCAL_RANK,
    else the rank modulo the host's CUDA devices (one process per device;
    0 on a host without a card)."""
    env = os.environ if env is None else env
    if env.get("LOCAL_RANK") is not None:
        return int(env["LOCAL_RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return rank() % n if n else 0


def maybe_initialize_distributed(env: Optional[dict] = None,
                                 device: str = "cuda") -> bool:
    """Initialize the default process group from the AUTOGNOTHI_DIST_*
    variables; True when a world was engaged.  A no-op (False) when
    AUTOGNOTHI_DIST_COORD is unset.  Idempotent: a second call returns
    True without initializing again.  `device` picks the backend: "cpu"
    gloo, anything else NCCL."""
    env = os.environ if env is None else env
    coord = env.get("AUTOGNOTHI_DIST_COORD")
    if not coord:
        return False
    if dist.is_initialized():
        return True
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    if coord == "auto":
        dist.init_process_group(backend, init_method="env://")
    else:
        nprocs = env.get("AUTOGNOTHI_DIST_NPROCS")
        proc_id = env.get("AUTOGNOTHI_DIST_PROC_ID")
        if nprocs is None or proc_id is None:
            raise RuntimeError(
                "AUTOGNOTHI_DIST_COORD is set but "
                "AUTOGNOTHI_DIST_NPROCS/AUTOGNOTHI_DIST_PROC_ID are not — "
                "set both (total process count and this process's index), "
                "or use AUTOGNOTHI_DIST_COORD=auto under torchrun")
        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                world_size=int(nprocs), rank=int(proc_id))
    if backend == "nccl":
        torch.cuda.set_device(local_rank(env))
    return True


def process_info() -> dict:
    """Diagnostic summary: process index and count, devices in the world
    and on this process (one per process)."""
    return {
        "process_index": rank(),
        "process_count": world_size(),
        "global_devices": world_size(),
        "local_devices": 1,
    }
