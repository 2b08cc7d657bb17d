#!/usr/bin/env python3
"""Times every kernel op of `chip_smoke.py`'s timing phase (`op_cases` at
the LTT ViT-B/16@224 shapes, B=64, and `bert_op_cases` at the LTT
BERT-base@512 shapes, B=8; fp32 and bf16) and the float GEMM alone at
K7's two products of both models (beside `torch.matmul`) on one NVIDIA
GPU, for the `autognothi_tpu_torch` and `chip_smoke.py` of the checkout
named, so two checkouts can be compared on one card, in turns:

    python3 kernel_ab.py A <checkout A>
    python3 kernel_ab.py B <checkout B>
    python3 kernel_ab.py B <checkout B>
    python3 kernel_ab.py A <checkout A>

Each run builds that checkout's kernels, checks every op against its plain
version with `chip_smoke.compare` (fp32 1e-4, bf16 3e-2 x max(1,
max|ref|), the int8 ops at their own bounds; the GEMM against
`torch.matmul`) and prints one JSON line per case: {"label", "op",
"shape", "dtype", "ms", "device_ms", "err"}.  `ms` is CUDA events around
20 calls after a warmup, the host's gaps between launches included (the
ops at the 96-wide side shapes are host-bound); `device_ms` is the device
time of the kernels of another 20 calls (`torch.profiler`), per call.
Inputs come from seeded generators, so every run sees the same data.
"""

from __future__ import annotations

import json
import pathlib
import sys

REPS = 20


def device_ms(fn) -> float:
    """Device time of the kernels of REPS calls of `fn`, per call, from
    the profiler's device-side events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / REPS


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    label, root = sys.argv[1], pathlib.Path(sys.argv[2]).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as smoke
    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.utils.devices import resolve_device

    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    for mod in (kp, smoke):
        if not pathlib.Path(mod.__file__).resolve().is_relative_to(root):
            raise RuntimeError(f"imported {mod.__file__}, not {root}'s")
    dev = resolve_device("cuda")
    g = torch.Generator().manual_seed(7)
    cases = []
    # the ops of chip_smoke's timing phase: the kernel table's rows
    for cases_fn, b in ((smoke.op_cases, smoke.B_TIME),
                        (smoke.bert_op_cases, smoke.B_BERT)):
        for dtype in (torch.float32, torch.bfloat16):
            for name, tag, op, plain, args, kw in cases_fn(dev, dtype, b,
                                                           False):
                cases.append((name, f"{tag} B={b}", dtype,
                              lambda o=op, a=args, k=kw: o(*a, **k),
                              lambda p=plain, a=args, k=kw: p(*a, **k)))
    # the float GEMM alone at K7's products (ViT B=64, BERT B=8)
    for m in (smoke.B_TIME * smoke.T, smoke.B_BERT * smoke.T_BERT):
        for n, k in ((3072, 768), (768, 3072)):
            a32 = torch.randn(m, k, generator=g).to(dev)
            w32 = (torch.randn(n, k, generator=g) * k ** -0.5).to(dev)
            bias = torch.zeros(n, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                a, w = a32.to(dtype), w32.to(dtype)
                cases.append(("gemm", f"<{m},{k}>x<{n},{k}>^T", dtype,
                              lambda a=a, w=w, b=bias: kp.gemm(
                                  a, w, b, kp.EPI_BIAS),
                              lambda a=a, w=w: torch.matmul(a, w.T)))
    for op, shape, dtype, kern, plain in cases:
        with torch.inference_mode():
            err, ok, msg = smoke.compare(kern(), plain(), dtype,
                                         op in smoke.INT8_OPS)
            if not ok:
                raise RuntimeError(f"{op} {shape} {dtype}: {msg}")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                kern()
            end.record()
            torch.cuda.synchronize()
            dev_ms = device_ms(kern)
        print(json.dumps(dict(label=label, op=op, shape=shape,
                              dtype=str(dtype).split(".")[-1],
                              ms=start.elapsed_time(end) / REPS,
                              device_ms=dev_ms, err=err)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
