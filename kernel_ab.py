#!/usr/bin/env python3
"""Times every kernel op of `chip_smoke.py`'s timing phase (`op_cases` at
the LTT ViT-B/16@224 shapes, B=64, and `bert_op_cases` at the LTT
BERT-base@512 shapes, B=8; fp32 and bf16) and the float GEMM alone at
K7's two products of both models (beside `torch.matmul`) and the int8
GEMM alone at K1's and K2's four products at M = 12608 and 50432 (beside
`torch._int_mm`: `int_mm_device_ms`), the float TMA + wgmma GEMM alone
at K6's two products at M = 12608 and 4096 where the checkout has it
(beside `torch.matmul`: `matmul_ms`, CUDA events), K5 with one branch at
the train step's teacher shape (256 images), and the split MLP chains at
LTT BERT-base@512 B=8 (K8q with fp32 and with bf16 parameters, the bf16
K8; where the checkout has them, K8's two products alone at each tile
width), K4 at the int8 teacher's trunk shape (256 images) and, where the
checkout has them, the trunk K4's W2 product quantizing on load beside
the row pass + GEMM on codes (M = 12608 and 50432), its W1 product
with the amax epilogue, and K3's d1 straight to codes beside the fp32 h
and a row pass (ViT B=64, BERT B=8) on one NVIDIA GPU, for the
`autognothi_tpu_torch` and `chip_smoke.py` of the checkout named, so two
checkouts can be compared on one card, in turns:

    python3 kernel_ab.py A <checkout A>
    python3 kernel_ab.py B <checkout B>
    python3 kernel_ab.py B <checkout B>
    python3 kernel_ab.py A <checkout A>

Op names after the checkout (e.g. `ladder_attention`) keep only those
ops' cases.

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

import functools
import json
import pathlib
import sys

REPS = 20
# K1's and K2's int8 products: (label, N, K, the epilogue the path runs)
I8_PRODUCTS = (("K1 qkv", 2304, 768, 0), ("K1 out", 768, 768, 1),
               ("K2 W1 GELU", 3072, 768, 2), ("K2 W2", 768, 3072, 1))


def device_ms(fn, tries: int = 10) -> float:
    """Device time of the kernels of REPS calls of `fn`, per call, from
    the profiler's device-side events of the second of two windows (the
    profiler now and then loses the first events of a window it starts
    with); a window with events missing (a kernel seen a number of times
    that is not a whole multiple of the calls) is profiled again, and
    `tries` of them raise."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(REPS):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # the step's own annotation ("ProfilerStep#") is no kernel
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("ProfilerStep")]
        counts: dict = {}
        for e in kernels:
            counts[e.name] = counts.get(e.name, 0) + 1
        if counts and all(n % REPS == 0 for n in counts.values()):
            return sum(e.time_range.elapsed_us()
                       for e in kernels) / 1e3 / REPS
    raise RuntimeError(f"the profiler lost device events in {tries} "
                       f"windows")


def events_ms(fn) -> float:
    """CUDA-event time of REPS calls of `fn` after one warmup, per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    label, root = sys.argv[1], pathlib.Path(sys.argv[2]).resolve()
    keep = set(sys.argv[3:])
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
    # the int8 GEMM alone at K1's and K2's products (ViT B=64 and the train
    # step's teacher, M = 12608 and 50432), fp32 epilogues as on the path,
    # beside torch._int_mm (the int32 product alone); checked against the
    # same epilogue steps in torch on _int_mm's sum (exact for the bias and
    # residual epilogues, the float tolerance for GELU)
    library = {}
    for m in (smoke.B_TIME * smoke.T, 4 * smoke.B_TIME * smoke.T):
        for product, n, k, epi in I8_PRODUCTS:
            a = torch.randint(-127, 128, (m, k), generator=g,
                              dtype=torch.int8).to(dev)
            w = torch.randint(-127, 128, (n, k), generator=g,
                              dtype=torch.int8).to(dev)
            sa = (torch.rand(m, generator=g) * 1e-2).to(dev)
            sw = (torch.rand(n, generator=g) * 1e-3).to(dev)
            bias = torch.randn(n, generator=g).to(dev)
            resid = (torch.randn(m, n, generator=g).to(dev)
                     if epi == kp.I8_EPI_BIAS_RESID else None)

            def ref(a=a, w=w, sa=sa, sw=sw, bias=bias, resid=resid,
                    epi=epi):
                v = (torch._int_mm(a, w.T).float() * sa[:, None]) * sw + bias
                if epi == kp.I8_EPI_GELU_F32:
                    return torch.nn.functional.gelu(v)
                return v if resid is None else resid + v

            shape = f"{product} <{m},{k}>x<{n},{k}>^T"
            cases.append(("gemm_i8", shape, torch.float32,
                          lambda a=a, w=w, sa=sa, sw=sw, bias=bias,
                          resid=resid, epi=epi: kp.gemm_i8(
                              a, sa, w, sw, bias, epi, torch.float32,
                              resid=resid), ref))
            library[shape] = ("int_mm_device_ms",
                              lambda a=a, w=w: torch._int_mm(a, w.T))
    # the float TMA + wgmma GEMM alone at K6's products (ViT B=64, BERT
    # B=8), fp32 and bf16, beside torch.matmul (`matmul_ms`); only where
    # the checkout has it
    if hasattr(kp, "gemm_wg"):
        from autognothi_tpu_torch.ops.weight_codes import tf32_planes

        for m in (smoke.B_TIME * smoke.T, smoke.B_BERT * smoke.T_BERT):
            for product, n, k, with_resid in (("K6 qkv", 2304, 768, False),
                                              ("K6 out", 768, 768, True)):
                a32 = torch.randn(m, k, generator=g).to(dev)
                w32 = (torch.randn(n, k, generator=g) * k ** -0.5).to(dev)
                bias = torch.randn(n, generator=g).to(dev)
                r32 = torch.randn(m, n, generator=g).to(dev)
                w_hi, w_lo = tf32_planes(w32)
                epi = kp.EPI_WG_BIAS_RESID if with_resid else kp.EPI_WG_BIAS
                for mode in ("fp32", "bf16"):
                    dtype = torch.bfloat16 if mode == "bf16" \
                        else torch.float32
                    a, w, r = a32.to(dtype), w32.to(dtype), r32.to(dtype)
                    kw = dict(resids=(r,) if with_resid else ())
                    if mode == "bf16":
                        args = (a, w, bias, epi)
                    else:
                        kw.update(w_lo=w_lo)
                        args = (a32, w_hi, bias, epi)

                    def ref(a=a, w=w, r=r, bias=bias,
                            with_resid=with_resid):
                        v = (torch.matmul(a.float(), w.float().T)
                             + bias).to(a.dtype)
                        return r + v if with_resid else v

                    shape = f"{product} {mode} <{m},{k}>x<{n},{k}>^T"
                    cases.append(("gemm_wg", shape, dtype,
                                  lambda args=args, kw=kw: kp.gemm_wg(
                                      *args, **kw), ref))
                    library[shape] = ("matmul_ms",
                                      lambda a=a, w=w: torch.matmul(a, w.T))
    # K5 with one branch at the train step's teacher sweep (B*M = 256
    # images of 197 tokens), fp32 and bf16
    from autognothi_tpu_torch.ops import ladder_block as lb

    for dtype in (torch.float32, torch.bfloat16):
        b, t, h, s = 4 * smoke.B_TIME, smoke.T, 768, 96

        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=g) * scale).to(dev, dtype)

        shapes = {"map_w": (s, h), "w1": (4 * s, s), "b1": (4 * s,),
                  "w2": (s, 4 * s)}
        branch = {k: rnd(*shapes.get(k, (s, s) if k.startswith("w")
                                     else (s,)), scale=0.1)
                  for k in lb.BRANCH_KEYS}
        branch["ln1_w"] += 1
        branch["ln2_w"] += 1
        args = (rnd(b, t, h), [rnd(b, t, s)],
                (torch.rand(b, t, generator=g) > 0.4).float().to(dev),
                [branch], 12, "mul", True, 1e-12)
        cases.append(("ladder_block", f"768 -> 1 x 96 B={b} (teacher)",
                      dtype, lambda a=args: lb.ladder_block(*a),
                      lambda a=args: lb.ladder_block_plain(
                          *lb.ladder_block_args(*a)[0],
                          **lb.ladder_block_args(*a)[1])))
    # the split MLP chains at LTT BERT-base@512 B=8 (2 tiles, LN
    # epilogue), built here so both checkouts see the same inputs: K8q with
    # fp32 and with bf16 parameters, the bf16 float chain K8; where the
    # checkout has them, K8's two products alone at each tile width beside
    # torch.matmul
    from autognothi_tpu_torch.ops import mlp_block as mb

    m_bert, h, inter = smoke.B_BERT * smoke.T_BERT, 768, 3072
    chain_in = {}
    for dtype in (torch.float32, torch.bfloat16):
        chain_in[dtype] = (
            torch.randn(smoke.B_BERT, smoke.T_BERT, h, generator=g).to(
                dev, dtype),
            *(x.to(dev, dtype) for x in (
                torch.randn(inter, h, generator=g) * h ** -0.5,
                torch.randn(inter, generator=g) * 0.1,
                torch.randn(h, inter, generator=g) * inter ** -0.5,
                torch.randn(h, generator=g) * 0.1)))
    ln = (1 + 0.1 * torch.randn(h, generator=g).to(dev),
          0.1 * torch.randn(h, generator=g).to(dev), 1e-12)
    chains = [("K8q fp32 params", torch.float32, "int8"),
              ("K8q bf16 params", torch.bfloat16, "int8"),
              ("K8 bf16", torch.bfloat16, "none")]
    for label_, dtype, quant in chains:
        op = functools.partial(mb.mlp_block, ln=ln, ln_position="epilogue",
                               quant=quant)
        name = "mlp_block_int8_tiled" if quant == "int8" \
            else "mlp_block_tiled"
        cases.append((name, f"{label_} <8,512,768>/3072", dtype,
                      lambda o=op, a=chain_in[dtype]: o(*a),
                      lambda o=smoke._under_plain(op), a=chain_in[dtype]:
                      o(*a)))
    if hasattr(kp, "EPI_WG_BIAS_GELU"):
        x, w1, b1, w2, b2 = chain_in[torch.bfloat16]
        a1 = x.reshape(m_bert, h)
        a2 = torch.randn(m_bert, inter // 2, generator=g).to(dev,
                                                              torch.bfloat16)
        r = torch.randn(m_bert, h, generator=g).to(dev, torch.bfloat16)
        b1_32, b2_32 = b1[:inter // 2].float(), b2.float()
        for product, widths in (("K8 W1 GELU", (128, 192, 256)),
                                ("K8 W2 slice", (96, 128, 192))):
            for bn in widths:
                if product == "K8 W1 GELU":
                    args = (a1, w1[:inter // 2], b1_32, kp.EPI_WG_BIAS_GELU)
                    kw = dict(bn=bn)

                    def ref(a=a1, w=w1[:inter // 2], b=b1_32):
                        return torch.nn.functional.gelu(
                            torch.matmul(a.float(), w.float().T) + b
                        ).bfloat16()
                    lib = (a1, w1[:inter // 2])
                else:
                    args = (a2, w2[:, :inter // 2], b2_32,
                            kp.EPI_WG_BIAS_RESID)
                    kw = dict(bn=bn, resids=(r,))

                    def ref(a=a2, w=w2[:, :inter // 2], b=b2_32):
                        return r + (torch.matmul(a.float(), w.float().T)
                                    + b).bfloat16()
                    lib = (a2, w2[:, :inter // 2])
                shape = f"{product} bn={bn} <{m_bert},{lib[0].shape[1]}>" \
                        f"x<{lib[1].shape[0]},{lib[1].shape[1]}>^T"
                cases.append(("gemm_wg", shape, torch.bfloat16,
                              lambda args=args, kw=kw: kp.gemm_wg(*args,
                                                                  **kw),
                              ref))
                library[shape] = ("matmul_ms",
                                  lambda a=lib[0], w=lib[1]:
                                  torch.matmul(a, w.T))
    # K4 at the int8 teacher's trunk shape (256 images of 197 tokens, the
    # LN prologue), in both checkouts; then, where the checkout has them,
    # the trunk K4's W2 product quantizing on load beside the row pass + GEMM
    # on codes it replaced, its W1 product with the amax
    # epilogue, and K3's d1 straight to codes beside the fp32 h + row pass
    t, h, inter = smoke.T, 768, 3072
    teacher = (torch.randn(4 * smoke.B_TIME, t, h, generator=g).to(dev),
               *(x.to(dev) for x in (
                   torch.randn(inter, h, generator=g) * h ** -0.5,
                   torch.randn(inter, generator=g) * 0.1,
                   torch.randn(h, inter, generator=g) * inter ** -0.5,
                   torch.randn(h, generator=g) * 0.1)))
    t_ln = (1 + 0.1 * torch.randn(h, generator=g).to(dev),
            0.1 * torch.randn(h, generator=g).to(dev), 1e-12)
    op = functools.partial(mb.mlp_block, ln=t_ln, ln_position="prologue",
                           quant="int8")
    cases.append(("mlp_block_int8", f"teacher 768/3072 B={4 * smoke.B_TIME}",
                  torch.float32, lambda o=op: o(*teacher),
                  lambda: mb.mlp_block_int8_plain(
                      *teacher, t_ln[0], t_ln[1], ln_position="prologue",
                      ln_eps=1e-12)))
    for m in (smoke.B_TIME * t, 4 * smoke.B_TIME * t):
        w2q, w2s = kp.quant_rows(teacher[3], weight=True)
        b2 = teacher[4]
        inter_f = torch.nn.functional.gelu(
            torch.randn(m, inter, generator=g).to(dev))
        amax = inter_f.abs().amax(dim=1)
        r_qa = torch.randn(m, h, generator=g).to(dev)

        def codes_ref(a=inter_f, w=w2q, sw=w2s, b=b2, r=r_qa):
            return kp.gemm_i8(*kp.quant_rows(a), w, sw, b,
                              kp.I8_EPI_BIAS_RESID, torch.float32, resid=r)
        cases.append(("gemm_i8", f"K4 W2 row pass + codes <{m},{inter}>x"
                      f"<{h},{inter}>^T", torch.float32, codes_ref,
                      codes_ref))
        cases.append(("gemm_i8", f"K4 W2 quantize-on-load <{m},{inter}>x"
                      f"<{h},{inter}>^T", torch.float32,
                      lambda a=inter_f, am=amax, w=w2q, sw=w2s, b=b2,
                      r=r_qa: kp.gemm_i8_qa(a, am, w, sw, b, torch.float32,
                                            resid=r), codes_ref))
        if hasattr(kp, "I8_EPI_GELU_F32_AMAX"):
            xq, xs = kp.quant_rows(torch.randn(m, h, generator=g).to(dev))
            w1q, w1s = kp.quant_rows(teacher[1], weight=True)
            buf = torch.zeros(m, device=dev)
            cases.append(("gemm_i8", f"K4 W1 GELU amax <{m},{h}>x"
                          f"<{inter},{h}>^T", torch.float32,
                          lambda xq=xq, xs=xs, w=w1q, sw=w1s, buf=buf:
                          kp.gemm_i8(xq, xs, w, sw, teacher[2],
                                     kp.I8_EPI_GELU_F32_AMAX, torch.float32,
                                     amax=buf),
                          lambda xq=xq, xs=xs, w=w1q, sw=w1s:
                          kp.gemm_i8(xq, xs, w, sw, teacher[2],
                                     kp.I8_EPI_GELU_F32, torch.float32)))
    if hasattr(kp, "head_d1"):
        for m in (smoke.B_TIME * t, smoke.B_BERT * smoke.T_BERT):
            x = torch.randn(m, 96, generator=g).to(dev)
            d1w = (torch.randn(inter, 96, generator=g) * 96 ** -0.5).to(dev)
            q1, s1 = kp.quant_rows(d1w, weight=True)
            b1 = (0.1 * torch.randn(inter, generator=g)).to(dev)
            hl = (1 + 0.1 * torch.randn(96, generator=g).to(dev),
                  0.1 * torch.randn(96, generator=g).to(dev), 1e-5)

            def d1_fp32(x=x, q1=q1, s1=s1, b1=b1, hl=hl):
                return kp.quant_rows(kp.gemm_i8(
                    *kp.quant_rows(x, ln=hl), q1, s1, b1,
                    kp.I8_EPI_GELU_F32, torch.float32))
            cases.append(("gemm_i8", f"K3 d1 to codes <{m},96>x<{inter},96>"
                          f"^T", torch.float32,
                          lambda x=x, q1=q1, s1=s1, b1=b1, hl=hl:
                          kp.head_d1(x, q1, s1, b1, ln=hl), d1_fp32))
            cases.append(("gemm_i8", f"K3 d1 fp32 h + row pass <{m},96>x"
                          f"<{inter},96>^T", torch.float32, d1_fp32,
                          d1_fp32))
    for op, shape, dtype, kern, plain in cases:
        if keep and op not in keep:
            continue
        with torch.inference_mode():
            err, ok, msg = smoke.compare(kern(), plain(), dtype,
                                         op in smoke.INT8_OPS)
            if op == "gemm_i8" and "GELU" not in shape:
                ok = err == 0.0
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
            extra = {}
            if shape in library:
                # cuBLAS launches a varying number of kernels per call:
                # torch.matmul is timed with CUDA events only
                key, fn = library[shape]
                extra = {key: device_ms(fn) if key == "int_mm_device_ms"
                         else events_ms(fn)}
        print(json.dumps(dict(label=label, op=op, shape=shape,
                              dtype=str(dtype).split(".")[-1],
                              ms=start.elapsed_time(end) / REPS,
                              device_ms=dev_ms, err=err, **extra)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
