#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`autognothi_tpu_torch`) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit; build the CUDA kernels from
     `autognothi_tpu_torch/csrc/` and report the build time;
  2. kernel vs plain: every kernel op of both serving paths at the LTT
     ViT-B/16@224 shapes (B=4, T=197) in fp32 and bf16, with an all-ones
     and a random 0/1 mask, against its plain PyTorch version on the same
     card.  fp32 path: the attention block (trunk 768 with LN, side 96
     without), the MLP block (768/3072, 96/384) and the ladder (768 -> 2 x
     96).  int8 path (AUTOGNOTHI_INT8=1): the int8 attention block (same
     two shapes), the int8 MLP block (96/384), the int8 trunk MLP fused
     with both ladders (768/3072 + 2 x 96) and the int8 explainer head
     (96 -> 3072 -> 3072 -> 10);
  3. the slice through `serve`: a random LTT ViT-B/16@224 final (seeded
     torch.Generator) saved as `final-epoch-0.ckpt`, served on the card at
     batch 8, once on the fp32 path and once with AUTOGNOTHI_INT8=1; each
     time an `images` request of 3 rows and an `images_u8` request of 9
     rows (two slabs) are checked for shape, normalisation, finiteness, the
     kernel call counts per slab (fp32: 13 attention, 13 MLP, 12 ladder;
     int8: 13 int8 attention, 12 trunk MLP + ladder, 1 int8 MLP, 1 head;
     none of the other path's) and agreement with the plain-version
     forward of the same module on the same path;
  4. timing with CUDA events after warmup: explanations/s of fw_final at
     B=64 with the kernels and with the plain versions (fp32 path; int8
     path with fp32 and with bf16 parameters and pixels), and each op
     against its plain version at the path's shapes.

Any failure raises, exits non-zero and prints no result.  The last two
lines are the kernel table (JSON) and the status line (JSON).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import urllib.request
from unittest import mock

REPO = pathlib.Path(__file__).resolve().parent
OUT = REPO / "chiprun_out"
SEED = 1234
B_CHECK, B_TIME, T = 4, 64, 197
TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # x max(1, max|ref|)
# The int8 ops: kernel and plain version quantize the same values with the
# same recipe, but a value that differs in its last bit (a LayerNorm or
# softmax sum taken in another order) can land on the other side of a code
# boundary now and then, and each such flipped code moves its row by one
# quantization step (~1e-3 at these widths).  So the bound on the largest
# difference allows a few steps, and in fp32 the share of values that
# differ by more than the float tolerance must stay small.
TOL_INT8 = {"float32": 1e-2, "bfloat16": 3e-2}
FLIP_SHARE = 1e-2
INT8_OPS = ("attention_block_int8", "mlp_block_int8", "mlp_ladder_block",
            "head_block")
FP32_COUNTS = {"attention_block": 13, "mlp_block": 13, "ladder_block": 12}
INT8_COUNTS = {"attention_block_int8": 13, "mlp_ladder_block": 12,
               "mlp_block_int8": 1, "head_block": 1}

# LTT ViT-B/16@224, the flagship dims of __graft_entry__._flagship_ltt_cfg
LTT_VIT_B16 = dict(
    attention_probs_dropout_prob=0.0, explainer_s_attn_num_layers=1,
    explainer_s_head_hidden_size=3072, explainer_normalize=True,
    hidden_dropout_prob=0.0, hidden_size=768, intermediate_size=3072,
    layer_norm_eps=1e-12, num_attention_heads=12, num_hidden_layers=12,
    num_labels=10, s_attn_hidden_size=96, s_attn_intermediate_size=384,
    img_channels=3, img_px_size=224, img_patch_size=16,
)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def _plain(args_fn, plain_fn):
    def run(*args, **kwargs):
        tensors, static = args_fn(*args, **kwargs)
        return plain_fn(*tensors, **static)
    return run


def _plain_by_quant(args_fn, plain_fn, int8_fn):
    """The plain stand-in of an op that takes `quant=`."""
    def run(*args, quant="none", **kwargs):
        return _plain(args_fn, int8_fn if quant == "int8" else plain_fn)(
            *args, **kwargs)
    return run


@contextlib.contextmanager
def plain_ops():
    """Route the model's kernel ops to their plain versions (for the
    reference forward and the plain timing only)."""
    from autognothi_tpu_torch.models import ltt_vit, vit
    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import head_block as hb
    from autognothi_tpu_torch.ops import ladder_block as lb
    from autognothi_tpu_torch.ops import mlp_block as mb

    with mock.patch.object(vit, "attention_block", _plain_by_quant(
            ab.attention_block_args, ab.attention_block_plain,
            ab.attention_block_int8_plain)), \
            mock.patch.object(vit, "mlp_block", _plain_by_quant(
                mb.mlp_block_args, mb.mlp_block_plain,
                mb.mlp_block_int8_plain)), \
            mock.patch.object(vit, "explainer_head_block", _plain(
                hb.explainer_head_block_args, hb.head_int8_plain)), \
            mock.patch.object(ltt_vit, "ladder_block", _plain(
                lb.ladder_block_args, lb.ladder_block_plain)), \
            mock.patch.object(ltt_vit, "mlp_ladder_block", _plain(
                lb.mlp_ladder_block_args, lb.mlp_ladder_block_plain)):
        yield


def int8_mode(on: bool):
    """AUTOGNOTHI_INT8 = "1" (the W8A8 serving path) or "0" inside."""
    return mock.patch.dict(os.environ, {"AUTOGNOTHI_INT8": "1" if on
                                        else "0"})


def compare(got, want, dtype, int8: bool, whole: bool = False):
    """-> (max|got - want|, ok, message) over one output or a tuple.  Float
    ops: within TOL x max(1, max|want|).  int8: within TOL_INT8 x the same,
    and for one op in fp32 at most FLIP_SHARE of the values beyond the
    float bound (a whole forward carries its flips through 12 layers: the
    share is printed, not held)."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    key = str(dtype).split(".")[-1]
    scale = max(1.0, max(w.float().abs().max().item() for w in want))
    diffs = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
    err = max(d.max().item() for d in diffs)
    lim = (TOL_INT8 if int8 else TOL)[key] * scale
    ok = err <= lim and all(torch.isfinite(g).all().item() for g in got)
    msg = f"max|kernel-plain| = {err:.3e} (limit {lim:.3e})"
    if int8:
        share = (sum((d > TOL[key] * scale).sum().item() for d in diffs)
                 / sum(d.numel() for d in diffs))
        msg += f", share beyond {TOL[key]:.0e}: {share:.2e}"
        if key == "float32" and not whole:
            msg += f" (limit {FLIP_SHARE:.0e})"
            ok = ok and share <= FLIP_SHARE
    return err, ok, msg


# ------------------------------------------------------------- op inputs


def op_cases(dev, dtype, b, random_mask):
    """(name, tag, op, plain version, args, kwargs) at the serving paths'
    shapes; weights drawn like nn.Linear's init from a seeded generator."""
    import torch

    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import head_block as hb
    from autognothi_tpu_torch.ops import ladder_block as lb
    from autognothi_tpu_torch.ops import mlp_block as mb

    g = torch.Generator().manual_seed(SEED)

    def lin(d_out, d_in):
        bound_ = d_in ** -0.5
        return ((torch.rand(d_out, d_in, generator=g) * 2 - 1) * bound_
                ).to(dev), ((torch.rand(d_out, generator=g) * 2 - 1)
                            * bound_).to(dev)

    def ln(d):
        return ((1 + 0.1 * torch.randn(d, generator=g)).to(dev),
                (0.1 * torch.randn(d, generator=g)).to(dev), 1e-12)

    def act(*shape):
        return torch.randn(shape, generator=g).to(dev, dtype)

    mask = torch.ones(b, T)
    if random_mask:
        mask = (torch.rand(b, T, generator=g) > 0.4).float()
        mask[:, 0] = 1
    mask = mask.to(dev)

    attn = {"attention_block": (ab.attention_block, ab.attention_block_plain),
            "attention_block_int8": (
                functools.partial(ab.attention_block, quant="int8"),
                ab.attention_block_int8_plain)}
    cases = []
    for name, (op, plain) in attn.items():
        ws = [t for _ in range(4) for t in lin(768, 768)]
        cases.append((name, "trunk 768 LN", op,
                      _plain(ab.attention_block_args, plain),
                      (act(b, T, 768), mask, tuple(ws), 12, "mul"),
                      dict(ln=ln(768), ln_position="prologue")))
        ws = [t for _ in range(4) for t in lin(96, 96)]
        cases.append((name, "side 96 no-LN", op,
                      _plain(ab.attention_block_args, plain),
                      (act(b, T, 96), mask, tuple(ws), 12, "mul"), {}))
    mlps = (("mlp_block", 768, 3072, "trunk 768/3072", mb.mlp_block,
             mb.mlp_block_plain),
            ("mlp_block", 96, 384, "side 96/384", mb.mlp_block,
             mb.mlp_block_plain),
            ("mlp_block_int8", 96, 384, "side 96/384",
             functools.partial(mb.mlp_block, quant="int8"),
             mb.mlp_block_int8_plain))
    for name, h, inter, tag, op, plain in mlps:
        w1, b1 = lin(inter, h)
        w2, b2 = lin(h, inter)
        cases.append((name, tag, op, _plain(mb.mlp_block_args, plain),
                      (act(b, T, h), w1, b1, w2, b2),
                      dict(ln=ln(h), ln_position="prologue")))
    branches = []
    for _ in range(2):
        w = {}
        w["map_w"], w["map_b"] = lin(96, 768)
        w["ln1_w"], w["ln1_b"], _ = ln(96)
        for n in ("q", "k", "v", "o"):
            w[f"w{n}"], w[f"b{n}"] = lin(96, 96)
        w["ln2_w"], w["ln2_b"], _ = ln(96)
        w["w1"], w["b1"] = lin(384, 96)
        w["w2"], w["b2"] = lin(96, 384)
        branches.append(w)
    cases.append(("ladder_block", "768 -> 2 x 96", lb.ladder_block,
                  _plain(lb.ladder_block_args, lb.ladder_block_plain),
                  (act(b, T, 768), [act(b, T, 96), act(b, T, 96)], mask,
                   branches, 12, "mul", True, 1e-12), {}))
    trunk = {}
    trunk["w1"], trunk["b1"] = lin(3072, 768)
    trunk["w2"], trunk["b2"] = lin(768, 3072)
    trunk["ln_w"], trunk["ln_b"], _ = ln(768)
    cases.append(("mlp_ladder_block", "768/3072 + 2 x 96",
                  lb.mlp_ladder_block,
                  _plain(lb.mlp_ladder_block_args, lb.mlp_ladder_block_plain),
                  (act(b, T, 768), [act(b, T, 96), act(b, T, 96)], mask,
                   trunk, branches, 12, "mul", 1e-12), {}))
    (w1, b1), (w2, b2), (w3, b3) = lin(3072, 96), lin(3072, 3072), \
        lin(10, 3072)
    lnw, lnb, _ = ln(96)
    cases.append(("head_block", "96-3072-3072-10", hb.explainer_head_block,
                  _plain(hb.explainer_head_block_args, hb.head_int8_plain),
                  (act(b, T, 96), w1, b1, w2, b2, w3, b3, lnw, lnb, 1e-5),
                  {}))
    return cases


def counters():
    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import head_block as hb
    from autognothi_tpu_torch.ops import ladder_block as lb
    from autognothi_tpu_torch.ops import mlp_block as mb

    return {c.name: c for c in (ab.COUNTER, mb.COUNTER, lb.COUNTER,
                                ab.COUNTER_INT8, lb.COUNTER_MLP_LADDER,
                                mb.COUNTER_INT8, hb.COUNTER)}


def cuda_time(fn, reps: int) -> float:
    """Milliseconds per call, CUDA events around `reps` calls after one
    warmup call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------ phases


def phase_device() -> None:
    from autognothi_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load()
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_build.log").write_text(build.build_log)
    how = (f"nvcc {build.build_seconds:.2f} s" if build.build_seconds
           else "library already built by this checkout")
    print(f"[build] kernels from {build.CSRC.relative_to(REPO)} for sm_90a: "
          f"{how}, build+load {time.perf_counter() - t0:.2f} s "
          f"({', '.join(p.name for p in build.sources())})", flush=True)


def phase_kernels(dev) -> dict:
    import torch

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for random_mask in (False, True):
            for name, tag, op, plain, args, kw in op_cases(
                    dev, dtype, B_CHECK, random_mask):
                counter = counters()[name]
                before = counter.count
                with torch.inference_mode():
                    got = op(*args, **kw)
                    want = plain(*args, **kw)
                torch.cuda.synchronize()
                check(counter.count == before + 1,
                      f"{name}: the call did not reach the kernel")
                err, ok, msg = compare(got, want, dtype, name in INT8_OPS)
                mask_s = "random-mask" if random_mask else "ones-mask"
                print(f"[kernel] {name:20s} {tag:18s} {str(dtype):14s} "
                      f"{mask_s:11s} {msg}", flush=True)
                check(ok, f"{name} {tag} {dtype} {mask_s}: kernel disagrees "
                          f"with its plain version")
                if dtype == torch.float32:
                    worst[name] = max(worst.get(name, 0.0), err)
    return worst


def _post(port: int, payload: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/explain", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        check(resp.status == 200, f"/explain returned {resp.status}")
        return json.loads(resp.read())


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def write_experiment(tmp: pathlib.Path) -> pathlib.Path:
    """A random LTT ViT-B/16@224 final under a fresh experiment dir."""
    import torch

    from autognothi_tpu_torch import RECIPE_VERSION
    from autognothi_tpu_torch.models.ltt_vit import (LttViTConfig,
                                                     init_ltt_vit_final)
    from autognothi_tpu_torch.params import save_params, to_flat

    hp = json.loads((REPO / "experiments" / "vit_base_imagenette_vanilla"
                     / ".hparams.json").read_text())
    hp["net"] = {"kind": "ltt_vit", "version": RECIPE_VERSION,
                 "base_model": hp["net"]["base_model"],
                 "params": dict(LTT_VIT_B16)}
    exp = tmp / "ltt_vit_base"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    cfg = LttViTConfig(**LTT_VIT_B16)
    t0 = time.perf_counter()
    model = init_ltt_vit_final(cfg, torch.Generator().manual_seed(SEED))
    with torch.no_grad():  # a non-trivial null makes normalisation visible
        model.surrogate_null.fill_(0.1)
    save_params(exp / "final-epoch-0.ckpt", to_flat(model))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] LTT ViT-B/16@224 final: {n_params} parameters, seed "
          f"{SEED}, written in {time.perf_counter() - t0:.1f} s", flush=True)
    return exp


def phase_serve(dev, exp: pathlib.Path, int8: bool):
    """Serve the experiment on one path; -> (kernel calls, service, the
    responses by request kind)."""
    import numpy as np
    import torch

    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import serve_in_thread

    path = "int8" if int8 else "fp32"
    per_slab = INT8_COUNTS if int8 else FP32_COUNTS
    env = ExpEnv(exp)
    with int8_mode(int8):
        t0 = time.perf_counter()
        server, service, thread = serve_in_thread(env, port=0, batch_size=8,
                                                  device="cuda")
        port = server.server_address[1]
        print(f"[serve {path}] server up on the card in "
              f"{time.perf_counter() - t0:.1f} s (warmup: f32 + u8 slabs)",
              flush=True)
        try:
            check(_get(port, "/healthz") == {"status": "ok"}, "healthz")
            slabs0 = _get(port, "/statz")["slabs"]
            rng = np.random.RandomState(SEED)
            requests = {"images": rng.rand(3, 3, 224, 224).astype(np.float32),
                        "images_u8": rng.randint(0, 256, (9, 3, 224, 224)
                                                 ).astype(np.uint8)}
            for c in counters().values():
                c.reset()
            got = {kind: _post(port, {kind: rows.tolist()})
                   for kind, rows in requests.items()}
            launches = {name: c.count for name, c in counters().items()}
            slabs = _get(port, "/statz")["slabs"] - slabs0
        finally:
            server.shutdown()
            server.server_close()
            service.close()
            thread.join(timeout=60)
        check(not thread.is_alive(), "server thread did not stop")
        env.close()

        expected = {name: per_slab.get(name, 0) * slabs for name in launches}
        print(f"[serve {path}] {slabs} slabs; kernel calls {launches} "
              f"(expected {expected})", flush=True)
        check(slabs == 3, f"expected 3 slabs (1 f32 + 2 u8), got {slabs}")
        check(launches == expected,
              f"{path} kernel call counts differ from {per_slab} per slab")

        for kind, rows in requests.items():
            logits = np.asarray(got[kind]["logits"], np.float32)
            attr = np.asarray(got[kind]["attributions"], np.float32)
            n = rows.shape[0]
            check(logits.shape == (n, 10), f"{kind}: logits {logits.shape}")
            check(attr.shape == (n, 10, 196), f"{kind}: attr {attr.shape}")
            check(bool(np.abs(logits.sum(-1) - 1).max() < 1e-4),
                  f"{kind}: probabilities do not sum to 1")
            xs = torch.as_tensor(rows).to(dev)
            if xs.dtype == torch.uint8:
                xs = xs.float() * (1.0 / 255.0)
            with plain_ops(), torch.inference_mode():
                ref = service.recipe.fw_final(service.m_config, service.model,
                                              xs)
            for what, mine, want in (("logits", logits, ref[0]),
                                     ("attributions", attr, ref[1])):
                _, ok, msg = compare(torch.from_numpy(mine), want.cpu(),
                                     torch.float32, int8, whole=True)
                print(f"[serve {path}] {kind:9s} {what:12s} "
                      f"{tuple(mine.shape)} served vs plain forward: {msg}",
                      flush=True)
                check(ok, f"{path} {kind} {what}: served response differs "
                          f"from the plain forward")
    return launches, service, got


def time_fw_final(label: str, fw, fw_plain, dtype, int8: bool,
                  card: str) -> None:
    """Check the kernel forward against the plain one at B_TIME, then time
    both in the order plain, kernels, kernels, plain."""
    got, want = fw(), fw_plain()
    _, ok, msg = compare(got, want, dtype, int8, whole=True)
    print(f"[time] fw_final {label} B={B_TIME} {msg}", flush=True)
    check(ok, f"fw_final {label} B={B_TIME}: kernels disagree with plain")
    rates = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain"):
        ms = cuda_time(fw_plain if which == "plain" else fw, reps=3)
        rates[which].append(B_TIME / (ms / 1e3))
    for which, vals in rates.items():
        print(f"[time] fw_final LTT ViT-B/16@224 {label} B={B_TIME} "
              f"{which:7s}: {' '.join(f'{v:.2f}' for v in vals)} expl/s | "
              f"{card}", flush=True)


def phase_timing(dev, card: str, service) -> dict:
    import torch

    model, cfg, recipe = service.model, service.m_config, service.recipe
    xs = torch.rand((B_TIME, 3, 224, 224),
                    generator=torch.Generator().manual_seed(SEED)).to(dev)
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)

    def forward(m, x, int8: bool, plain: bool):
        def run():
            with int8_mode(int8), torch.inference_mode(), \
                    (plain_ops() if plain else contextlib.nullcontext()):
                return recipe.fw_final(cfg, m, x)
        return run

    # at B=64 the GEMMs take their large-tile variant: checked here too
    for label, m, x, dtype, int8 in (
            ("fp32", model, xs, torch.float32, False),
            ("int8 fp32", model, xs, torch.float32, True),
            ("int8 bf16", model_bf16, xs.to(torch.bfloat16), torch.bfloat16,
             True)):
        time_fw_final(label, forward(m, x, int8, False),
                      forward(m, x, int8, True), dtype, int8, card)
    del model_bf16

    per_op = {}
    for name, tag, op, plain, args, kw in op_cases(dev, torch.float32,
                                                   B_TIME, False):
        with torch.inference_mode():
            _, ok, msg = compare(op(*args, **kw), plain(*args, **kw),
                                 torch.float32, name in INT8_OPS)
            t_plain = cuda_time(lambda: plain(*args, **kw), reps=10)
            t_kern = cuda_time(lambda: op(*args, **kw), reps=10)
        print(f"[time] {name:20s} {tag:18s} fp32 B={B_TIME}: kernel "
              f"{t_kern:.4f} ms, plain {t_plain:.4f} ms ({msg}) | {card}",
              flush=True)
        check(ok, f"{name} {tag} B={B_TIME}: kernel disagrees")
        per_op.setdefault(name, (t_kern, t_plain))  # first = trunk shape
    print(f"[time] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB | {card}",
          flush=True)
    return per_op


# name -> (source, the TPU kernel it replaces: its pl.pallas_call)
KERNELS = {
    "attention_block": ("autognothi_tpu_torch/csrc/attention.cu",
                        "autognothi_tpu/ops/attention_block.py:283"),
    "mlp_block": ("autognothi_tpu_torch/csrc/gemm.cu",
                  "autognothi_tpu/ops/mlp_block.py:191"),
    "ladder_block": ("autognothi_tpu_torch/csrc/gemm.cu",
                     "autognothi_tpu/ops/ladder_block.py:390"),
    "attention_block_int8": ("autognothi_tpu_torch/csrc/int8.cu",
                             "autognothi_tpu/ops/attention_block.py:245"),
    "mlp_ladder_block": ("autognothi_tpu_torch/csrc/int8.cu",
                         "autognothi_tpu/ops/ladder_block.py:527"),
    "head_block": ("autognothi_tpu_torch/csrc/int8.cu",
                   "autognothi_tpu/ops/head_block.py:138"),
    "mlp_block_int8": ("autognothi_tpu_torch/csrc/int8.cu",
                       "autognothi_tpu/ops/mlp_block.py:163"),
}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    from autognothi_tpu_torch.utils.devices import resolve_device

    dev = resolve_device("cuda:0")
    name = torch.cuda.get_device_name(0)
    card = nvidia_smi_line()
    print(f"[device] {name} | nvidia-smi: {card} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | python {sys.version.split()[0]}",
          flush=True)
    phase_device()
    worst = phase_kernels(dev)
    with tempfile.TemporaryDirectory() as tmp:
        exp = write_experiment(pathlib.Path(tmp))
        launches, service, got_fp32 = phase_serve(dev, exp, int8=False)
        launches_int8, _, got_int8 = phase_serve(dev, exp, int8=True)
    for kind in got_fp32:
        for what in ("logits", "attributions"):
            diff = np.abs(np.asarray(got_int8[kind][what], np.float32)
                          - np.asarray(got_fp32[kind][what], np.float32))
            print(f"[serve] {kind:9s} {what:12s} max|int8 - fp32| = "
                  f"{diff.max():.3e} (W8A8 vs fp32 path, not held)",
                  flush=True)
    launches.update({k: launches_int8[k] for k in INT8_COUNTS})
    per_op = phase_timing(dev, card, service)

    kernels = [{"name": k, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[k],
                "max_abs_err": worst[k], "ms": per_op[k][0],
                "plain_ms": per_op[k][1]}
               for k, (source, replaces) in KERNELS.items()]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']}: no launch on the main path")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
