#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`autognothi_tpu_torch`) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit; build the CUDA kernels from
     `autognothi_tpu_torch/csrc/` and report the build time and the
     registers, shared memory and spills (`-Xptxas -v`) of the tensor-core
     GEMM, the attention core, the int8 and the float wgmma GEMMs, the
     float GEMM's row pass and the three ladder stage kernels;
  2. kernel vs plain: every kernel op at the LTT ViT-B/16@224 shapes (B=4,
     T=197) in fp32 and bf16, with an all-ones and a random 0/1 mask,
     against its plain PyTorch version on the same card.  fp32 path: the
     attention block (trunk 768 with LN, side 96 without), the MLP block
     (768/3072, 96/384) and the ladder (768 -> 2 x 96 and 1 x 96).  int8
     path
     (AUTOGNOTHI_INT8=1): the int8 attention block (same two shapes), the
     int8 MLP block (96/384, 768/3072), the int8 trunk MLP fused with both
     ladders (768/3072 + 2 x 96) and the int8 explainer head (96 -> 3072 ->
     3072 -> 10).  Training: the masked attention op (K9) over 4 coalitions
     per image, d = 64 and d = 8, "add" and "mul"; the ladder attention op
     (K10) over two 96-wide branches, both modes.  Then the LTT
     BERT-base@512 shapes (B=4, T=512, BERT's additive bias): the float
     attention block (K6) and, in bf16, the int8 one (K1), trunk 768 with
     the LN epilogue; the trunk MLP 768/3072 (K7; in bf16 the 2-tile float
     chain) and its int8 split (K8q, 2 tiles, one launch each); the ladder
     (768 -> 2 x 96, "add", post-norm); the int8 head without LN (96 ->
     3072 -> 3072 -> 2); the masked attention op at <4, 12, 512, 64>, both
     modes (T = 512 at d = 64 walks the keys in chunks);
  3. the slice through `serve`: a random LTT ViT-B/16@224 final (seeded
     torch.Generator) saved as `final-epoch-0.ckpt`, served on the card at
     batch 8, once on the fp32 path and once with AUTOGNOTHI_INT8=1; each
     time an `images` request of 3 rows and an `images_u8` request of 9
     rows (two slabs) are checked for shape, normalisation, finiteness, the
     kernel call counts per slab (fp32: 13 attention, 13 MLP, 12 ladder;
     int8: 13 int8 attention, 12 trunk MLP + ladder, 1 int8 MLP, 1 head;
     none of the other path's) and agreement with the plain-version
     forward of the same module on the same path.  The same for a random
     LTT BERT-base@512 final (`experiments/bert_base_tayp_ltt` dims, full
     depth, a `build_vocab` vocabulary under `<exp>/tokenizer/`): `texts`
     requests of 3 and 9 rows, kernel calls per slab fp32: 13 attention, 13
     MLP, 12 ladder; int8 (fp32 parameters): 12 float attention (the int8
     block does not fit the JAX budget), 1 int8 attention, 24 K8q tiles, 1
     int8 MLP, 12 ladder, 1 head;
  4. the training slice through `train_explainer`: a random LTT
     ViT-B/16@224 surrogate and explainer (seeded torch.Generator) saved
     as the JAX package's npz checkpoints beside a `cv_samples` experiment
     at 224 px, B = 8 images x M = 32 coalitions per step.  First single
     steps on one batch and one set of masks, in pallas mode "2" (the
     default: int8 teacher K1 + K4 + K5, v_1 K1 + K2, forward K6 + K7 + K5)
     and in mode "1" (every attention through the masked attention op K9),
     each held against the same step with every kernel op replaced by its
     plain version (loss within 1e-4 relative with the fp32 teacher,
     AUTOGNOTHI_INT8_TEACHER=0; 1e-2 with the int8 teacher), with the
     kernel launches of one step checked against the expected table; then
     one epoch (2 train steps, 1 eval step) through the CLI entry point in
     each mode, whose launch counts must be 3 x the step's;
  5. timing with CUDA events after warmup: explanations/s of fw_final at
     B=64 with the kernels and with the plain versions (fp32 path; int8
     path with fp32 and with bf16 parameters and pixels), and of the LTT
     BERT-base@512 fw_final at B=8 on the same three paths and with bf16
     parameters without int8 (the 2-tile float chain, K8), each first held
     against its plain forward, its kernel calls against the path's table
     (those four counted forwards are main paths of the kernel line), with
     each BERT-shape op at B=8 beside its bound; the float GEMM beside
     `torch.matmul` (fp32 with TF32 off, and bf16) at K7's two products and
     the attention core beside SDPA in fp32 and bf16 at K9's two shapes
     (timed only); one profiled forward of each ViT and BERT path; the
     train step's
     ms/step and masked forwards/s (B x M per step) with the kernels and
     with the plain versions in both modes, its peak device memory, its
     split into teacher, forward, backward and AdamW (CUDA events at the
     step's `record_function` spans: the profiler attributes no device
     time to the backward span, whose ops the autograd engine runs on its
     own thread), and one profiled step's kernels and device idle share;
     and
     each op against its plain version at the path's shapes, beside its
     bound (bytes over 3.35 TB/s or operations over the peak the JAX
     numerics allow, fp32 products at the 3xTF32 rate, whichever is
     larger) and, for the masked attention op
     in "add" mode, `F.scaled_dot_product_attention` on the same inputs
     (timed only; the port never calls it); the int8 GEMM (TMA + wgmma)
     alone beside `torch._int_mm` at K1's and K2's four products (Q|K|V
     2304x768, out 768x768, W1 3072x768, W2 768x3072) at M = 12608 (ViT
     B=64) and M = 50432 (the train step's teacher), CUDA events and
     profiler device time, beside the bound, the bias and residual
     epilogues held bit-identical to the same steps on `torch._int_mm`'s
     sum; every profile line gives the int8 GEMMs' and the quantizer's
     share of the kernel time; the float TMA + wgmma GEMM alone at K6's
     two products (Q|K|V 2304x768 with bias, out 768x768 with the
     residual) at M = 12608 and 4096, fp32 and bf16, beside `torch.matmul`
     and the bound and held against the float64 product; the kernels of
     one K5 and one K6 call at both trunk
     shapes with their device times (one ladder step at most four
     launches); K5 and K6 (and K2) held against their plain versions in
     bf16 at B=64 too; the split MLP chains at BERT-base@512 B=8 (K8q
     with fp32 and with bf16 parameters, the bf16 K8), each one's CUDA-
     event and device ms beside its bound and beside `torch._int_mm`
     (K8q) or bf16 `torch.matmul` (K8) on the same products; the kernels
     of one int8 MLP block (K4) and one int8 head (K3) call at the main
     paths' shapes (`[launches]`: the narrow K4 one launch, the trunk K4 at
     most three and BERT's post-norm LN, K3 at most three and none of
     `csrc/gemm.cu`); K4 at the int8 teacher's trunk shape (256 images of
     197 tokens, 768/3072), held against its plain version, its launches,
     CUDA-event and device ms beside its bound and `torch._int_mm` on the
     same two products (`[k4-teacher]`); the K3 and K4 rows of the kernel
     line carry the same products on `torch._int_mm` (and K3's d3 on
     `torch.matmul`) as their library time.

  6. the training pipeline through `train_all`: a `random_init` LTT
     ViT-B/16@224 experiment on `cv_samples` at 224 px (2 train batches
     and 1 test batch of 8, one epoch per trainer, the surrogate's
     progressive, dropout 0) through `python -m autognothi_tpu_torch
     train_all <exp> --device cuda` (`cli_main`): each of the seven
     stages' kernel calls against its steps' and forwards' (the
     classifier's and the surrogate's steps counted in their own check,
     the explainer's from phase 4, the final's conversion its null forward
     and the coherency check's four forwards), the coherency line
     (`cls_diff`, `exp_diff` on the card, limit 1e-5), `serve` of the
     written `final-epoch-0.ckpt` answering an `images` request of 3 rows
     against its plain forward, a rerun at `current stage: 7 / 7`; one
     classifier step and one surrogate step (fp32 teacher, and the int8
     teacher, AUTOGNOTHI_INT8=1: K1 + K2) against the same step on the
     plain versions (loss within 1e-4 relative, 1e-2 with the int8
     teacher), their ms/step with the kernels and plain in turns; and,
     under AUTOGNOTHI_CKPT_OPT=1, 2 surrogate epochs against 1 followed by
     a resumed 1, bit for bit (full depth).  With the timing phase
     (`[launches] ladder_block route=per_branch`): K5 at the sides the
     stage kernels do not take ((side, heads) = (192, 12), (256, 16),
     (384, 12), d = 16, 16, 32; F7), its route, launches and device time,
     against its plain version.
  7. the reports through `run_all`: a fresh copy of phase 6's experiment
     (the same widths, depth and data) with eval blocks (faithfulness at
     16 stops over the 8 test images: 10 classes x 16 stops x 2 = 320
     coalitions an image; accuracy at 5 masked counts; cls_acc at every
     explainer epoch; performance over 2 loops at batch 1; train resources
     over 16 images at batch 8; CKA at batch 8) through `python -m
     autognothi_tpu_torch run_all <exp> --device cuda` (`cli_main`): the
     six report files, the kernels each report launched (K6, K7 and K5 in
     every one), a second `measure_all` that reloads them and launches
     nothing; the quality gate: faithfulness's four AUCs with the kernels
     against the same report under the plain versions on the card, on the
     same checkpoints (fp32 within 1e-3; W8A8, AUTOGNOTHI_INT8=1, within
     5e-3, launching K1, K2, K4, K3 and K5; pallas mode "1" within 1e-3,
     launching K9), the worst drift and its curve printed; cls_acc and
     accuracy equal to the plain run's, or each difference a named argmax
     flip the plain forward nearly ties; the performance report's ms per
     sample, GFLOPs and MiB per stage and the train resources' seconds and
     MiB per step, each beside the card.  With the timing phase: F8, K6
     and K1 at ViT-B/16@384's trunk (B=8, T=577) against their plain
     versions with device ms, and the core there beside SDPA (`[f8]`);
     F7, a side of d = 4 (96 in 24 heads, and the mini configurations' 16
     in 4) on the per-branch route against its plain version, and the
     core's d = 128 instance beside d = 64 (`[f7]`).

Any failure raises, exits non-zero and prints no result.  The last three
lines are the card, the kernel table (JSON) and the status line (JSON).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
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
            "head_block", "mlp_block_int8_tiled")
FP32_COUNTS = {"attention_block": 13, "mlp_block": 13, "ladder_block": 12}
INT8_COUNTS = {"attention_block_int8": 13, "mlp_ladder_block": 12,
               "mlp_block_int8": 1, "head_block": 1}
# LTT BERT-base@512, kernel calls per slab (12 trunk layers, 12 ladder
# steps, one explainer side layer, the head).  fp32: the float blocks (the
# fp32 MLP split only reorders a sum: one K7 call).  int8 with fp32
# parameters: the int8 trunk attention does not fit the JAX budget and
# runs float (K6); the trunk MLP is the 2-tile int8 chain (K8q, one call
# per tile); the 96-wide side layer K1 + K4; the head K3.  int8 with bf16
# parameters: the trunk attention is K1.
BERT_COUNTS = {
    "fp32": {"attention_block": 13, "mlp_block": 13, "ladder_block": 12},
    "int8": {"attention_block": 12, "attention_block_int8": 1,
             "mlp_block_int8_tiled": 24, "mlp_block_int8": 1,
             "ladder_block": 12, "head_block": 1},
    "int8 bf16": {"attention_block_int8": 13, "mlp_block_int8_tiled": 24,
                  "mlp_block_int8": 1, "ladder_block": 12, "head_block": 1},
    # bf16 parameters, int8 off: the trunk MLP is the 2-tile float chain
    # (K8, one call per tile); the side layer's MLP fits one block
    "bf16": {"attention_block": 13, "mlp_block_tiled": 24, "mlp_block": 1,
             "ladder_block": 12},
}
B_BERT_CHECK, B_BERT, T_BERT = 4, 8, 512
# kernel calls of one BERT-shape op call where it is not one: the chains of
# int8 tiles and of bf16 float tiles
BERT_CALLS_PER_OP = {("mlp_block_int8_tiled", "float32"): 2,
                     ("mlp_block_int8_tiled", "bfloat16"): 2,
                     ("mlp_block_tiled", "bfloat16"): 2}
# kernel calls of one explainer train step (B = 8, M = 32) at 12 layers,
# by (pallas mode, teacher).  Default ("2", int8 teacher): teacher K1 + K4
# + K5 x 12 (B*M = 256 images), v_1 K1 + K2 x 12, differentiated forward
# K6 + K7 x 13 and K5 x 12.  The fp32 teacher (AUTOGNOTHI_INT8_TEACHER=0)
# runs K6 + K7 + K5 in the teacher and v_1.  Mode "1": the masked
# attention op only, 24 + 24 + 25.  The backward launches none.
STEP_COUNTS = {("2", "int8"): {"attention_block_int8": 24,
                               "mlp_ladder_block": 12, "mlp_block_int8": 12,
                               "ladder_block": 24, "attention_block": 13,
                               "mlp_block": 13},
               ("2", "fp32"): {"attention_block": 37, "mlp_block": 37,
                               "ladder_block": 36},
               ("1", "fp32"): {"masked_attention": 73}}
# the teacher the CLI run takes by default: int8 in mode "2"; mode "1"
# never quantizes.  Besides its 3 steps, the run computes surrogate_null,
# one fp32 surrogate forward of the null image: 12 trunk layers and 12
# ladder steps
CLI_TEACHER = {"2": "int8", "1": "fp32"}
NULL_COUNTS = {"2": {"attention_block": 12, "mlp_block": 12,
                     "ladder_block": 12},
               "1": {"masked_attention": 24}}
TRAIN_B, TRAIN_M = 8, 32
STEP_TOL = {"fp32": 1e-4, "int8": 1e-2}  # relative, the step's loss
# peak rates of one H100 SXM (NVIDIA data sheet, dense) and its memory rate.
# fp32 float products are fp32-grade work the card does on its tensor cores
# as 3xTF32 (three TF32 products each): 495 / 3 TFLOP/s
PEAK = {"fp32": 495e12 / 3, "bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12

# LTT ViT-B/16@224, the flagship dims of __graft_entry__._flagship_ltt_cfg
LTT_VIT_B16 = dict(
    attention_probs_dropout_prob=0.0, explainer_s_attn_num_layers=1,
    explainer_s_head_hidden_size=3072, explainer_normalize=True,
    hidden_dropout_prob=0.0, hidden_size=768, intermediate_size=3072,
    layer_norm_eps=1e-12, num_attention_heads=12, num_hidden_layers=12,
    num_labels=10, s_attn_hidden_size=96, s_attn_intermediate_size=384,
    img_channels=3, img_px_size=224, img_patch_size=16,
)
# LTT BERT-base@512: experiments/bert_base_tayp_ltt/.hparams.json, read at
# run time.  A short corpus for the WordPiece vocabulary the served
# `texts` are tokenized with (`build_vocab`; the trained model's 30,522-id
# vocabulary is not in the repo).
BERT_EXP = REPO / "experiments" / "bert_base_tayp_ltt" / ".hparams.json"
CORPUS = [
    "the service was outstanding and the staff made us feel at home",
    "absolutely delicious food with generous portions at a fair price",
    "the room was dirty, the shower was broken and nobody cared",
    "we waited an hour for cold pasta; never again.",
    "a wonderful little cafe with friendly baristas and great pastries",
    "terrible customer service, rude managers and overpriced drinks",
    "the repair crew arrived on time and fixed everything perfectly",
    "mediocre burgers, but the fries were crisp and the beer was cold",
    "I'd recommend the tasting menu: seven courses, each one a surprise!",
    "parking was impossible and the line went around the block",
    "clean rooms, quiet street, and a breakfast worth waking up for",
    "the doctor listened carefully and explained every option to me",
]


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


def _dispatch_plain(launch, plain, counter, tensors, static, grad=None):
    """`dispatch` as it routes CPU tensors: the plain version (with `grad`
    as its gradient where one is wanted), whatever the device."""
    import torch

    from autognothi_tpu_torch.kernels.primitives import _KernelFn

    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors)
    if grad is None or not needs_grad:
        return plain(*tensors, **static)
    return _KernelFn.apply(functools.partial(plain, **static),
                           functools.partial(grad, **static), *tensors)


@contextlib.contextmanager
def plain_ops():
    """Route every kernel op to its plain version (for the reference
    forward and the plain timing only): each op's `dispatch` takes the
    plain branch on the card too, so the ops' own gates still choose the
    arithmetic (the BERT tile split, the float fallbacks)."""
    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import flash_attention as fa
    from autognothi_tpu_torch.ops import head_block as hb
    from autognothi_tpu_torch.ops import ladder_block as lb
    from autognothi_tpu_torch.ops import mlp_block as mb

    with contextlib.ExitStack() as stack:
        for mod in (ab, fa, hb, lb, mb):
            stack.enter_context(mock.patch.object(mod, "dispatch",
                                                  _dispatch_plain))
        yield


def _under_plain(op):
    """The op with its kernels routed to their plain versions."""
    def run(*args, **kwargs):
        with plain_ops():
            return op(*args, **kwargs)
    return run


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
    from autognothi_tpu_torch.ops import flash_attention as fa
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
             mb.mlp_block_int8_plain),
            # the teacher's trunk MLP (at B*M images on the train path)
            ("mlp_block_int8", 768, 3072, "trunk 768/3072",
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
    for n_branches in (2, 1):  # the final forward; the teacher sweep
        cases.append(("ladder_block", f"768 -> {n_branches} x 96",
                      lb.ladder_block,
                      _plain(lb.ladder_block_args, lb.ladder_block_plain),
                      (act(b, T, 768),
                       [act(b, T, 96) for _ in range(n_branches)], mask,
                       branches[:n_branches], 12, "mul", True, 1e-12), {}))
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
    # the masked attention op over 4 coalitions per image (the teacher's
    # B*M masked copies: <256, 12, 197, 64> at B=64), trunk d=64 and side
    # d=8; "add" first: its row carries the library yardstick
    n = 4 * b
    row = (torch.rand(n, T, generator=g) > 0.4).float() if random_mask \
        else torch.ones(n, T)
    row[:, 0] = 1
    rows = {"mul": row.to(dev),
            "add": ((1 - row) * torch.finfo(torch.float32).min).to(dev)}
    for d in (64, 8):
        q, k, v = (act(n, 12, T, d) for _ in range(3))
        for mode in ("add", "mul"):
            cases.append(("masked_attention", f"<{n},12,{T},{d}> {mode}",
                          functools.partial(fa.masked_attention, mode=mode),
                          functools.partial(fa.masked_attention_plain,
                                            mode=mode),
                          (q, k, v, rows[mode]), {}))
    # the ladder attention core for both 96-wide branches at once
    qkvs = [tuple(act(b, T, 96) for _ in range(3)) for _ in range(2)]
    for mode in ("mul", "add"):
        mrow = rows[mode][:b]
        cases.append(("ladder_attention", f"2 x <{b},{T},96> {mode}",
                      lb.ladder_attention,
                      functools.partial(_ladder_attention_plain, mode=mode),
                      (qkvs, mrow, 12, mode), {}))
    return cases


def bert_op_cases(dev, dtype, b, random_mask):
    """(name, tag, op, plain version, args, kwargs) at the LTT BERT-base@512
    shapes: the trunk attention block ("add" bias, LN epilogue; K6, and K1
    in bf16, where it fits the JAX budget), the trunk MLP (K7) and its int8
    split (K8q), the ladder op (768 -> 2 x 96, "add", post-norm), the head
    without LN (96 -> 3072 -> 3072 -> 2), the masked attention op at <b,
    12, 512, 64> and the explainer side layer's attention and MLP blocks
    (K6/K1, K7/K4).  Each plain
    version is the same op with its kernels routed to their plain versions
    (the ops' gates still choose the arithmetic)."""
    import torch

    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import flash_attention as fa
    from autognothi_tpu_torch.ops import head_block as hb
    from autognothi_tpu_torch.ops import ladder_block as lb
    from autognothi_tpu_torch.ops import mlp_block as mb

    g = torch.Generator().manual_seed(SEED + 1)
    t, h, inter, s = T_BERT, 768, 3072, 96

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

    keep = torch.ones(b, t)
    if random_mask:
        keep = (torch.rand(b, t, generator=g) > 0.3).float()
        keep[:, 0] = 1
    # the additive bias in the activation dtype, as `additive_mask_bias`
    # makes it for the model
    bias = ((1 - keep.to(dtype)) * torch.finfo(dtype).min).to(dev)
    cases = []
    ws = tuple(x for _ in range(4) for x in lin(h, h))
    attn = [("attention_block", ab.attention_block)]
    if dtype == torch.bfloat16:
        attn.append(("attention_block_int8",
                     functools.partial(ab.attention_block, quant="int8")))
    for name, op in attn:
        cases.append((name, "trunk 768 add LN-epi", op, _under_plain(op),
                      (act(b, t, h), bias, ws, 12, "add"),
                      dict(ln=ln(h), ln_position="epilogue")))
    (w1, b1), (w2, b2) = lin(inter, h), lin(h, inter)
    # in bf16 the float trunk MLP is the 2-tile chain (K8)
    float_mlp = "mlp_block_tiled" if dtype == torch.bfloat16 else "mlp_block"
    for name, op in ((float_mlp, mb.mlp_block),
                     ("mlp_block_int8_tiled",
                      functools.partial(mb.mlp_block, quant="int8"))):
        cases.append((name, "trunk 768/3072 LN-epi", op, _under_plain(op),
                      (act(b, t, h), w1, b1, w2, b2),
                      dict(ln=ln(h), ln_position="epilogue")))
    branches = []
    for _ in range(2):
        w = {}
        w["map_w"], w["map_b"] = lin(s, h)
        w["ln1_w"], w["ln1_b"], _ = ln(s)
        for n in ("q", "k", "v", "o"):
            w[f"w{n}"], w[f"b{n}"] = lin(s, s)
        w["ln2_w"], w["ln2_b"], _ = ln(s)
        w["w1"], w["b1"] = lin(4 * s, s)
        w["w2"], w["b2"] = lin(s, 4 * s)
        branches.append(w)
    cases.append(("ladder_block", "768 -> 2 x 96 add post",
                  lb.ladder_block, _under_plain(lb.ladder_block),
                  (act(b, t, h), [act(b, t, s), act(b, t, s)], bias,
                   branches, 12, "add", False, 1e-12), {}))
    (w1, b1), (w2, b2), (w3, b3) = lin(3072, s), lin(3072, 3072), lin(2, 3072)
    cases.append(("head_block", "96-3072-3072-2 no-LN",
                  hb.explainer_head_block,
                  _under_plain(hb.explainer_head_block),
                  (act(b, t, s), w1, b1, w2, b2, w3, b3, None, None, 1e-5),
                  {}))
    rows = {"add": bias, "mul": keep.to(dev)}
    q, k, v = (act(b, 12, t, 64) for _ in range(3))
    for mode in ("add", "mul"):
        op = functools.partial(fa.masked_attention, mode=mode)
        cases.append(("masked_attention", f"<{b},12,{t},64> {mode}", op,
                      _under_plain(op), (q, k, v, rows[mode]), {}))
    # the explainer's 96-wide side layer as the model calls it: attention
    # without LN (`ident_ln1`), the MLP with its LN epilogue; float (K6,
    # K7) and int8 (K1, K4)
    ws = tuple(x for _ in range(4) for x in lin(s, s))
    (w1, b1), (w2, b2) = lin(4 * s, s), lin(s, 4 * s)
    ln_s = ln(s)
    for quant, attn_name, mlp_name in (
            ("none", "attention_block", "mlp_block"),
            ("int8", "attention_block_int8", "mlp_block_int8")):
        op = functools.partial(ab.attention_block, quant=quant)
        cases.append((attn_name, "side 96 add no-LN", op, _under_plain(op),
                      (act(b, t, s), bias, ws, 12, "add"),
                      dict(ln=None, ln_position="epilogue")))
        op = functools.partial(mb.mlp_block, quant=quant)
        cases.append((mlp_name, "side 96/384 LN-epi", op, _under_plain(op),
                      (act(b, t, s), w1, b1, w2, b2),
                      dict(ln=ln_s, ln_position="epilogue")))
    return cases


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def op_bound(name: str, args: tuple) -> tuple:
    """-> (bound_ms, "bytes" | "operations") of one call of an op case: the
    larger of the bytes it must move (each input read once, each output
    written once) over the memory rate and its operations over the peak
    the JAX numerics allow (int8 products at the int8 rate; float products
    at the fp32-grade 3xTF32 rate for fp32 inputs, the bf16 tensor-core
    rate for bf16)."""
    import torch

    x = args[0] if hasattr(args[0], "dtype") else args[0][0][0]
    fkey = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    ops = {"fp32": 0.0, "bf16": 0.0, "int8": 0.0}

    def attention(b, t, h):  # Q.K^T and P.V
        return 4.0 * b * t * t * h

    if name in ("masked_attention", "ladder_attention"):
        if name == "masked_attention":
            q, k, v, mask = args
            streams = [q, k, v, q]  # inputs and the output
            n, heads, t, d = q.shape
            ops[fkey] = attention(n, t, heads * d)
        else:
            qkvs, mask = args[0], args[1]
            streams = [a for tr in qkvs for a in (*tr, tr[0])]
            ops[fkey] = sum(attention(*tr[0].shape) for tr in qkvs)
        moved = _nbytes(*streams, mask)
    else:
        b, t, h = x.shape
        m = b * t

        def leaves(a):
            if hasattr(a, "numel"):
                return [a]
            if isinstance(a, dict):
                a = list(a.values())
            if isinstance(a, (list, tuple)):
                return [t for item in a for t in leaves(item)]
            return []

        # weights and activations read; the outputs are added below
        moved = _nbytes(*leaves(args))
        wkey = "int8" if name in INT8_OPS else fkey
        if name.startswith("attention_block"):
            ops[wkey] += 2.0 * m * h * 4 * h
            ops[fkey] += attention(b, t, h)
            moved += _nbytes(x)
        elif name.startswith("mlp_block"):
            inter = args[1].shape[0]
            ops[wkey] += 4.0 * m * h * inter
            moved += _nbytes(x)
        elif name in ("ladder_block", "mlp_ladder_block"):
            sides = args[1]
            branches = args[4] if name == "mlp_ladder_block" else args[3]
            if name == "mlp_ladder_block":
                trunk = args[3]
                ops["int8"] += 4.0 * m * h * trunk["w1"].shape[0]
                moved += _nbytes(x)  # h written
            for side, w in zip(sides, branches):
                s, si = side.shape[-1], w["w1"].shape[0]
                ops[fkey] += (2.0 * m * h * s + 2.0 * m * s * 4 * s
                              + attention(b, t, s) + 4.0 * m * s * si)
                moved += _nbytes(side)  # the updated side written
        elif name == "head_block":
            w1, w2, w3 = args[1], args[3], args[5]
            ops["int8"] += 2.0 * m * (w1.shape[1] * w1.shape[0]
                                      + w2.shape[1] * w2.shape[0])
            ops[fkey] += 2.0 * m * w3.shape[1] * w3.shape[0]
            moved += m * w3.shape[0] * x.element_size()
    t_ops = sum(v / PEAK[k] for k, v in ops.items())
    t_bytes = moved / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _ladder_attention_plain(qkvs, mask_row, n_heads, _mode, *, mode):
    from autognothi_tpu_torch.ops import ladder_block as lb

    return lb.ladder_attention_plain(mask_row, *(x for tr in qkvs for x in tr),
                                     n_heads=n_heads, mode=mode)


def counters():
    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import flash_attention as fa
    from autognothi_tpu_torch.ops import head_block as hb
    from autognothi_tpu_torch.ops import ladder_block as lb
    from autognothi_tpu_torch.ops import mlp_block as mb

    return {c.name: c for c in (ab.COUNTER, mb.COUNTER, lb.COUNTER,
                                ab.COUNTER_INT8, lb.COUNTER_MLP_LADDER,
                                mb.COUNTER_INT8, hb.COUNTER, fa.COUNTER,
                                lb.COUNTER_ATTENTION,
                                mb.COUNTER_INT8_TILED, mb.COUNTER_TILED)}


def read_counts() -> dict:
    return {name: c.count for name, c in counters().items()}


def reset_counts() -> None:
    for c in counters().values():
        c.reset()


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
    log = build.compiler_log()
    (OUT / "chip_smoke_build.log").write_text(log)
    how = (f"nvcc {build.build_seconds:.2f} s" if build.build_seconds
           else "library already built by this checkout")
    print(f"[build] kernels from {build.CSRC.relative_to(REPO)} for sm_90a: "
          f"{how}, build+load {time.perf_counter() - t0:.2f} s "
          f"({', '.join(p.name for p in build.sources())})", flush=True)
    for line in ptxas_summary(log, ("gemm_tc_kernel", "attention_tc_kernel",
                                    "gemm_i8_wgmma_kernel", "gemm_wg_kernel",
                                    "rows_prep_kernel", "ladder_qkv_kernel",
                                    "ladder_attn_kernel",
                                    "ladder_mlp_kernel", "mlp_narrow_kernel",
                                    "head_d1_kernel")):
        print(f"[build] {line}", flush=True)


def ptxas_summary(log: str, kernels: tuple) -> list:
    """`-Xptxas -v` of the named kernels: one line per instantiation with
    its registers, shared memory and spills (names demangled where
    `c++filt` exists)."""
    import re
    import shutil

    entries, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            continue
        if name is None or not any(k in name for k in kernels):
            continue
        info = entries.setdefault(name, {})
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem"),
                         ("spill stores", r"(\d+) bytes spill stores"),
                         ("spill loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m:
                info[key] = int(m.group(1))
    names = list(entries)
    if names and shutil.which("c++filt"):
        proc = subprocess.run(["c++filt"], input="\n".join(names),
                              capture_output=True, text=True)
        if proc.returncode == 0:
            names = proc.stdout.splitlines()
    return [f"{shown}: " + ", ".join(f"{k} {v}" for k, v in info.items())
            for shown, info in zip(names, entries.values())]


def phase_kernels(dev, cases_fn=None, b=B_CHECK, worst=None,
                  calls_per_op=None) -> dict:
    """Every case of `cases_fn` (default: the ViT shapes) in fp32 and bf16
    under both masks against its plain version, each reaching its kernel
    once (or as often as `calls_per_op` says); -> the worst error by op
    (fp32, or bf16 under (name, "bf16")), merged into `worst`."""
    import torch

    worst = {} if worst is None else worst
    for dtype in (torch.float32, torch.bfloat16):
        for random_mask in (False, True):
            for name, tag, op, plain, args, kw in (cases_fn or op_cases)(
                    dev, dtype, b, random_mask):
                counter = counters()[name]
                before = counter.count
                calls = (calls_per_op or {}).get(
                    (name, str(dtype).split(".")[-1]), 1)
                with torch.inference_mode():
                    got = op(*args, **kw)
                    want = plain(*args, **kw)
                torch.cuda.synchronize()
                check(counter.count == before + calls,
                      f"{name}: the call did not reach the kernel "
                      f"({counter.count - before} calls, expected {calls})")
                err, ok, msg = compare(got, want, dtype, name in INT8_OPS)
                mask_s = "random-mask" if random_mask else "ones-mask"
                print(f"[kernel] {name:20s} {tag:18s} {str(dtype):14s} "
                      f"{mask_s:11s} {msg}", flush=True)
                check(ok, f"{name} {tag} {dtype} {mask_s}: kernel disagrees "
                          f"with its plain version")
                key = name if dtype == torch.float32 else (name, "bf16")
                worst[key] = max(worst.get(key, 0.0), err)
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


def vit_requests():
    """(label, payload key, rows) of the ViT serve phase: 3 float rows (one
    slab) and 9 u8 rows (two slabs of 8)."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    return [("images", "images", rng.rand(3, 3, 224, 224).astype(np.float32)),
            ("images_u8", "images_u8",
             rng.randint(0, 256, (9, 3, 224, 224)).astype(np.uint8))]


def bert_requests():
    """`texts` requests of 3 rows (one slab) and 9 rows (two slabs)."""
    return [("texts x3", "texts", CORPUS[:3]), ("texts x9", "texts", CORPUS[:9])]


def phase_serve(dev, exp: pathlib.Path, int8: bool, model: str = "vit"):
    """Serve the experiment on one path; -> (kernel calls, service, the
    responses by request label).  Three slabs of 8 (1 + 2), their kernel
    calls against the path's table, the responses against the plain
    forward of the same module on the same path."""
    import numpy as np
    import torch

    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import serve_in_thread

    path = "int8" if int8 else "fp32"
    if model == "vit":
        per_slab = INT8_COUNTS if int8 else FP32_COUNTS
        requests, n_labels, n_players = vit_requests(), 10, 196
    else:
        per_slab = BERT_COUNTS[path]
        requests, n_labels, n_players = bert_requests(), 2, T_BERT - 1
    tag = f"serve {model} {path}"
    env = ExpEnv(exp)
    with int8_mode(int8):
        t0 = time.perf_counter()
        server, service, thread = serve_in_thread(env, port=0, batch_size=8,
                                                  device="cuda")
        port = server.server_address[1]
        print(f"[{tag}] server up on the card in "
              f"{time.perf_counter() - t0:.1f} s (warmup slabs run)",
              flush=True)
        try:
            check(_get(port, "/healthz") == {"status": "ok"}, "healthz")
            slabs0 = _get(port, "/statz")["slabs"]
            for c in counters().values():
                c.reset()
            got = {label: _post(port, {kind: np.asarray(rows).tolist()
                                       if kind != "texts" else rows})
                   for label, kind, rows in requests}
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
        print(f"[{tag}] {slabs} slabs; kernel calls {launches} "
              f"(expected {expected})", flush=True)
        check(slabs == 3, f"expected 3 slabs (1 + 2), got {slabs}")
        check(launches == expected,
              f"{tag} kernel call counts differ from {per_slab} per slab")

        for label, kind, rows in requests:
            logits = np.asarray(got[label]["logits"], np.float32)
            attr = np.asarray(got[label]["attributions"], np.float32)
            n = len(rows)
            check(logits.shape == (n, n_labels),
                  f"{label}: logits {logits.shape}")
            check(attr.shape == (n, n_labels, n_players),
                  f"{label}: attr {attr.shape}")
            check(bool(np.abs(logits.sum(-1) - 1).max() < 1e-4),
                  f"{label}: probabilities do not sum to 1")
            if kind == "texts":
                xs = torch.from_numpy(service.gen_input(rows, [0] * n)[0])
            else:
                xs = torch.as_tensor(rows)
            xs = xs.to(dev)
            if xs.dtype == torch.uint8:
                xs = xs.float() * (1.0 / 255.0)
            with plain_ops(), torch.inference_mode():
                ref = service.recipe.fw_final(service.m_config, service.model,
                                              xs)
            for what, mine, want in (("logits", logits, ref[0]),
                                     ("attributions", attr, ref[1])):
                _, ok, msg = compare(torch.from_numpy(mine), want.cpu(),
                                     torch.float32, int8, whole=True)
                print(f"[{tag}] {label:9s} {what:12s} "
                      f"{tuple(mine.shape)} served vs plain forward: {msg}",
                      flush=True)
                check(ok, f"{tag} {label} {what}: served response differs "
                          f"from the plain forward")
    return launches, service, got


def write_bert_experiment(tmp: pathlib.Path) -> pathlib.Path:
    """A random LTT BERT-base@512 final (bert_base_tayp_ltt dims, seeded
    torch.Generator) with a `build_vocab` vocabulary under
    `<exp>/tokenizer/vocab.txt`."""
    import torch

    from autognothi_tpu_torch.data.tokenizer import (WordPieceTokenizer,
                                                     build_vocab)
    from autognothi_tpu_torch.models.ltt_bert import (LttBertConfig,
                                                      init_ltt_bert_final)
    from autognothi_tpu_torch.params import save_params, to_flat

    hp = json.loads(BERT_EXP.read_text())
    exp = tmp / "ltt_bert_base"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    WordPieceTokenizer(build_vocab(CORPUS)).save(exp / "tokenizer")
    cfg = LttBertConfig(**hp["net"]["params"])
    t0 = time.perf_counter()
    model = init_ltt_bert_final(cfg, torch.Generator().manual_seed(SEED))
    with torch.no_grad():  # a non-trivial null makes normalisation visible
        model.surrogate_null.fill_(0.1)
    save_params(exp / "final-epoch-0.ckpt", to_flat(model))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve bert] LTT BERT-base@512 final ({BERT_EXP.parent.name} "
          f"dims): {n_params} parameters, seed {SEED}, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return exp


def phase_bert_timing(dev, card: str, service) -> tuple:
    """fw_final of the served BERT model at B = 8 on the four paths
    (fp32; int8 with fp32 and with bf16 parameters; bf16 parameters
    without int8, the float K8 chain): kernels against plain, one
    forward's kernel calls against the path's table, then explanations/s
    in turns; each T = 512 op against its plain version beside its bound
    (and SDPA beside the masked attention op) -> (the rows of the kernel
    table, the kernel calls of the four counted forwards)."""
    import torch

    model, cfg, recipe = service.model, service.m_config, service.recipe
    ids = torch.randint(1, cfg.vocab_size, (B_BERT, T_BERT),
                        generator=torch.Generator().manual_seed(SEED)
                        ).to(dev)
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)

    def forward(m, int8: bool, plain: bool):
        def run():
            with int8_mode(int8), torch.inference_mode(), \
                    (plain_ops() if plain else contextlib.nullcontext()):
                return recipe.fw_final(cfg, m, ids)
        return run

    path_calls = {}
    for label, m, dtype, int8 in (
            ("fp32", model, torch.float32, False),
            ("int8", model, torch.float32, True),
            ("int8 bf16", model_bf16, torch.bfloat16, True),
            ("bf16", model_bf16, torch.bfloat16, False)):
        fw = forward(m, int8, False)
        reset_counts()
        fw()
        torch.cuda.synchronize()
        calls = {k: v for k, v in read_counts().items() if v}
        for k, v in calls.items():
            path_calls[k] = path_calls.get(k, 0) + v
        print(f"[bert-time] fw_final {label} B={B_BERT}: kernel calls "
              f"{calls} (expected {BERT_COUNTS[label]})", flush=True)
        check(calls == BERT_COUNTS[label],
              f"BERT fw_final {label}: kernel calls differ from the table")
        time_fw_final(f"LTT BERT-base@512 {label}", fw,
                      forward(m, int8, True), dtype, int8, card, B_BERT)
        profile_forward(f"LTT BERT-base@512 {label} B={B_BERT}", fw, card)
    del model_bf16

    per_op = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, tag, op, plain, args, kw in bert_op_cases(
                dev, dtype, B_BERT, True):
            with torch.inference_mode():
                _, ok, msg = compare(op(*args, **kw), plain(*args, **kw),
                                     dtype, name in INT8_OPS)
                t_plain = cuda_time(lambda: plain(*args, **kw), reps=10)
                t_kern = cuda_time(lambda: op(*args, **kw), reps=10)
                t_lib = None
                if name == "masked_attention" and tag.endswith(" add"):
                    t_lib = time_library_attention(args, card)
            bound_ms, bound_by = op_bound(name, args)
            print(f"[bert-time] {name:20s} {tag:24s} {str(dtype):14s} "
                  f"B={B_BERT} T={T_BERT}: kernel {t_kern:.4f} ms, plain "
                  f"{t_plain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
                  f" ({msg}) | {card}", flush=True)
            check(ok, f"{name} {tag} {dtype} B={B_BERT}: kernel disagrees")
            per_op.setdefault(name, dict(ms=t_kern, plain_ms=t_plain,
                                         bound_ms=bound_ms,
                                         bound_by=bound_by, library_ms=t_lib))
    return per_op, path_calls


# The int8 GEMM alone (K1's and K2's products) at the ViT B=64 trunk (M =
# 12608 tokens) and the train step's teacher sweep (M = 50432), (N, K,
# the epilogue the path runs): K1's Q|K|V and out-projection, K2's W1 and W2
I8_GEMM_M = (B_TIME * T, 4 * B_TIME * T)
I8_GEMM_PRODUCTS = (("K1 qkv", 2304, 768, "bias"),
                    ("K1 out", 768, 768, "resid"),
                    ("K2 w1", 3072, 768, "gelu_f32"),
                    ("K2 w2", 768, 3072, "resid"))


def profiled_kernels(fn, reps: int, tries: int = 5) -> list:
    """The device kernels of `reps` calls of `fn` after one warmup call, as
    (name, device ms) in launch order.  The profiler runs a warmup window
    before the one it keeps, and the kept window's calls are bracketed by
    two fills (`torch.zeros`), dropped where they stand first and last: the
    first or last event of a window is now and then lost.  Every call
    launches the same kernels, so a window where a kernel is seen a number
    of times that is not a whole multiple of the calls (or no kernel at
    all) lost events: it is profiled again, and after `tries` such
    windows this raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def window():
        torch.zeros(1, device="cuda")
        for _ in range(reps):
            fn()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()

    fn()
    counts: dict = {}
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                window()
                prof.step()
        # the step's own annotation ("ProfilerStep#") is no kernel
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and e.name not in SPANS
                         and not e.name.startswith("ProfilerStep")),
                        key=lambda e: e.time_range.start)
        for end in (0, -1):
            if events and "FillFunctor" in events[end].name:
                events.pop(end)
        counts = {}
        for e in events:
            counts[e.name] = counts.get(e.name, 0) + 1
        if counts and all(n % reps == 0 for n in counts.values()):
            return [(e.name, e.time_range.elapsed_us() / 1e3)
                    for e in events]
        print(f"[profile] device events per kernel in a window of {reps} "
              f"calls: {counts}", file=sys.stderr, flush=True)
    raise RuntimeError(f"the profiler lost device events in {tries} "
                       f"windows; the last: {counts}")


def device_time(fn, reps: int) -> float:
    """Milliseconds of device time per call (`profiled_kernels`)."""
    return sum(ms for _, ms in profiled_kernels(fn, reps)) / reps


def device_str(ms: float, work: float, unit: str) -> str:
    """'device <ms>, <work / ms> <unit>' of a device time per call."""
    return f"device {ms:.4f}, {work / ms:.1f} {unit}"


def i8_gemm_case(dev, g, m: int, n: int, k: int, epi: str):
    """Inputs of one int8 GEMM case (fp32 activations) -> (the kernel's
    call, its epilogue in torch on `torch._int_mm`'s int32 sum, the
    library call, the bound in ms, what bounds it)."""
    import torch

    from autognothi_tpu_torch.kernels import primitives as kp

    a = torch.randint(-127, 128, (m, k), generator=g,
                      dtype=torch.int8).to(dev)
    w = torch.randint(-127, 128, (n, k), generator=g,
                      dtype=torch.int8).to(dev)
    sa = (torch.rand(m, generator=g) * 1e-2).to(dev)
    sw = (torch.rand(n, generator=g) * 1e-3).to(dev)
    bias = torch.randn(n, generator=g).to(dev)
    resid = torch.randn(m, n, generator=g).to(dev) if epi == "resid" \
        else None
    code = {"bias": kp.I8_EPI_BIAS, "resid": kp.I8_EPI_BIAS_RESID,
            "gelu_f32": kp.I8_EPI_GELU_F32}[epi]

    def kernel():
        return kp.gemm_i8(a, sa, w, sw, bias, code, torch.float32,
                          resid=resid)

    def reference():
        v = (torch._int_mm(a, w.T).float() * sa[:, None]) * sw + bias
        if epi == "gelu_f32":
            return torch.nn.functional.gelu(v)
        return v if resid is None else resid + v

    moved = _nbytes(a, w, sa, sw, bias) + m * n * 4 * (1 if resid is None
                                                       else 2)
    t_ops, t_bytes = 2.0 * m * n * k / PEAK["int8"], moved / HBM_BYTES_PER_S
    return (kernel, reference, lambda: torch._int_mm(a, w.T),
            max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_int8_gemm(dev, card: str) -> None:
    """The int8 GEMM (TMA + wgmma) beside `torch._int_mm` (the one PyTorch
    call that computes the int32 product; timed only, never on the path)
    at K1's and K2's products, CUDA events and profiler device time each,
    beside the bound; the bias and residual epilogues held bit-identical
    to the same steps in torch on `torch._int_mm`'s sum."""
    import torch

    g = torch.Generator().manual_seed(SEED + 3)
    for m in I8_GEMM_M:
        for label, n, k, epi in I8_GEMM_PRODUCTS:
            kernel, reference, library, bound_ms, bound_by = i8_gemm_case(
                dev, g, m, n, k, epi)
            got, want = kernel(), reference()
            if epi == "gelu_f32":
                err = (got - want).abs().max().item()
                ok = err <= TOL["float32"] * max(
                    1.0, want.abs().max().item())
                how = f"max|kernel - torch| = {err:.3e}"
            else:
                ok = torch.equal(got, want)
                how = "bit-identical to torch" if ok else "DIFFERS"
            ms = {which: (cuda_time(fn, reps=10), device_time(fn, reps=10))
                  for which, fn in (("kernel", kernel),
                                    ("_int_mm", library))}
            tops = 2.0 * m * n * k / 1e9
            print(f"[int8-gemm] {label:6s} <{m},{k}> x <{n},{k}>^T {epi:8s}"
                  f": kernel {ms['kernel'][0]:.4f} ms ("
                  f"{device_str(ms['kernel'][1], tops, 'TOP/s')}), "
                  f"torch._int_mm {ms['_int_mm'][0]:.4f} ms ("
                  f"{device_str(ms['_int_mm'][1], tops, 'TOP/s')}), bound "
                  f"{bound_ms:.4f} ms ({bound_by}); {how} | {card}",
                  flush=True)
            check(ok, f"int8 GEMM {label} M={m}: kernel disagrees with the "
                      f"epilogue on torch._int_mm's sum")
            del kernel, reference, library, got, want
    torch.cuda.empty_cache()


def phase_yardsticks(dev, card: str) -> None:
    """The float GEMM (K7's product) beside `torch.matmul` (fp32 with TF32
    off, and bf16) at K7's two products of the ViT B=64 and BERT B=8
    forwards, and the attention core beside SDPA in bf16 at K9's two
    shapes.  Timed only: the port never calls either library function."""
    import torch

    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.ops import flash_attention as fa

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off")
    g = torch.Generator().manual_seed(SEED + 2)
    for m in (B_TIME * T, B_BERT * T_BERT):
        for n, k in ((3072, 768), (768, 3072)):
            a32 = torch.randn(m, k, generator=g).to(dev)
            w32 = (torch.randn(n, k, generator=g) * k ** -0.5).to(dev)
            bias = torch.zeros(n, device=dev)
            ref = a32.double() @ w32.double().T
            for dtype in (torch.float32, torch.bfloat16):
                a, w = a32.to(dtype), w32.to(dtype)
                got = kp.gemm(a, w, bias, kp.EPI_BIAS)
                lib = torch.matmul(a, w.T)
                t_kern = cuda_time(lambda: kp.gemm(a, w, bias, kp.EPI_BIAS),
                                   reps=10)
                t_lib = cuda_time(lambda: torch.matmul(a, w.T), reps=10)
                flop = 2.0 * m * n * k
                scale = max(1.0, ref.abs().max().item())
                err_k, err_l = ((x.double() - ref).abs().max().item() / scale
                                for x in (got, lib))
                print(f"[yardstick] gemm <{m},{k}> x <{n},{k}>^T "
                      f"{str(dtype):14s}: kernel {t_kern:.4f} ms "
                      f"({flop / t_kern / 1e9:.1f} TFLOP/s), torch.matmul "
                      f"{t_lib:.4f} ms ({flop / t_lib / 1e9:.1f} TFLOP/s); "
                      f"max|kernel - fp64| / max(1,|ref|) = {err_k:.3e}, "
                      f"matmul {err_l:.3e} | {card}", flush=True)
    for n, t in ((4 * B_TIME, T), (B_BERT, T_BERT)):
        q, k, v = (torch.randn(n, 12, t, 64, generator=g).to(dev)
                   for _ in range(3))
        row = torch.zeros(n, t, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            args = tuple(x.to(dtype) for x in (q, k, v)) + (row,)
            t_kern = cuda_time(lambda: fa.masked_attention(*args, mode="add"),
                               reps=10)
            print(f"[yardstick] masked attention <{n},12,{t},64> add "
                  f"{str(dtype):14s}: kernel {t_kern:.4f} ms | {card}",
                  flush=True)
            time_library_attention(args, card)


# K6's two products on the float wgmma GEMM, at the ViT B=64 trunk (M =
# 12608) and the BERT B=8 trunk (M = 4096): (label, N, K, epilogue)
WG_GEMM_M = (B_TIME * T, B_BERT * T_BERT)
WG_GEMM_PRODUCTS = (("K6 qkv", 2304, 768, "bias"),
                    ("K6 out", 768, 768, "resid"))


def phase_float_gemm(dev, card: str) -> None:
    """The float TMA + wgmma GEMM (`csrc/gemm_wgmma.cu`) at K6's products,
    fp32 and bf16: CUDA events and profiler device time, TFLOP/s, beside the
    bound and `torch.matmul` (fp32 with TF32 off, and bf16; the yardstick,
    never on the path).  Each result is held against the float64 product
    (fp32 1e-5, bf16 1e-2 x max(1, |ref|))."""
    import torch

    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.ops.weight_codes import tf32_planes

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 must be off")
    g = torch.Generator().manual_seed(SEED + 4)
    for m in WG_GEMM_M:
        for label, n, k, epi in WG_GEMM_PRODUCTS:
            a32 = torch.randn(m, k, generator=g).to(dev)
            w32 = (torch.randn(n, k, generator=g) * k ** -0.5).to(dev)
            bias = torch.randn(n, generator=g).to(dev)
            resid = torch.randn(m, n, generator=g).to(dev)
            code = kp.EPI_WG_BIAS if epi == "bias" else kp.EPI_WG_BIAS_RESID
            w_hi, w_lo = tf32_planes(w32)
            for mode in ("fp32", "bf16"):
                dtype = torch.bfloat16 if mode == "bf16" else torch.float32
                a, w = a32.to(dtype), w32.to(dtype)
                r = (resid.to(dtype),) if epi == "resid" else ()
                kw = dict(resids=r)
                if mode == "fp32":
                    args = (a32, w_hi, bias, code)
                    kw.update(w_lo=w_lo)
                else:
                    args = (a, w, bias, code)

                def kernel(args=args, kw=kw):
                    return kp.gemm_wg(*args, **kw)

                def library(a=a, w=w):
                    return torch.matmul(a, w.T)

                ref = a.double() @ w.double().T + bias.double()
                if r:
                    ref = r[0].double() + ref.to(dtype).double()
                scale = max(1.0, ref.abs().max().item())
                err = (kernel().double() - ref).abs().max().item() / scale
                del ref
                # cuBLAS launches a varying number of kernels per call:
                # torch.matmul is timed with CUDA events only
                ms = {"kernel": (cuda_time(kernel, reps=10),
                                 device_time(kernel, 10)),
                      "matmul": (cuda_time(library, reps=10), None)}
                flop = 2.0 * m * n * k
                es = a.element_size()
                moved = (m * k + n * k + m * n * (2 if r else 1)) * es \
                    + n * 4
                peak = PEAK["bf16" if mode == "bf16" else "fp32"]
                t_ops, t_bytes = flop / peak, moved / HBM_BYTES_PER_S
                bound_ms = max(t_ops, t_bytes) * 1e3
                bound_by = "operations" if t_ops >= t_bytes else "bytes"
                print(f"[wg-gemm] {label} <{m},{k}> x <{n},{k}>^T {epi:5s} "
                      f"{mode}: kernel {ms['kernel'][0]:.4f} ms ("
                      f"{device_str(ms['kernel'][1], flop / 1e9, 'TFLOP/s')}"
                      f"), "
                      f"torch.matmul {ms['matmul'][0]:.4f} ms "
                      f"({flop / ms['matmul'][0] / 1e9:.1f} TFLOP/s), bound "
                      f"{bound_ms:.4f} ms ({bound_by}); max|kernel - fp64|"
                      f" / max(1,|ref|) = {err:.3e} | {card}", flush=True)
                check(err <= (1e-2 if mode == "bf16" else 1e-5),
                      f"wgmma GEMM {label} M={m} {mode}: disagrees with "
                      f"the float64 product")
            del a32, w32, resid, w_hi, w_lo
    torch.cuda.empty_cache()


def phase_block_launches(dev, card: str) -> None:
    """K5's and K6's launches at the main paths' trunk shapes (ViT B=64,
    BERT-base@512 B=8, its additive mask in the activation dtype as the
    model makes it), and K4's and K3's at all their shapes there, fp32 and
    bf16: the kernels of one call with each one's device time per call (10
    profiled calls); one ladder step is at most four launches for every
    branch together; K4 and K3 as `check_int8_launches` says."""
    import torch

    reps = 10
    for cases_fn, b in ((op_cases, B_TIME), (bert_op_cases, B_BERT)):
        for dtype in (torch.float32, torch.bfloat16):
            for name, tag, op, _, args, kw in cases_fn(dev, dtype, b, False):
                int8_block = name in ("mlp_block_int8", "head_block")
                if not int8_block and (name not in ("ladder_block",
                                                    "attention_block")
                                       or "side" in tag):
                    continue
                with torch.inference_mode():
                    events = profiled_kernels(lambda: op(*args, **kw), reps)
                kernels: dict = {}
                for k, ms in events:
                    kernels[k] = kernels.get(k, 0.0) + ms
                launches = len(events) / reps
                print(f"[launches] {name} {tag} {str(dtype):14s} B={b}: "
                      f"{launches:g} launches per call, device "
                      f"{sum(kernels.values()) / reps:.4f} ms; "
                      + "; ".join(f"{k[:48]} {v / reps:.4f}" for k, v in
                                  sorted(kernels.items(),
                                         key=lambda kv: -kv[1]))
                      + f" | {card}", flush=True)
                if name == "ladder_block":
                    check(launches <= 4, f"{name} {tag}: {launches} "
                                         f"launches per ladder step")
                if int8_block:
                    check_int8_launches(name, f"{tag} {dtype}", kernels,
                                        launches, "LN-epi" in tag)
                    continue
                check(not any(w in k.lower() for k in kernels
                              for w in ("copy", "cat", "fill")),
                      f"{name} {tag} {dtype}: a copy, concatenation or fill "
                      f"among its kernels: {sorted(kernels)}")
    torch.cuda.empty_cache()


def phase_split_chains(dev, card: str) -> None:
    """The split MLP chains at LTT BERT-base@512 B=8 (M = 4096, the gate's
    2 tiles, LN epilogue): K8q with fp32 and with bf16 parameters, the
    bf16 float chain K8.  Each held against its plain version, then its
    CUDA-event and profiler device ms per chain beside its bound and the
    same products on the library: `torch._int_mm` of each tile's two int8
    products (profiler device ms) for K8q, `torch.matmul` in bf16 (CUDA
    events) for K8, summed over the tiles.  Timed only: the port never
    calls either."""
    import torch

    from autognothi_tpu_torch.ops import gates
    from autognothi_tpu_torch.ops import mlp_block as mb

    g = torch.Generator().manual_seed(SEED + 5)
    t, h, inter = T_BERT, 768, 3072
    m = B_BERT * t
    for label, dtype, quant in (("K8q fp32 params", torch.float32, "int8"),
                                ("K8q bf16 params", torch.bfloat16, "int8"),
                                ("K8 bf16", torch.bfloat16, "none")):
        n_tiles = gates.mlp_block_tiles(t, h, inter, dtype, quant)
        width = inter // n_tiles
        args = (torch.randn(B_BERT, t, h, generator=g).to(dev, dtype),
                *(x.to(dev, dtype) for x in (
                    torch.randn(inter, h, generator=g) * h ** -0.5,
                    torch.randn(inter, generator=g) * 0.1,
                    torch.randn(h, inter, generator=g) * inter ** -0.5,
                    torch.randn(h, generator=g) * 0.1)))
        ln = ((1 + 0.1 * torch.randn(h, generator=g)).to(dev),
              (0.1 * torch.randn(h, generator=g)).to(dev), 1e-12)
        op = functools.partial(mb.mlp_block, ln=ln, ln_position="epilogue",
                               quant=quant)
        name = "mlp_block_int8_tiled" if quant == "int8" \
            else "mlp_block_tiled"
        with torch.inference_mode():
            _, ok, msg = compare(op(*args), _under_plain(op)(*args), dtype,
                                 quant == "int8")
            check(ok, f"{label}: the chain disagrees with its plain version")
            ms = cuda_time(lambda: op(*args), reps=10)
            dev_ms = device_time(lambda: op(*args), 10)
        bound_ms, bound_by = op_bound(name, args)
        if quant == "int8":
            a1, a2 = (torch.randint(-127, 128, shape, generator=g,
                                    dtype=torch.int8).to(dev)
                      for shape in ((m, h), (m, width)))
            w1, w2 = (torch.randint(-127, 128, shape, generator=g,
                                    dtype=torch.int8).to(dev)
                      for shape in ((width, h), (h, width)))

            def products():
                torch._int_mm(a1, w1.T)
                torch._int_mm(a2, w2.T)
            lib = f"torch._int_mm x {2 * n_tiles}: device " \
                  f"{n_tiles * device_time(products, 10):.4f} ms"
        else:
            a1, w1 = args[0].reshape(m, h), args[1][:width]
            a2 = torch.randn(m, width, generator=g).to(dev, dtype)
            w2 = args[3][:, :width]

            def products():
                torch.matmul(a1, w1.T)
                torch.matmul(a2, w2.T)
            lib = f"torch.matmul bf16 x {2 * n_tiles}: " \
                  f"{n_tiles * cuda_time(products, reps=10):.4f} ms"
        print(f"[split-chain] {label} B={B_BERT} T={t} {n_tiles} tiles: "
              f"{ms:.4f} ms events, device {dev_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); {lib} ({msg}) | {card}",
              flush=True)
    torch.cuda.empty_cache()


# ------------------------------------------------------------- training


def write_train_experiment(tmp: pathlib.Path) -> pathlib.Path:
    """A random LTT ViT-B/16@224 surrogate (`surrogate-epoch-1.ckpt`) and
    explainer (`explainer-epoch-0.ckpt`, the surrogate's trunk and branch-0
    ladder with a fresh explainer head, as the JAX conversion builds it)
    beside a `cv_samples` experiment at 224 px: 2 train batches and 1 test
    batch of TRAIN_B images, TRAIN_M coalitions per image, one epoch."""
    import torch

    from autognothi_tpu_torch import RECIPE_VERSION
    from autognothi_tpu_torch.models.ltt_vit import LttViTConfig, init_ltt_vit
    from autognothi_tpu_torch.params import save_params, to_flat

    hp = json.loads((REPO / "experiments" / "vit_base_imagenette_vanilla"
                     / ".hparams.json").read_text())
    hp["net"] = {"kind": "ltt_vit", "version": RECIPE_VERSION,
                 "base_model": hp["net"]["base_model"],
                 "params": dict(LTT_VIT_B16)}
    hp["dataset"] = {"kind": "cv_samples", "train_size": 2 * TRAIN_B,
                     "test_size": TRAIN_B, "img_px_size": 224,
                     "num_classes": 10, "seed": SEED}
    hp["train_surrogate"]["epochs"] = 1
    hp["train_explainer"] = {"epochs": 1, "ckpt_when": "_:%1==0",
                             "lr": 5e-5, "batch_size": TRAIN_B,
                             "n_mask_samples": TRAIN_M,
                             "lambda_efficiency": 0.0, "lambda_norm": 0.0}
    exp = tmp / "ltt_vit_base_train"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    cfg = LttViTConfig(**LTT_VIT_B16)
    t0 = time.perf_counter()
    srg = init_ltt_vit(cfg, "surrogate", torch.Generator().manual_seed(SEED))
    explainer = init_ltt_vit(cfg, "explainer",
                             torch.Generator().manual_seed(SEED + 1))
    shared = {k: v for k, v in srg.state_dict().items()
              if k in explainer.state_dict()}
    explainer.load_state_dict(shared, strict=False)
    save_params(exp / "surrogate-epoch-1.ckpt", to_flat(srg))
    save_params(exp / "explainer-epoch-0.ckpt", to_flat(explainer))
    n_train = sum(p.numel() for k, p in explainer.named_parameters()
                  if not k.startswith(("vit.embeddings.", "vit.encoder.layers.",
                                       "vit.layernorm.", "classifier.")))
    print(f"[train] LTT ViT-B/16@224 surrogate "
          f"{sum(p.numel() for p in srg.parameters())} and explainer "
          f"{sum(p.numel() for p in explainer.parameters())} parameters "
          f"({n_train} trainable), seed {SEED}, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return exp


def train_env(pallas: str, teacher: str):
    """AUTOGNOTHI_PALLAS and AUTOGNOTHI_INT8_TEACHER ("int8" or "fp32")."""
    return mock.patch.dict(os.environ, {
        "AUTOGNOTHI_PALLAS": pallas, "AUTOGNOTHI_INT8": "0",
        "AUTOGNOTHI_INT8_TEACHER": "1" if teacher == "int8" else "0"})


class TrainCase:
    """The models, one batch and one set of coalition masks of the train
    experiment on the card, and fresh trainable copies of the explainer."""

    def __init__(self, dev, exp: pathlib.Path):
        import torch

        from autognothi_tpu_torch.ops.shapley import mask_shapley
        from autognothi_tpu_torch.parallel.train_step import \
            make_explainer_train_step
        from autognothi_tpu_torch.pipeline.env import ExpEnv
        from autognothi_tpu_torch.pipeline.resources import (
            get_recipe, load_cfg_dataset, load_epoch_model)

        with ExpEnv(exp) as env:
            self.recipe, self.cfg = get_recipe(env.config)
            _, self.srg = load_epoch_model(env, self.recipe, "surrogate", dev)
            _, self.explainer = load_epoch_model(env, self.recipe,
                                                 "explainer", dev)
            loader = load_cfg_dataset(env.config.dataset)
        self.srg.requires_grad_(False)
        self.explainer.requires_grad_(False)
        raw_xs, raw_ys = next(iter(loader.train(TRAIN_B)))
        xs, _ = self.recipe.gen_input(self.cfg, None)(raw_xs, raw_ys)
        self.xs = torch.from_numpy(xs).to(dev)
        self.n_players = self.recipe.n_players(self.cfg)
        self.masks = mask_shapley(
            torch.Generator(device=dev).manual_seed(SEED),
            TRAIN_B * TRAIN_M, self.n_players).reshape(
                TRAIN_B, TRAIN_M, self.n_players)
        with torch.no_grad():
            nil = torch.from_numpy(self.recipe.gen_null(self.cfg, None))
            self.null, _ = self.recipe.fw_surrogate(
                self.cfg, self.srg, nil.to(dev),
                torch.ones((1, self.n_players), dtype=torch.int32,
                           device=dev))
        self.step = make_explainer_train_step(self.recipe, self.cfg,
                                              self.n_players, TRAIN_M)
        self.trainable = self.recipe.trainable(self.cfg, "explainer")

    def fresh(self):
        """-> a run() that takes one step on its own copy of the
        explainer (returning the loss) and its AdamW."""
        from autognothi_tpu_torch.pipeline.training import AdamW

        model = copy.deepcopy(self.explainer)
        for name, p in model.named_parameters():
            p.requires_grad_(self.trainable(name))
        params = dict(model.named_parameters())
        opt = AdamW(params, self.trainable)
        ones = {k: 1.0 for k in params}

        def run():
            return self.step(model, opt, self.srg, self.null, self.xs, None,
                             5e-5, ones, self.cfg.num_hidden_layers,
                             masks=self.masks)
        return run


def phase_train_steps(case: TrainCase) -> dict:
    """One step per mode and teacher with the kernels, and the same step
    with the plain versions; -> the kernel calls of one step, by (mode,
    teacher)."""
    import torch

    per_step = {}
    for pallas, teacher in STEP_COUNTS:
        losses, calls = {}, {}
        for which in ("kernels", "plain"):
            run = case.fresh()
            with train_env(pallas, teacher), \
                    (plain_ops() if which == "plain"
                     else contextlib.nullcontext()):
                reset_counts()
                losses[which] = run().item()
                torch.cuda.synchronize()
                calls[which] = {k: v for k, v in read_counts().items()
                                if v}
        rel = abs(losses["kernels"] - losses["plain"]) \
            / abs(losses["plain"])
        want = STEP_COUNTS[(pallas, teacher)]
        print(f"[train] step pallas={pallas} teacher={teacher}: loss "
              f"kernels {losses['kernels']:.8f}, plain "
              f"{losses['plain']:.8f}, rel diff {rel:.3e} (limit "
              f"{STEP_TOL[teacher]:.0e}); kernel calls {calls['kernels']}"
              f" (expected {want})", flush=True)
        check(calls["kernels"] == want,
              f"pallas={pallas} teacher={teacher}: one step's kernel "
              f"calls differ")
        check(not calls["plain"], "the plain step launched kernels")
        check(rel <= STEP_TOL[teacher] and
              all(math.isfinite(v) for v in losses.values()),
              f"pallas={pallas} teacher={teacher}: the kernel step's "
              f"loss differs from the plain step's")
        per_step[(pallas, teacher)] = calls["kernels"]
    return per_step


def phase_train_cli(exp: pathlib.Path, per_step: dict) -> dict:
    """One epoch (2 train steps + 1 eval step) through `python -m
    autognothi_tpu_torch train_explainer <exp> --device cuda`, per mode;
    -> the kernel calls of both runs."""
    import numpy as np

    from autognothi_tpu_torch.cli import main as cli_main
    from autognothi_tpu_torch.params import load_params_file

    total = {}
    for pallas, teacher in CLI_TEACHER.items():
        (exp / "explainer-epoch-1.ckpt").unlink(missing_ok=True)
        t0 = time.perf_counter()
        with train_env(pallas, teacher):
            reset_counts()
            cli_main(["train_explainer", str(exp), "--device", "cuda"])
            calls = {k: v for k, v in read_counts().items() if v}
        one = per_step[(pallas, teacher)]
        expected = {k: 3 * one.get(k, 0) + NULL_COUNTS[pallas].get(k, 0)
                    for k in {*one, *NULL_COUNTS[pallas]}}
        print(f"[train cli] pallas={pallas}: one epoch in "
              f"{time.perf_counter() - t0:.1f} s; kernel calls {calls} "
              f"(expected 3 steps x {one} + the null forward's "
              f"{NULL_COUNTS[pallas]})", flush=True)
        check(calls == expected, f"pallas={pallas}: the CLI run's kernel "
                                 f"calls differ from 3 steps'")
        ckpt = load_params_file(exp / "explainer-epoch-1.ckpt")
        check(all(np.isfinite(v).all() for v in ckpt.values()),
              "the trained explainer checkpoint is not finite")
        for k, v in calls.items():
            total[k] = total.get(k, 0) + v
    return total


# ------------------------------------------------------------- train_all

# one fp32 forward of the LTT ViT-B classifier or surrogate (branch 0): 12
# trunk layers (K6 + K7) and 12 ladder steps (K5)
TRUNK_FWD = {"attention_block": 12, "mlp_block": 12, "ladder_block": 12}
# the final's conversion: the surrogate's null forward, then the coherency
# check's classifier, surrogate, explainer (+ its 96-wide side layer: K6 +
# K7) and final (2 branches, + the side layer) forwards
FINAL_COUNTS = {"attention_block": 62, "mlp_block": 62, "ladder_block": 60}
STAGES = ("conv_pretrained_classifier", "train_classifier",
          "conv_classifier_surrogate", "train_surrogate",
          "conv_surrogate_explainer", "train_explainer",
          "conv_explainer_final")
# the F7 route's shapes: (side, heads) = d 16, 16 and 32
PER_BRANCH_SHAPES = ((192, 12), (256, 16), (384, 12))


def write_train_all_experiment(tmp: pathlib.Path, name: str = "train_all",
                               surrogate_epochs: int = 1) -> pathlib.Path:
    """A `random_init` LTT ViT-B/16@224 experiment on `cv_samples` at 224
    px (2 train batches and 1 test batch of TRAIN_B images), one epoch per
    trainer (the surrogate's progressive), dropout 0, TRAIN_M coalitions
    per image in the explainer stage."""
    from autognothi_tpu_torch import RECIPE_VERSION

    hp = json.loads((REPO / "experiments" / "vit_base_imagenette_vanilla"
                     / ".hparams.json").read_text())
    hp["net"] = {"kind": "ltt_vit", "version": RECIPE_VERSION,
                 "base_model": "random_init", "params": dict(LTT_VIT_B16)}
    hp["dataset"] = {"kind": "cv_samples", "train_size": 2 * TRAIN_B,
                     "test_size": TRAIN_B, "img_px_size": 224,
                     "num_classes": 10, "seed": SEED}
    hp["seed"] = SEED
    every = {"ckpt_when": "_:%1==0", "lr": 5e-5, "batch_size": TRAIN_B}
    hp["train_classifier"] = {"epochs": 1, **every}
    hp["train_surrogate"] = {"epochs": surrogate_epochs, **every,
                             "EXPERIMENTAL_progressive_training": True}
    hp["train_explainer"] = {"epochs": 1, **every, "n_mask_samples": TRAIN_M,
                             "lambda_efficiency": 0.0, "lambda_norm": 0.0}
    exp = tmp / name
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    return exp


@contextlib.contextmanager
def counted_stages(counts: dict):
    """Each of `train_all`'s seven stages with the kernel calls it made
    (from counts of 0 at its start) into `counts[stage]`."""
    import torch

    from autognothi_tpu_torch.pipeline import train_all as ta

    def wrap(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            reset_counts()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            counts[name] = {k: v for k, v in read_counts().items() if v}
            return out
        return run

    with contextlib.ExitStack() as stack:
        for name in STAGES:
            stack.enter_context(mock.patch.object(ta, name,
                                                  wrap(name, getattr(ta, name))))
        yield


class StageCase:
    """The classifier and surrogate steps of the train_all experiment on
    one batch and one `mask_purely_uniform` coalition per image, each on
    fresh copies of its stage's checkpoint."""

    def __init__(self, dev, exp: pathlib.Path):
        import torch

        from autognothi_tpu_torch.ops.shapley import mask_purely_uniform
        from autognothi_tpu_torch.pipeline.env import ExpEnv
        from autognothi_tpu_torch.pipeline.resources import (
            get_recipe, load_cfg_dataset, load_epoch_model)

        env = ExpEnv(exp)
        self.recipe, self.cfg = get_recipe(env.config)
        self.models = {s: load_epoch_model(env, self.recipe, s, dev)[1]
                       for s in ("classifier", "surrogate")}
        loader = load_cfg_dataset(env.config.dataset)
        env.close()
        raw_xs, raw_ys = next(iter(loader.train(TRAIN_B)))
        xs, ys = self.recipe.gen_input(self.cfg, None)(raw_xs, raw_ys)
        self.xs = torch.from_numpy(xs).to(dev)
        self.labels = torch.from_numpy(ys).to(dev)
        n_players = self.recipe.n_players(self.cfg)
        self.ones = torch.ones((TRAIN_B, n_players), dtype=torch.int32,
                               device=dev)
        self.mask = mask_purely_uniform(
            torch.Generator(device=dev).manual_seed(SEED), TRAIN_B,
            n_players)
        self.w = torch.ones(TRAIN_B, device=dev)

    def fresh(self, stage: str):
        """-> a run() that takes one train step of `stage` on its own copy
        of the model (the surrogate's teacher included), -> the loss."""
        from autognothi_tpu_torch.pipeline.train_classifier import \
            classifier_loss
        from autognothi_tpu_torch.pipeline.train_surrogate import (
            surrogate_loss, surrogate_teacher)
        from autognothi_tpu_torch.pipeline.training import (AdamW,
                                                            make_train_step)

        model = copy.deepcopy(self.models[stage])
        trainable = self.recipe.trainable(self.cfg, stage)
        for name, p in model.named_parameters():
            p.requires_grad_(trainable(name))
        params = dict(model.named_parameters())
        opt = AdamW(params, trainable)
        ones = {k: 1.0 for k in params}
        depth = self.cfg.num_hidden_layers
        if stage == "classifier":
            step = make_train_step(classifier_loss(self.recipe, self.cfg,
                                                   True))
            return lambda: step(model, opt, 5e-5, ones, self.xs, self.ones,
                                self.labels, None, depth, self.w)[0]
        step = make_train_step(surrogate_loss(self.recipe, self.cfg, True))
        teacher = surrogate_teacher(self.recipe, self.cfg)
        cls = self.models["classifier"]

        def run():
            orig = teacher(cls, self.xs, self.ones)
            return step(model, opt, 5e-5, ones, self.xs, self.mask, orig,
                        self.labels, None, depth, self.w)[0]
        return run

    def eval_calls(self, stage: str) -> dict:
        """The kernel calls of the stage's eval forward of one batch (the
        surrogate's: its teacher and the student)."""
        import torch

        from autognothi_tpu_torch.models.common import quant_override

        reset_counts()
        with torch.no_grad(), train_env("2", "fp32"):
            if stage == "surrogate":
                self.recipe.fw_classifier(self.cfg, self.models["classifier"],
                                          self.xs, self.ones)
            with quant_override("none"):
                fw = (self.recipe.fw_classifier if stage == "classifier"
                      else self.recipe.fw_surrogate)
                fw(self.cfg, self.models[stage], self.xs, self.ones
                   if stage == "classifier" else self.mask)
        torch.cuda.synchronize()
        return {k: v for k, v in read_counts().items() if v}


def _scaled(*terms) -> dict:
    """sum of n x counts over (n, counts) terms."""
    out: dict = {}
    for n, counts in terms:
        for k, v in counts.items():
            out[k] = out.get(k, 0) + n * v
    return {k: v for k, v in out.items() if v}


def phase_stage_steps(case: StageCase) -> dict:
    """One classifier step and one surrogate step (fp32 teacher, then the
    int8 teacher, AUTOGNOTHI_INT8=1) with the kernels against the same step
    with the plain versions; -> the kernel calls of one step, by stage."""
    import torch

    per_step = {}
    for stage, teacher in (("classifier", "fp32"), ("surrogate", "fp32"),
                           ("surrogate", "int8")):
        losses, calls = {}, {}
        for which in ("kernels", "plain"):
            run = case.fresh(stage)
            with train_env("2", "fp32"), int8_mode(teacher == "int8"), \
                    (plain_ops() if which == "plain"
                     else contextlib.nullcontext()):
                reset_counts()
                losses[which] = run().item()
                torch.cuda.synchronize()
                calls[which] = {k: v for k, v in read_counts().items() if v}
        rel = abs(losses["kernels"] - losses["plain"]) \
            / abs(losses["plain"])
        want = _scaled((1 if stage == "classifier" else 2, TRUNK_FWD)) \
            if teacher == "fp32" else None
        print(f"[stage-step] {stage} teacher={teacher}: loss kernels "
              f"{losses['kernels']:.8f}, plain {losses['plain']:.8f}, rel "
              f"diff {rel:.3e} (limit {STEP_TOL[teacher]:.0e}); kernel calls "
              f"{calls['kernels']}"
              + (f" (expected {want})" if want else ""), flush=True)
        check(not calls["plain"], "the plain step launched kernels")
        check(want is None or calls["kernels"] == want,
              f"{stage}: one step's kernel calls differ")
        check(teacher == "fp32" or (calls["kernels"].get(
            "attention_block_int8") == 12 and calls["kernels"].get(
            "mlp_ladder_block") == 12),
              "the int8 surrogate teacher did not run K1 and K2")
        check(rel <= STEP_TOL[teacher] and
              all(math.isfinite(v) for v in losses.values()),
              f"{stage} teacher={teacher}: the kernel step's loss differs "
              f"from the plain step's")
        if teacher == "fp32":
            per_step[stage] = calls["kernels"]
    return per_step


def phase_stage_timing(case: StageCase, card: str) -> None:
    """ms per classifier and surrogate step (fp32 teacher), kernels and
    plain in turns (plain, kernels, kernels, plain), 3 steps after a
    warmup each; then one step of each split into its spans (forward,
    backward, AdamW; the surrogate's teacher is outside them)."""
    import torch

    from autognothi_tpu_torch.pipeline import training

    reps = 3
    for stage in ("classifier", "surrogate"):
        runs = {"kernels": case.fresh(stage), "plain": case.fresh(stage)}
        ms = {"plain": [], "kernels": []}
        for which in ("plain", "kernels", "kernels", "plain"):
            ctx = plain_ops() if which == "plain" else contextlib.nullcontext()
            with train_env("2", "fp32"), ctx:
                runs[which]()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    runs[which]()
                torch.cuda.synchronize()
            ms[which].append((time.perf_counter() - t0) / reps * 1e3)
        for which, vals in ms.items():
            print(f"[stage-time] {stage} step B={TRAIN_B} {which:7s}: "
                  f"{' '.join(f'{v:.2f}' for v in vals)} ms/step | {card}",
                  flush=True)
        for which in ("kernels", "plain"):
            ctx = plain_ops() if which == "plain" else contextlib.nullcontext()
            timer = SpanTimer()
            with train_env("2", "fp32"), ctx, \
                    mock.patch.object(training, "record_function", timer):
                runs[which]()
            spans = timer.totals()
            print(f"[stage-time] {stage} {which:7s} step split (CUDA "
                  f"events): "
                  f"{', '.join(f'{k} {v:.2f} ms' for k, v in spans.items())}"
                  f" | {card}", flush=True)


def serve_final(dev, exp: pathlib.Path) -> dict:
    """`serve` from the experiment's final-epoch-0.ckpt: one `images`
    request of 3 rows, held against the plain forward of the served model
    at the serve gate; -> the request's kernel calls."""
    import numpy as np
    import torch

    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import serve_in_thread

    env = ExpEnv(exp)
    server, service, thread = serve_in_thread(env, port=0, batch_size=8,
                                              device="cuda")
    port = server.server_address[1]
    rows = np.random.RandomState(SEED + 7).rand(3, 3, 224, 224).astype(
        np.float32)
    try:
        reset_counts()
        got = _post(port, {"images": rows.tolist()})
        calls = {k: v for k, v in read_counts().items() if v}
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "server thread did not stop")
    env.close()
    with plain_ops(), torch.inference_mode():
        ref = service.recipe.fw_final(service.m_config, service.model,
                                      torch.from_numpy(rows).to(dev))
    for what, want in (("logits", ref[0]), ("attributions", ref[1])):
        mine = torch.from_numpy(np.asarray(got[what], np.float32))
        check(mine.shape == want.shape, f"served {what} {tuple(mine.shape)}")
        _, ok, msg = compare(mine, want.cpu(), torch.float32, False,
                             whole=True)
        print(f"[train_all] served final, images x3, {what} "
              f"{tuple(mine.shape)} vs plain forward: {msg}", flush=True)
        check(ok, f"the served final's {what} differ from the plain forward")
    check(calls == FP32_COUNTS, f"the served request's kernel calls {calls}")
    return calls


def opt_resume_bit_identical(tmp: pathlib.Path, src: pathlib.Path) -> None:
    """Under AUTOGNOTHI_CKPT_OPT=1, 2 surrogate epochs at once and 1 epoch
    followed by a resumed 1 (a run stopped right after epoch 1's
    checkpoints) give the same parameters, bit for bit."""
    import shutil

    import numpy as np

    from autognothi_tpu_torch.cli import main as cli_main
    from autognothi_tpu_torch.params import load_params_file
    from autognothi_tpu_torch.pipeline import train_surrogate as ts

    class Stop(Exception):
        pass

    dirs = {}
    for name in ("whole", "split"):
        exp = write_train_all_experiment(tmp, f"opt_{name}",
                                         surrogate_epochs=2)
        for f in ("classifier-epoch-1.ckpt", "surrogate-epoch-0.ckpt"):
            shutil.copy(src / f, exp / f)
        dirs[name] = exp
    real = ts.save_epoch_ckpt

    def stop_after_1(*args, **kwargs):
        out = real(*args, **kwargs)
        if args[3] == 1:
            raise Stop()
        return out

    argv = ["train_surrogate", "--device", "cuda"]
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {"AUTOGNOTHI_CKPT_OPT": "1"}), \
            train_env("2", "fp32"):
        cli_main([argv[0], str(dirs["whole"]), *argv[1:]])
        with mock.patch.object(ts, "save_epoch_ckpt", stop_after_1):
            try:
                cli_main([argv[0], str(dirs["split"]), *argv[1:]])
            except Stop:
                pass
        check((dirs["split"] / "surrogate-epoch-1.opt.ckpt").exists(),
              "no optimizer checkpoint after epoch 1")
        cli_main([argv[0], str(dirs["split"]), *argv[1:]])
    got = load_params_file(dirs["split"] / "surrogate-epoch-2.ckpt")
    want = load_params_file(dirs["whole"] / "surrogate-epoch-2.ckpt")
    differ = [k for k in want if not np.array_equal(got[k], want[k])]
    print(f"[train_all] AUTOGNOTHI_CKPT_OPT=1: 2 surrogate epochs vs 1 + "
          f"resumed 1 (full depth): {len(want) - len(differ)} of "
          f"{len(want)} tensors bit-identical, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(not differ, f"the resumed surrogate differs: {differ[:4]}")
    check(not (dirs["split"] / "surrogate-epoch-1.opt.ckpt").exists(),
          "the previous epoch's optimizer checkpoint was kept")


def phase_train_all(dev, tmp: pathlib.Path, explainer_step: dict,
                    card: str) -> dict:
    """`python -m autognothi_tpu_torch train_all <exp> --device cuda`
    through `cli_main` on a random_init LTT ViT-B/16@224 experiment: the
    seven stages' kernel calls against their steps' and forwards', the
    coherency line, the served final, a rerun at stage 7, the new steps
    against their plain versions, their times, and the optimizer-state
    resume; -> the kernel calls of the train_all run and the served
    request."""
    import re

    import torch

    from autognothi_tpu_torch.cli import main as cli_main

    exp = write_train_all_experiment(tmp)
    stage_calls: dict = {}
    t0 = time.perf_counter()
    with train_env("2", "int8"), counted_stages(stage_calls):
        cli_main(["train_all", str(exp), "--device", "cuda"])
    seconds = time.perf_counter() - t0
    log = (exp / ".log.txt").read_text()
    diffs = re.search(r"cls_diff: (\S+), exp_diff: (\S+)", log)
    check(diffs is not None and "verified final model is coherent" in log,
          "train_all did not verify the final's coherency")
    check("freeze side branches exc. first 1 layers" in log,
          "the surrogate stage did not train progressively")
    print(f"[train_all] seven stages in {seconds:.1f} s; coherency on the "
          f"card: cls_diff {diffs.group(1)}, exp_diff {diffs.group(2)} "
          f"(limit 1e-05) | {card}", flush=True)

    case = StageCase(dev, exp)
    per_step = phase_stage_steps(case)
    evals = {s: case.eval_calls(s) for s in ("classifier", "surrogate")}
    expected = {
        "conv_pretrained_classifier": {},
        "train_classifier": _scaled((2, per_step["classifier"]),
                                    (1, evals["classifier"])),
        "conv_classifier_surrogate": {},
        "train_surrogate": _scaled((2, per_step["surrogate"]),
                                   (1, evals["surrogate"])),
        "conv_surrogate_explainer": {},
        "train_explainer": _scaled((3, explainer_step[("2", "int8")]),
                                   (1, NULL_COUNTS["2"])),
        "conv_explainer_final": FINAL_COUNTS,
    }
    for stage in STAGES:
        print(f"[train_all] {stage}: kernel calls {stage_calls.get(stage)} "
              f"(expected {expected[stage]})", flush=True)
        check(stage_calls.get(stage) == expected[stage],
              f"{stage}: kernel calls differ from its steps' and forwards'")
    total = _scaled(*((1, c) for c in stage_calls.values()))
    with train_env("2", "int8"):
        total = _scaled((1, total), (1, serve_final(dev, exp)))
        cli_main(["train_all", str(exp), "--device", "cuda"])
    rerun = (exp / ".log.txt").read_text()[len(log):]
    check("current stage: 7 / 7" in rerun, "the rerun did not detect stage 7")
    print("[train_all] rerun on the same directory: current stage: 7 / 7",
          flush=True)
    phase_stage_timing(case, card)
    del case
    opt_resume_bit_identical(tmp, exp)
    torch.cuda.empty_cache()
    return total


def phase_ladder_route(dev, card: str) -> None:
    """F7: K5 at the shapes the stage kernels do not take, (side, heads) =
    (192, 12), (256, 16), (384, 12) over 2 branches at ViT B=8 (fp32 and
    bf16, "mul" pre-norm) and (192, 12) at BERT's B=2, T=512 ("add"
    post-norm): the route, the calls counted, the kernels of one call
    with their device times, held against the plain version."""
    import torch

    from autognothi_tpu_torch.ops import ladder_block as lb

    cases = [(s, heads, dtype, "mul", B_CHECK * 2, T)
             for s, heads in PER_BRANCH_SHAPES
             for dtype in (torch.float32, torch.bfloat16)]
    cases.append((192, 12, torch.float32, "add", 2, T_BERT))
    for s, heads, dtype, mode, b, t in cases:
        g = torch.Generator().manual_seed(SEED + s)
        route = lb.ladder_route(s, 4 * s, heads, t)
        check(route == "per_branch", f"side {s} / {heads} took {route}")
        hid = torch.randn(b, t, 768, generator=g).to(dev, dtype)
        sides = [torch.randn(b, t, s, generator=g).to(dev, dtype)
                 for _ in range(2)]
        shapes = {"map_w": (s, 768), "w1": (4 * s, s), "b1": (4 * s,),
                  "w2": (s, 4 * s)}
        branches = [{k: (torch.randn(shapes.get(
            k, (s, s) if k.startswith("w") else (s,)), generator=g) * 0.1
            + (1.0 if k in ("ln1_w", "ln2_w") else 0.0)).to(dev, dtype)
            for k in lb.BRANCH_KEYS} for _ in range(2)]
        mask = (torch.rand(b, t, generator=g) > 0.3).float().to(dev)
        mask[:, 0] = 1
        if mode == "add":
            mask = (1 - mask.to(dtype)) * torch.finfo(dtype).min
        args = (hid, sides, mask, branches, heads, mode, mode == "mul", 1e-12)
        before = (lb.COUNTER.count, lb.COUNTER_PER_BRANCH.count)
        with torch.inference_mode():
            got = lb.ladder_block(*args)
            check((lb.COUNTER.count - before[0],
                   lb.COUNTER_PER_BRANCH.count - before[1]) == (1, 1),
                  "the per-branch route's call was not counted")
            tensors, static = lb.ladder_block_args(*args)
            want = lb.ladder_block_plain(*tensors, **static)
            events = profiled_kernels(lambda: lb.ladder_block(*args), 5)
        _, ok, msg = compare(tuple(got), tuple(want), dtype, False)
        kernels: dict = {}
        for k, ms in events:
            kernels[k] = kernels.get(k, 0.0) + ms
        print(f"[launches] ladder_block route={route} S={s} heads={heads} "
              f"(d={s // heads}) {mode} {str(dtype):14s} B={b} T={t}: "
              f"{len(events) / 5:g} launches per call, device "
              f"{sum(kernels.values()) / 5:.4f} ms; vs plain {msg}; "
              + "; ".join(f"{k[:40]} {v / 5:.4f}" for k, v in
                          sorted(kernels.items(), key=lambda kv: -kv[1])[:5])
              + f" | {card}", flush=True)
        check(ok, f"K5 per-branch S={s} heads={heads} {dtype}: differs from "
                  f"its plain version")
        check(not any("ladder_" in k for k in kernels),
              "the per-branch route launched a stage kernel")
    torch.cuda.empty_cache()


class SpanTimer:
    """Stands in for `record_function` in the train step: CUDA events at
    each span's ends, so each span's time on the card's stream is read."""

    def __init__(self):
        self.spans = []

    def __call__(self, name: str):
        import torch

        @contextlib.contextmanager
        def span():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self.spans.append((name, start, end))
        return span()

    def totals(self) -> dict:
        import torch

        torch.cuda.synchronize()
        out = {}
        for name, start, end in self.spans:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


SPANS = ("teacher", "forward", "backward", "adamw")


def device_kernels(prof) -> dict:
    """Kernel name -> device milliseconds, from a profiler's device-side
    events (the spans' own annotations left out)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in SPANS:
            out[e.name] = out.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    return out


def int8_share(kernels: dict) -> str:
    """The int8 GEMM's and the row quantizer's device time and share of a
    profiled window's kernel time."""
    total = sum(kernels.values()) or 1.0
    parts = []
    for what, key in (("int8 GEMMs", "gemm_i8"), ("quantizer", "quant_rows")):
        ms = sum(v for k, v in kernels.items() if key in k)
        parts.append(f"{what} {ms:.2f} ms ({ms / total * 100:.1f}%)")
    return ", ".join(parts)


def profile_forward(label: str, fw, card: str) -> None:
    """One profiled call of a warm forward: device time by kernel and the
    device's idle share of the wall time (the profiler lengthens it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fw()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    kernel_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    print(f"[profile] {label}: device time {kernel_ms:.2f} ms of {wall:.2f} "
          f"ms wall (device idle {max(0.0, 1 - kernel_ms / wall) * 100:.1f}%)"
          f"; {int8_share(kernels)}; top: "
          + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top)
          + f" | {card}", flush=True)


def phase_train_timing(case: TrainCase, card: str) -> None:
    """ms/step and masked forwards/s, kernels and plain in turns, per mode
    (int8 teacher in mode "2"); peak memory; the step split into teacher,
    forward, backward and AdamW; one profiled step's device time by kernel
    and idle share (the profiler's own overhead lengthens that step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from autognothi_tpu_torch.parallel import train_step as ts

    reps = 3
    for pallas, teacher in CLI_TEACHER.items():
        runs = {"kernels": case.fresh(), "plain": case.fresh()}

        def timed(which):
            ctx = plain_ops() if which == "plain" else contextlib.nullcontext()
            with train_env(pallas, teacher), ctx:
                runs[which]()  # warmup
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    runs[which]()
                torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3

        ms = {"plain": [], "kernels": []}
        for which in ("plain", "kernels", "kernels", "plain"):
            ms[which].append(timed(which))
        for which, vals in ms.items():
            print(f"[train-time] pallas={pallas} B={TRAIN_B} M={TRAIN_M} "
                  f"{which:7s}: {' '.join(f'{v:.2f}' for v in vals)} ms/step"
                  f", {' '.join(f'{TRAIN_B * TRAIN_M / v * 1e3:.1f}' for v in vals)}"
                  f" masked forwards/s | {card}", flush=True)
        for which in ("kernels", "plain"):
            ctx = plain_ops() if which == "plain" else contextlib.nullcontext()
            timer = SpanTimer()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with train_env(pallas, teacher), ctx, \
                    mock.patch.object(ts, "record_function", timer):
                runs[which]()
            spans = timer.totals()
            peak = torch.cuda.max_memory_allocated() / 2**20
            print(f"[train-time] pallas={pallas} {which:7s} step split "
                  f"(CUDA events): "
                  f"{', '.join(f'{k} {v:.2f} ms' for k, v in spans.items())};"
                  f" peak device memory {peak:.1f} MiB | {card}", flush=True)
        with train_env(pallas, teacher):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                runs["kernels"]()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        kernels = device_kernels(prof)
        kernel_ms = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        print(f"[train-time] pallas={pallas} kernels profiled step: device "
              f"time {kernel_ms:.2f} ms of {wall:.2f} ms wall (device idle "
              f"{max(0.0, 1 - kernel_ms / wall) * 100:.1f}%); "
              f"{int8_share(kernels)}; top: "
              + "; ".join(f"{k[:60]} {v:.2f} ms" for k, v in top)
              + f" | {card}", flush=True)


def time_fw_final(label: str, fw, fw_plain, dtype, int8: bool,
                  card: str, b: int = B_TIME) -> None:
    """Check the kernel forward against the plain one at batch b, then time
    both in the order plain, kernels, kernels, plain."""
    got, want = fw(), fw_plain()
    _, ok, msg = compare(got, want, dtype, int8, whole=True)
    print(f"[time] fw_final {label} B={b} {msg}", flush=True)
    check(ok, f"fw_final {label} B={b}: kernels disagree with plain")
    rates = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain"):
        ms = cuda_time(fw_plain if which == "plain" else fw, reps=3)
        rates[which].append(b / (ms / 1e3))
    for which, vals in rates.items():
        print(f"[time] fw_final {label} B={b} "
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
        profile_forward(f"LTT ViT-B/16@224 {label} B={B_TIME}",
                        forward(m, x, int8, False), card)
    del model_bf16

    per_op = {}
    for name, tag, op, plain, args, kw in op_cases(dev, torch.float32,
                                                   B_TIME, False):
        with torch.inference_mode():
            _, ok, msg = compare(op(*args, **kw), plain(*args, **kw),
                                 torch.float32, name in INT8_OPS)
            t_plain = cuda_time(lambda: plain(*args, **kw), reps=10)
            t_kern = cuda_time(lambda: op(*args, **kw), reps=10)
            t_lib = None
            if name == "masked_attention" and tag.endswith(" add"):
                t_lib = time_library_attention(args, card)
            if name in ("mlp_block_int8", "head_block") \
                    and name not in per_op:
                t_lib = time_library_int8(name, args, card)
        bound_ms, bound_by = op_bound(name, args)
        print(f"[time] {name:20s} {tag:22s} fp32 B={B_TIME}: kernel "
              f"{t_kern:.4f} ms, plain {t_plain:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}) ({msg}) | {card}",
              flush=True)
        check(ok, f"{name} {tag} B={B_TIME}: kernel disagrees")
        # the first case of each op is its row: the trunk shape (the
        # masked attention op: "add" at the teacher's <256, 12, 197, 64>)
        per_op.setdefault(name, dict(ms=t_kern, plain_ms=t_plain,
                                     bound_ms=bound_ms, bound_by=bound_by,
                                     library_ms=t_lib))
    # the redesigned float blocks (K6, K5 with 2 and 1 branches, and K5
    # inside K2) in bf16 at the same shapes: checked, not timed
    for name, tag, op, plain, args, kw in op_cases(dev, torch.bfloat16,
                                                   B_TIME, False):
        if name not in ("attention_block", "ladder_block",
                        "mlp_ladder_block"):
            continue
        with torch.inference_mode():
            _, ok, msg = compare(op(*args, **kw), plain(*args, **kw),
                                 torch.bfloat16, name in INT8_OPS)
        print(f"[time] {name:20s} {tag:22s} bf16 B={B_TIME}: checked "
              f"({msg})", flush=True)
        check(ok, f"{name} {tag} bf16 B={B_TIME}: kernel disagrees")
    print(f"[time] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB | {card}",
          flush=True)
    return per_op


def time_library_attention(args, card: str) -> float:
    """`F.scaled_dot_product_attention` with the additive mask row on the
    masked attention op's inputs: the yardstick, timed here only."""
    import torch
    import torch.nn.functional as F

    from autognothi_tpu_torch.ops import flash_attention as fa

    q, k, v, row = args
    bias = row[:, None, None, :].to(q.dtype)
    got = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    err = (got - fa.masked_attention_plain(q, k, v, row, mode="add")
           ).abs().max().item()
    t_lib = cuda_time(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias), reps=10)
    print(f"[time] masked_attention library yardstick "
          f"F.scaled_dot_product_attention {tuple(q.shape)} {q.dtype}: "
          f"{t_lib:.4f} ms "
          f"(max|sdpa - plain| = {err:.3e}) | {card}", flush=True)
    return t_lib


def _int8_products(name: str, args: tuple):
    """The int8 products of one K4 or K3 call (int8 operands of the call's
    shapes, seeded) on the library, -> a function that runs them:
    `torch._int_mm` for each int8 product, and K3's float d3 on
    `torch.matmul` in the activation dtype."""
    import torch

    g = torch.Generator().manual_seed(SEED + 7)
    x = args[0]
    m = x.shape[0] * x.shape[1]
    pairs = []
    for w in (args[1], args[3]):  # W1 and W2 (K4), d1 and d2 (K3)
        n, k = w.shape
        pairs.append(tuple(torch.randint(-127, 128, shape, generator=g,
                                         dtype=torch.int8).to(x.device)
                           for shape in ((m, k), (n, k))))
    d3 = None
    if name == "head_block":
        w3 = args[5]
        d3 = (torch.randn(m, w3.shape[1], generator=g).to(x.device, x.dtype),
              w3.to(x.dtype))

    def run():
        for a, w in pairs:
            torch._int_mm(a, w.T)
        if d3 is not None:
            torch.matmul(d3[0], d3[1].T)
    return run


def time_library_int8(name: str, args: tuple, card: str) -> float:
    """The same products as one K4 or K3 call on the library
    (`_int8_products`): device ms per call (the profiler's device time;
    timed here only, the port never calls them)."""
    ms = device_time(_int8_products(name, args), 10)
    print(f"[time] {name} library yardstick torch._int_mm x 2"
          f"{' + torch.matmul (d3)' if name == 'head_block' else ''}: "
          f"device {ms:.4f} ms | {card}", flush=True)
    return ms


def check_int8_launches(name: str, tag: str, kernels: dict,
                        launches: float, post_ln: bool) -> None:
    """K4: the narrow design (`mlp_narrow_kernel`) one launch, the trunk
    design at most three and BERT's post-norm LN; K3 at most three, none
    of `csrc/gemm.cu`'s (`gemm_tc_kernel`); neither a copy or fill."""
    if name == "mlp_block_int8":
        if any("mlp_narrow_kernel" in k for k in kernels):
            check(launches == 1, f"K4 {tag}: {launches} launches per call "
                                 f"on the narrow design")
        else:
            check(launches <= 3 + int(post_ln),
                  f"K4 {tag}: {launches} launches per call on the trunk "
                  f"design")
    else:
        check(launches <= 3, f"K3 {tag}: {launches} launches per call")
        check(not any("gemm_tc_kernel" in k for k in kernels),
              f"K3 {tag}: a csrc/gemm.cu kernel among {sorted(kernels)}")
    check(not any(w in k.lower() for k in kernels
                  for w in ("copy", "cat", "fill")),
          f"{name} {tag}: a copy, concatenation or fill among its kernels: "
          f"{sorted(kernels)}")


def phase_k4_teacher(dev, card: str) -> None:
    """K4 at the int8 teacher's trunk shape: the train step's B x M = 256
    masked images of 197 tokens, 768/3072, the LN prologue (12 calls a
    step).  Held against its plain version, then its launches per call,
    CUDA-event and device ms beside its bound and the same two products on
    `torch._int_mm` (device ms), fp32 activations as the teacher's."""
    import torch

    from autognothi_tpu_torch.ops import mlp_block as mb

    g = torch.Generator().manual_seed(SEED + 6)
    b, h, inter = TRAIN_B * TRAIN_M, 768, 3072

    def lin(d_out, d_in):
        return ((torch.rand(d_out, d_in, generator=g) * 2 - 1)
                * d_in ** -0.5).to(dev), \
            ((torch.rand(d_out, generator=g) * 2 - 1) * d_in ** -0.5).to(dev)

    (w1, b1), (w2, b2) = lin(inter, h), lin(h, inter)
    ln = ((1 + 0.1 * torch.randn(h, generator=g)).to(dev),
          (0.1 * torch.randn(h, generator=g)).to(dev), 1e-12)
    args = (torch.randn(b, T, h, generator=g).to(dev), w1, b1, w2, b2)
    op = functools.partial(mb.mlp_block, ln=ln, ln_position="prologue",
                           quant="int8")
    with torch.inference_mode():
        _, ok, msg = compare(op(*args), mb.mlp_block_int8_plain(
            *args, ln[0], ln[1], ln_position="prologue", ln_eps=1e-12),
            torch.float32, True)
        check(ok, f"K4 at the teacher's shape disagrees with its plain "
                  f"version ({msg})")
        ms = cuda_time(lambda: op(*args), reps=10)
        events = profiled_kernels(lambda: op(*args), 10)
    kernels: dict = {}
    for k, t_ms in events:
        kernels[k] = kernels.get(k, 0.0) + t_ms / 10
    launches = len(events) / 10
    check_int8_launches("mlp_block_int8", "teacher 768/3072", kernels,
                        launches, False)
    lib_ms = device_time(_int8_products("mlp_block_int8", args), 10)
    bound_ms, bound_by = op_bound("mlp_block_int8", args)
    print(f"[k4-teacher] mlp_block_int8 768/3072 B={b} T={T} LN prologue: "
          f"{ms:.4f} ms events, device {sum(kernels.values()):.4f} ms, "
          f"{launches:g} launches per call ("
          + "; ".join(f"{k[:48]} {v:.4f}" for k, v in
                      sorted(kernels.items(), key=lambda kv: -kv[1]))
          + f"), bound {bound_ms:.4f} ms ({bound_by}); torch._int_mm x 2: "
          f"device {lib_ms:.4f} ms ({msg}) | {card}", flush=True)
    del args, w1, w2
    torch.cuda.empty_cache()


# -------------------------------------------------------------- run_all

# the six reports the LTT ViT recipe allows (dual-task similarity is off),
# as `measure_all` calls them and the files it writes
REPORT_FNS = ("measure_accuracy", "measure_faithfulness", "measure_cls_acc",
              "measure_performance", "measure_train_resources",
              "measure_branches_cka")
REPORT_FILES = ("accuracy.json", "branches_cka.json", "cls_acc.json",
                "faithfulness.json", "performance.json",
                "train_resources.json")
# the kernels each report launches on the fp32 path (pallas mode "2"):
# every forward it runs is the float blocks' K6 + K7 and the ladder K5
FP32_REPORT_KERNELS = ("attention_block", "mlp_block", "ladder_block")
# faithfulness under W8A8: the final K1 + K2 + K4 + K3, the coalitions'
# trunk K1 + K4 and their ladder K5; under pallas mode "1": K9
FAITH_KERNELS = {
    "fp32": FP32_REPORT_KERNELS,
    "int8": ("attention_block_int8", "mlp_ladder_block", "mlp_block_int8",
             "head_block", "ladder_block"),
    "mode 1": ("masked_attention",),
}
# the faithfulness AUCs, kernels against plain versions on the card: the
# fp32 kernels within 1e-3; W8A8 within 5e-3, the JAX package's quality
# gate (BASELINE.md, playground/quality_gate.py)
FAITH_TOL = {"fp32": 1e-3, "int8": 5e-3, "mode 1": 1e-3}
FAITH_ENV = {"fp32": ("2", False), "int8": ("2", True), "mode 1": ("1", False)}
CURVES = ("insertion", "deletion", "insertion_non_ok", "deletion_non_ok")
# an argmax that flips between kernel and plain forwards is explained when
# the plain forward's two best classes lie within this of each other
FLIP_MARGIN = 1e-3
# the cut that keeps phase 7 inside the time limit: ViT-B/16@224 widths,
# 8 test images at 16 faithfulness stops (10 classes x 16 stops x 2
# directions = 320 coalitions an image)
RUN_ALL_EVAL = {
    "eval_accuracy": {"dataset": None, "batch_size": TRAIN_B,
                      "resolution": 5},
    "eval_faithfulness": {"dataset": None, "batch_size": TRAIN_B,
                          "resolution": 16},
    "eval_cls_acc": {"dataset": None, "on_exp_epochs": "_:%1==0",
                     "batch_size": TRAIN_B},
    "eval_performance": {"dataset": None, "loops": 2},
    "eval_train_resources": {"dataset": None, "batch_size": TRAIN_B,
                             "max_samples": 2 * TRAIN_B},
    "eval_branches_cka": {"dataset": None, "batch_size": TRAIN_B},
}


def write_run_all_experiment(tmp: pathlib.Path) -> pathlib.Path:
    """Phase 6's experiment (random_init LTT ViT-B/16@224 on `cv_samples`
    at 224 px, 2 train and 1 test batch of TRAIN_B) in a fresh directory,
    with the eval blocks of RUN_ALL_EVAL."""
    exp = write_train_all_experiment(tmp, name="run_all")
    hp = json.loads((exp / ".hparams.json").read_text())
    hp.update(copy.deepcopy(RUN_ALL_EVAL))
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    return exp


def report_env(pallas: str, int8: bool):
    """AUTOGNOTHI_PALLAS and AUTOGNOTHI_INT8 inside; the explainer step's
    teacher at its default (int8)."""
    return mock.patch.dict(os.environ, {
        "AUTOGNOTHI_PALLAS": pallas, "AUTOGNOTHI_INT8": "1" if int8 else "0",
        "AUTOGNOTHI_INT8_TEACHER": "1"})


@contextlib.contextmanager
def counted_reports(calls: dict, seconds: dict):
    """Each report `measure_all` runs, with the kernel calls it made (the
    counts read before and after it, not reset) into `calls[report]` and
    its wall seconds into `seconds[report]`."""
    import torch

    from autognothi_tpu_torch.pipeline import measure_all as ma

    def wrap(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            before = read_counts()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            calls[name] = {k: v - before[k] for k, v in read_counts().items()
                           if v - before[k]}
            return out
        return run

    with contextlib.ExitStack() as stack:
        for name in REPORT_FNS:
            stack.enter_context(mock.patch.object(ma, name,
                                                  wrap(name, getattr(ma,
                                                                     name))))
        yield


def faith_drift(got: dict, want: dict) -> tuple:
    """-> (the largest |AUC difference| of the four curves, its curve, the
    largest difference of any curve point, `data_*` included)."""
    aucs = [(abs(got[c]["auc"] - want[c]["auc"]), c) for c in CURVES]
    worst, curve = max(aucs)

    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, list):
            for v in x:
                yield from leaves(v)
        elif isinstance(x, float):
            yield x

    points = max((abs(a - b) for a, b in zip(leaves(got), leaves(want))),
                 default=0.0)
    return worst, curve, points


def report_predictions(exp: pathlib.Path, report: str, dev) -> list:
    """The per-image argmax predictions, labels and plain top-2 margins
    behind the cls_acc or accuracy report, as (key, kernel class, plain
    class, label, plain margin) per image: the report's own loops, its
    forwards once with the kernels and once plain."""
    import numpy as np
    import torch

    from autognothi_tpu_torch.ops.shapley import mask_uniform_selective
    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.resources import (
        get_epoch_ckpts, get_recipe, load_cfg_dataset, load_epoch_ckpt,
        load_epoch_model, load_epoch_params)
    from autognothi_tpu_torch.utils.seeding import iterative_generator

    with ExpEnv(exp) as env:
        cfg = env.config
        recipe, m_cfg = get_recipe(cfg)
        loader = load_cfg_dataset(cfg.dataset)
        gen_input = recipe.gen_input(m_cfg, None)
        n_players = recipe.n_players(m_cfg)
        runs = []  # (key, forward, batch size)
        if report == "cls_acc":
            _, cls_p = load_epoch_params(env, "classifier")
            _, srg_p = load_epoch_params(env, "surrogate")
            for ep in get_epoch_ckpts(exp, "explainer",
                                      cfg.train_explainer.epochs):
                _, exp_p = load_epoch_ckpt(exp, "explainer", ep,
                                           required=True)
                final = from_jax_params(recipe.conv_explainer_final(
                    m_cfg, None, cls_p, srg_p, exp_p, iterative_generator(
                        cfg.seed, f"measure_cls_acc[epoch={ep}]"), dev),
                    m_cfg, dev, section="final")
                runs.append((f"epoch {ep}", lambda xs, bi, m=final:
                             recipe.fw_final(m_cfg, m, xs)[0],
                             cfg.train_classifier.batch_size))
        else:
            _, srg = load_epoch_model(env, recipe, "surrogate", dev)
            for n_masked in np.linspace(0, n_players,
                                        cfg.eval_accuracy.resolution,
                                        dtype=np.int64).tolist():
                def fwd(xs, bi, n=n_masked):
                    mask = mask_uniform_selective(iterative_generator(
                        cfg.seed, f"measure_accuracy[mask={n},batch={bi}]"),
                        xs.shape[0], n_players, int(n)).to(dev)
                    return recipe.fw_surrogate(m_cfg, srg, xs, mask)[0]
                runs.append((f"mask {n_masked}", fwd,
                             cfg.train_surrogate.batch_size))
    out = []
    with torch.no_grad():
        for key, fwd, batch in runs:
            for bi, (raw_xs, raw_ys) in enumerate(loader.test(batch)):
                xs, zs = gen_input(raw_xs, raw_ys)
                xs = torch.from_numpy(xs).to(dev)
                got = fwd(xs, bi).float().cpu().numpy()
                with plain_ops():
                    want = fwd(xs, bi).float().cpu().numpy()
                top2 = np.sort(want, axis=1)[:, -2:]
                for i in range(xs.shape[0]):
                    out.append((f"{key} image {bi * batch + i}",
                                int(got[i].argmax()), int(want[i].argmax()),
                                int(zs[i]), float(top2[i, 1] - top2[i, 0])))
    return out


def check_report_equal(exp: pathlib.Path, report: str, got: dict,
                       want: dict, dev) -> None:
    """The kernel run's cls_acc or accuracy report equals the plain run's,
    or each difference is a flipped argmax the plain forward nearly ties
    (its two best classes within FLIP_MARGIN), named."""
    if got == want:
        print(f"[run_all] {report}: kernels {got['accuracy']} == plain "
              f"{want['accuracy']}", flush=True)
        return
    preds = report_predictions(exp, report, dev)
    flips = [p for p in preds if p[1] != p[2]]
    for key, k_cls, p_cls, label, margin in flips:
        print(f"[run_all] {report}: {key} flips kernel {k_cls} / plain "
              f"{p_cls} (label {label}), plain top-2 margin {margin:.2e}",
              flush=True)
    check(flips and all(p[4] <= FLIP_MARGIN for p in flips),
          f"{report}: kernels {got} != plain {want}, not explained by "
          f"near-tied flips")
    print(f"[run_all] {report}: kernels {got['accuracy']} vs plain "
          f"{want['accuracy']}: {len(flips)} flipped argmax, each within "
          f"{FLIP_MARGIN:g} of a tie in the plain forward", flush=True)


def phase_run_all(dev, tmp: pathlib.Path, card: str) -> dict:
    """`python -m autognothi_tpu_torch run_all <exp> --device cuda` through
    `cli_main` on a fresh random_init LTT ViT-B/16@224 experiment: the six
    reports and the kernels each launched, a second `measure_all` that
    reloads them and launches nothing, the quality gate (faithfulness with
    the kernels against the plain versions on the card: fp32, W8A8 and
    pallas mode "1"), cls_acc and accuracy against the plain run, and the
    performance and train-resources numbers; -> the kernel calls of the
    counted paths (run_all, the W8A8 and mode "1" faithfulness runs)."""
    import torch

    from autognothi_tpu_torch.cli import main as cli_main
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.measure_accuracy import \
        measure_accuracy
    from autognothi_tpu_torch.pipeline.measure_cls_acc import \
        measure_cls_acc
    from autognothi_tpu_torch.pipeline.measure_faithfulness import \
        measure_faithfulness
    from autognothi_tpu_torch.pipeline.reports import to_json

    exp = write_run_all_experiment(tmp)
    calls: dict = {}
    report_seconds: dict = {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with report_env("2", False), counted_reports(calls, report_seconds):
        cli_main(["run_all", str(exp), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = {k: v for k, v in read_counts().items() if v}
    reports = exp / ".reports"
    files = tuple(sorted(p.name for p in reports.iterdir()))
    print(f"[run_all] train_all + measure_all in {seconds:.1f} s: "
          f"{', '.join(files)} | {card}", flush=True)
    check(files == REPORT_FILES, f"run_all wrote {files}")
    for name in REPORT_FNS:
        got = calls.get(name, {})
        print(f"[run_all] {name}: {report_seconds.get(name, 0.0):.2f} s, "
              f"kernel calls {got}", flush=True)
        check(all(got.get(k, 0) > 0 for k in FP32_REPORT_KERNELS),
              f"{name} launched no {FP32_REPORT_KERNELS} kernel: {got}")
    texts = {n: (reports / n).read_text() for n in files}
    stamps = {n: (reports / n).stat().st_mtime_ns for n in files}
    reset_counts()
    with report_env("2", False):
        cli_main(["measure_all", str(exp), "--device", "cuda"])
    torch.cuda.synchronize()
    again = {k: v for k, v in read_counts().items() if v}
    check(not again and all((reports / n).read_text() == texts[n]
                            and (reports / n).stat().st_mtime_ns == stamps[n]
                            for n in files),
          f"the second measure_all recomputed: kernel calls {again}")
    print("[run_all] second measure_all: the six reports reloaded, nothing "
          "computed (0 kernel calls, files unchanged)", flush=True)

    # the quality gate: faithfulness on the same checkpoints, kernels
    # against plain versions on the card
    kernel_faith = {"fp32": json.loads(texts["faithfulness.json"])}
    for path in ("fp32", "int8", "mode 1"):
        pallas, int8 = FAITH_ENV[path]
        with report_env(pallas, int8):
            if path != "fp32":
                torch.cuda.synchronize()
                reset_counts()
                with ExpEnv(exp) as env:
                    kernel_faith[path] = to_json(measure_faithfulness(
                        env, device="cuda"))
                torch.cuda.synchronize()
                run = {k: v for k, v in read_counts().items() if v}
                print(f"[run_all] faithfulness {path}: kernel calls {run}",
                      flush=True)
                check(all(run.get(k, 0) > 0 for k in FAITH_KERNELS[path]),
                      f"faithfulness {path} launched no "
                      f"{FAITH_KERNELS[path]} kernel: {run}")
                total = _scaled((1, total), (1, run))
            with plain_ops(), ExpEnv(exp) as env:
                plain = to_json(measure_faithfulness(env, device="cuda"))
        got = kernel_faith[path]
        worst, curve, points = faith_drift(got, plain)
        print(f"[run_all] quality gate, faithfulness {path}: AUCs "
              + ", ".join(f"{c} {got[c]['auc']:.6f} (plain "
                          f"{plain[c]['auc']:.6f})" for c in CURVES)
              + f"; worst AUC drift {worst:.3e} on {curve} (limit "
              f"{FAITH_TOL[path]:g}); largest curve-point drift "
              f"{points:.3e} | {card}", flush=True)
        check(worst <= FAITH_TOL[path],
              f"faithfulness {path}: AUC drift {worst:.3e} on {curve} "
              f"above {FAITH_TOL[path]:g}")

    for report, fn in (("cls_acc", measure_cls_acc),
                       ("accuracy", measure_accuracy)):
        with report_env("2", False), plain_ops(), ExpEnv(exp) as env:
            want = to_json(fn(env, device="cuda"))
        check_report_equal(exp, report,
                           json.loads(texts[f"{report}.json"]), want, dev)

    perf = json.loads(texts["performance.json"])
    for stage in ("classifier", "surrogate", "explainer", "final"):
        r = perf[stage]
        check(r["time_avg"] > 0 and r["gflops"] > 0 and r["mem_mib"] > 0,
              f"performance {stage}: {r}")
        print(f"[run_all] performance {stage}: {r['time_avg'] * 1e3:.3f} "
              f"ms/sample (std {r['time_std'] * 1e3:.3f}, batch 1, "
              f"{len(r['time'])} samples), {r['gflops']:.3f} GFLOPs, "
              f"{r['params_all']:.3f} M params ({r['params_trainable']:.3f} "
              f"M trainable), {r['mem_mib']:.1f} MiB ({r['mem_estimator']}) "
              f"| {card}", flush=True)
    trn = json.loads(texts["train_resources.json"])
    print(f"[run_all] train_resources: init {trn['init_tm']:.3f} s, "
          f"{trn['init_mem']:.1f} MiB; surrogate step "
          f"{trn['srg_tm']['avg'] * 1e3:.3f} ms/sample, "
          f"{trn['srg_mem']['avg']:.1f} MiB; explainer step "
          f"{trn['exp_tm']['avg'] * 1e3:.3f} ms/sample, "
          f"{trn['exp_mem']['avg']:.1f} MiB ({trn['mem_estimator']}, batch "
          f"{TRAIN_B}) | {card}", flush=True)
    check(trn["srg_tm"]["avg"] > 0 and trn["exp_tm"]["avg"] > 0
          and trn["srg_mem"]["avg"] > 0 and trn["exp_mem"]["avg"] > 0,
          f"train_resources: {trn}")
    torch.cuda.empty_cache()
    return total


# ViT-B/16@384: T = 577 tokens (24 x 24 patches + CLS), B = 8
T_384, B_384 = 577, 8


def phase_long_and_narrow(dev, card: str) -> None:
    """F8: K6 and K1 at ViT-B/16@384's trunk (<8, 577, 768>, "mul", LN
    prologue) against their plain versions, with device ms, and the core
    alone there (<8, 12, 577, 64>, beside SDPA); F7: a side of d = 4 (96
    in 24 heads at the ViT-B trunk, and the mini configurations' 16 in 4
    heads) on the kernel route against its plain version, its launches
    and device ms, and the core's d = 128 instance beside d = 64 at the
    same width."""
    import torch

    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import flash_attention as fa
    from autognothi_tpu_torch.ops import gates
    from autognothi_tpu_torch.ops import ladder_block as lb

    h = 768
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(SEED + 384)
        resid = torch.randn(B_384, T_384, h, generator=g).to(dev, dtype)
        ws = tuple((torch.randn(s, generator=g) * h ** -0.5).to(dev, dtype)
                   for s in [(h, h), (h,)] * 4)
        ln = ((1 + 0.1 * torch.randn(h, generator=g)).to(dev),
              (0.1 * torch.randn(h, generator=g)).to(dev), 1e-12)
        mask = (torch.rand(B_384, T_384, generator=g) > 0.3).float().to(dev)
        mask[:, 0] = 1
        for quant in ("none", "int8"):
            int8 = quant == "int8"
            if int8 and not gates.attention_block_fits(T_384, h, dtype,
                                                       quant):
                print(f"[f8] K1 {str(dtype):14s} B={B_384} T={T_384}: the "
                      f"JAX budget gate runs the float block here (K6)",
                      flush=True)
                continue
            name = "attention_block_int8" if int8 else "attention_block"
            counter = counters()[name]

            def op():
                return ab.attention_block(resid, mask, ws, 12, "mul", ln=ln,
                                          ln_position="prologue",
                                          quant=quant)
            plain = ab.attention_block_int8_plain if int8 \
                else ab.attention_block_plain

            def ref():
                return plain(resid, mask, *ws, ln[0], ln[1], n_heads=12,
                             mode="mul", ln_position="prologue",
                             ln_eps=1e-12)
            with torch.inference_mode():
                before = counter.count
                got = op()
                check(counter.count == before + 1,
                      f"{name} at T={T_384} did not reach its kernel")
                _, ok, msg = compare(got, ref(), dtype, int8)
                ms = device_time(op, 5)
                plain_ms = cuda_time(ref, 3)
            print(f"[f8] {name:20s} {str(dtype):14s} B={B_384} T={T_384} "
                  f"(ViT-B/16@384): device {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms (CUDA events); vs plain {msg} | {card}", flush=True)
            check(ok, f"{name} {dtype} at T={T_384} differs from its plain "
                      f"version")
    for s, heads, b, t, hid_w in ((96, 24, B_CHECK * 2, T, 768),
                                  (16, 4, B_CHECK, 17, 32)):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(SEED + s + t)
            check(lb.ladder_route(s, 4 * s, heads, t) == "per_branch",
                  f"side {s} / {heads} heads takes no kernel route")
            hid = torch.randn(b, t, hid_w, generator=g).to(dev, dtype)
            sides = [torch.randn(b, t, s, generator=g).to(dev, dtype)
                     for _ in range(2)]
            shapes = {"map_w": (s, hid_w), "w1": (4 * s, s),
                      "b1": (4 * s,), "w2": (s, 4 * s)}
            branches = [{k: (torch.randn(shapes.get(
                k, (s, s) if k.startswith("w") else (s,)), generator=g)
                * 0.1 + (1.0 if k in ("ln1_w", "ln2_w") else 0.0)).to(
                    dev, dtype) for k in lb.BRANCH_KEYS} for _ in range(2)]
            mask = (torch.rand(b, t, generator=g) > 0.3).float().to(dev)
            mask[:, 0] = 1
            args = (hid, sides, mask, branches, heads, "mul", True, 1e-12)
            with torch.inference_mode():
                before = lb.COUNTER_PER_BRANCH.count
                got = lb.ladder_block(*args)
                check(lb.COUNTER_PER_BRANCH.count == before + 1,
                      "the d = 4 side did not take the per-branch route")
                tensors, static = lb.ladder_block_args(*args)
                want = lb.ladder_block_plain(*tensors, **static)
                events = profiled_kernels(lambda: lb.ladder_block(*args), 5)
            _, ok, msg = compare(tuple(got), tuple(want), dtype, False)
            print(f"[f7] ladder_block route=per_branch S={s} heads={heads} "
                  f"(d=4, zero-padded to 8) {str(dtype):14s} B={b} T={t}: "
                  f"{len(events) / 5:g} launches per call, device "
                  f"{sum(ms for _, ms in events) / 5:.4f} ms; vs plain {msg} "
                  f"| {card}", flush=True)
            check(ok, f"K5 d = 4 at side {s} {dtype} differs from its plain "
                      f"version")
    # the core alone: K9 at ViT-B/16@384's T beside SDPA ("add"), and the
    # d = 128 instance (fp32 spills) beside d = 64 at the same width
    for (n, heads, t, d, mode) in ((B_384, 12, T_384, 64, "add"),
                                   (B_384, 2, T, 128, "mul"),
                                   (B_384, 4, T, 64, "mul")):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(SEED + t + d)
            q, k, v = (torch.randn(n, heads, t, d, generator=g).to(dev, dtype)
                       for _ in range(3))
            row = (torch.rand(n, t, generator=g) > 0.3).float().to(dev)
            row[:, 0] = 1
            if mode == "add":
                row = (1 - row) * torch.finfo(torch.float32).min
            with torch.inference_mode():
                got = fa.masked_attention(q, k, v, row, mode=mode)
                want = fa.masked_attention_plain(q, k, v, row, mode=mode)
                ms = device_time(lambda: fa.masked_attention(q, k, v, row,
                                                             mode=mode), 5)
                lib = (time_library_attention((q, k, v, row), card)
                       if mode == "add" else None)
            _, ok, msg = compare(got, want, dtype, False)
            tag = "f8" if t == T_384 else "f7"
            print(f"[{tag}] masked_attention core <{n}, {heads}, {t}, {d}> "
                  f"{mode} {str(dtype):14s}: device {ms:.4f} ms"
                  + (f", SDPA {lib:.4f} ms (CUDA events)" if lib else "")
                  + f"; vs plain {msg} | {card}", flush=True)
            check(ok, f"the core at <{n}, {heads}, {t}, {d}> {dtype} differs "
                      f"from its plain version")
    torch.cuda.empty_cache()


# name -> (source, the TPU kernel it replaces: its pl.pallas_call)
KERNELS = {
    "attention_block": ("autognothi_tpu_torch/csrc/gemm_wgmma.cu",
                        "autognothi_tpu/ops/attention_block.py:283"),
    "mlp_block": ("autognothi_tpu_torch/csrc/gemm.cu",
                  "autognothi_tpu/ops/mlp_block.py:191"),
    "ladder_block": ("autognothi_tpu_torch/csrc/ladder.cu",
                     "autognothi_tpu/ops/ladder_block.py:390"),
    "attention_block_int8": ("autognothi_tpu_torch/csrc/int8.cu",
                             "autognothi_tpu/ops/attention_block.py:245"),
    "mlp_ladder_block": ("autognothi_tpu_torch/csrc/int8.cu",
                         "autognothi_tpu/ops/ladder_block.py:527"),
    "head_block": ("autognothi_tpu_torch/csrc/int8_block.cu",
                   "autognothi_tpu/ops/head_block.py:138"),
    "mlp_block_int8": ("autognothi_tpu_torch/csrc/int8_block.cu",
                       "autognothi_tpu/ops/mlp_block.py:163"),
    "mlp_block_int8_tiled": ("autognothi_tpu_torch/csrc/int8.cu",
                             "autognothi_tpu/ops/mlp_block.py:294"),
    "mlp_block_tiled": ("autognothi_tpu_torch/csrc/gemm_wgmma.cu",
                        "autognothi_tpu/ops/mlp_block.py:318"),
    "masked_attention": ("autognothi_tpu_torch/csrc/attention.cu",
                         "autognothi_tpu/ops/flash_attention.py:158"),
    "ladder_attention": ("autognothi_tpu_torch/csrc/attention.cu",
                         "autognothi_tpu/ops/ladder_block.py:183"),
}
# no model calls the ladder attention op (as in the JAX package): it has no
# launches on a main path
NOT_ON_A_PATH = ("ladder_attention",)


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
    worst = phase_kernels(dev, bert_op_cases, B_BERT_CHECK, worst,
                          BERT_CALLS_PER_OP)
    with tempfile.TemporaryDirectory() as tmp:
        exp = write_experiment(pathlib.Path(tmp))
        launches, service, got_fp32 = phase_serve(dev, exp, int8=False)
        launches_int8, _, got_int8 = phase_serve(dev, exp, int8=True)
        bert_exp = write_bert_experiment(pathlib.Path(tmp))
        launches_bert, bert_service, got_bert = phase_serve(
            dev, bert_exp, int8=False, model="bert")
        launches_bert_int8, _, got_bert_int8 = phase_serve(
            dev, bert_exp, int8=True, model="bert")
        for model, fp32, int8 in (("vit", got_fp32, got_int8),
                                  ("bert", got_bert, got_bert_int8)):
            for label in fp32:
                for what in ("logits", "attributions"):
                    diff = np.abs(np.asarray(int8[label][what], np.float32)
                                  - np.asarray(fp32[label][what], np.float32))
                    print(f"[serve {model}] {label:9s} {what:12s} "
                          f"max|int8 - fp32| = {diff.max():.3e} (W8A8 vs "
                          f"fp32 path, not held)", flush=True)
        train_exp = write_train_experiment(pathlib.Path(tmp))
        case = TrainCase(dev, train_exp)
        per_step = phase_train_steps(case)
        launches_train = phase_train_cli(train_exp, per_step)
        launches_all = phase_train_all(dev, pathlib.Path(tmp), per_step,
                                       card)
        launches_reports = phase_run_all(dev, pathlib.Path(tmp), card)
        # every main path was driven from counts of 0: serve fp32 and int8
        # (ViT and BERT), train_explainer in pallas modes "2" and "1",
        # train_all's seven stages and its served final, run_all's stages
        # and six reports, faithfulness in W8A8 and in mode "1"
        for k in launches:
            launches[k] += (launches_int8[k] + launches_bert[k]
                            + launches_bert_int8[k]
                            + launches_train.get(k, 0)
                            + launches_all.get(k, 0)
                            + launches_reports.get(k, 0))
        per_op = phase_timing(dev, card, service)
        # the ViT shapes keep their rows; K8q and the bf16 float chain run
        # only at BERT's.  The four BERT forwards counted there are main
        # paths too (bf16 parameters drive the float chain)
        bert_rows, bert_calls = phase_bert_timing(dev, card, bert_service)
        for k, row in bert_rows.items():
            per_op.setdefault(k, row)
        for k, v in bert_calls.items():
            launches[k] += v
        phase_yardsticks(dev, card)
        phase_float_gemm(dev, card)
        phase_block_launches(dev, card)
        phase_ladder_route(dev, card)
        phase_long_and_narrow(dev, card)
        phase_split_chains(dev, card)
        phase_k4_teacher(dev, card)
        phase_int8_gemm(dev, card)
        phase_train_timing(case, card)

    # fp32's worst error; the bf16-only float chain its bf16 worst
    kernels = [dict(name=k, route="cuda", source=source, replaces=replaces,
                    launches=launches[k],
                    max_abs_err=worst.get(k, worst.get((k, "bf16"))),
                    **per_op[k])
               for k, (source, replaces) in KERNELS.items()]
    for k in kernels:
        check(k["launches"] > 0 or k["name"] in NOT_ON_A_PATH,
              f"{k['name']}: no launch on the main path")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
