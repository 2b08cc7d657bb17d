#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`autognothi_tpu_torch`) on one NVIDIA
GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py
    python3 chip_smoke.py --dist-cards 4   # phase 16 (b), one NCCL rank
                                           # per card, on a 4-card host

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
     modes (T = 512 at d = 64 walks the keys in chunks).  The vanilla
     towers' shapes: the explainer's first layer at the trunk width,
     attention without LN (K6, K1; BERT's "add" K6 and, in bf16, K1), and
     K3's wide route on a 768-wide input (768 -> 3072 -> 3072 -> 10 with
     LN; BERT's -> 2 without).  `[k3-wide]`: that route alone at <64, 197,
     768> (fp32, bf16) and <8, 512, 768>, its CUDA-event and device ms and
     launches beside its bound and `torch._int_mm` on the same products;
  3. the slice through `serve`: a random LTT ViT-B/16@224 final (seeded
     torch.Generator) saved as `final-epoch-0.ckpt`, served on the card at
     batch 8, once on the fp32 path and once with AUTOGNOTHI_INT8=1; each
     time an `images` request of 3 rows and an `images_u8` request of 9
     rows (two slabs) are checked for shape, normalisation, finiteness, the
     kernel call counts per slab that went through the kernels (a CUDA
     graph's replay calls none: warmup's eager and captured slabs hold
     the counts, and every request slab is a replay, `hold_slab_calls`;
     fp32: 13 attention, 13 MLP, 12 ladder;
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
     step's spans (`utils.tracing.span`): the profiler attributes no device
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
     (the same widths and data, 4 of the 12 layers: `RUN_ALL_LAYERS`)
     with eval blocks (faithfulness at
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

  8. LTT BERT training and reports through `run_all`: a `random_init`
     experiment with experiments/bert_base_tayp_ltt's `net.params` (full
     width, 4 of the 12 layers: `BERT_RUN_ALL_LAYERS`, dropout 0) on the
     bundled `nlp_samples` (24
     sentences) with a `build_vocab` vocabulary, the shipped training
     blocks at one epoch each (classifier and surrogate batch 8, the
     surrogate progressive; explainer batch 4 x M = 2; lr 5e-5) and the
     shipped eval blocks cut as BERT_RUN_ALL_EVAL says (faithfulness at
     16 stops: 64 coalitions a sentence; train resources 8 samples; a CKA
     block at batch 8), through `python -m autognothi_tpu_torch run_all
     <exp> --device cuda` (`cli_main`): each stage's kernel calls against
     its steps' and forwards', the coherency line, `serve` of the final
     answering a `texts` request of 3 rows against its plain forward, the
     six reports with their seconds and kernel calls (K6, K7, K5 in each),
     a second `measure_all` that launches nothing; the quality gate
     (faithfulness with the kernels against the plain versions on the
     card: fp32 within 1e-3; W8A8 within 5e-3, launching K6, K8q, K5, K1,
     K4, K3; mode "1" within 1e-3, launching K9); cls_acc and accuracy
     against the plain run; one classifier, surrogate and explainer step
     with the fp32 and the int8 teacher against their plain versions
     (`[bert stage-step]`) and their ms/step and spans (`[bert
     stage-time]`); a surrogate step at dropout 0.1 (no kernel in its
     differentiated forward, kernels in its teacher); the performance and
     train-resources numbers.

  9. and 10. the vanilla and froyo towers of ViT-B/16@224 (9) and
     BERT-base@512 (10), the shipped `vit_base_imagenette_vanilla` and
     `bert_base_tayp_vanilla` `net.params` (random_init, dropout 0,
     full depth but `run_all` at 4 of the 12 layers,
     `TOWER_RUN_ALL_LAYERS`; faithfulness at 8 stops, one performance
     loop): a
     random vanilla final served fp32 and W8A8 (phase 3's requests; 37
     attention and 37 MLP blocks a slab, the W8A8 head on K3's wide
     route), then `fw_final` at B = 8 on the other paths (ViT mode "1";
     BERT int8 with bf16 parameters, bf16, mode "1"), each against its
     plain forward with its kernel calls (`VANILLA_COUNTS`), timed and
     profiled; `run_all` through `cli_main` with phase 6's / phase 8's
     data and blocks: each stage's kernel calls, coherency 0.0 / 0.0, the
     six reports, a second `measure_all` that launches nothing, the
     quality gate fp32 / W8A8 / mode "1", cls_acc and accuracy against
     plain, each stage's step against plain with its kernel calls and the
     plain recomputes its backward runs (`primitives.RECOMPUTES`), the
     steps' ms and spans; a froyo `train_all` at 4 layers, its final
     served fp32 and W8A8 (7 + 7 blocks a slab), its steps against
     plain (the backward recomputes the explainer layer's two ops, no
     trunk op) and the explainer step timed against plain.  Each phase
     prints its seconds (`[phase]` lines).

  11. the duo towers of both families (`vit_base_imagenette_vanilla` and
     `bert_base_tayp_duo_vanilla` `net.params`, random_init, dropout 0):
     a random duo final served fp32 and W8A8 at full depth (25 attention
     and 25 MLP blocks a slab, `DUO_COUNTS`; duo BERT's head gives raw
     logits), `fw_final` at B = 8 on the other paths, timed and profiled;
     `run_all` through `cli_main` at 4 of the 12 layers
     (`TOWER_RUN_ALL_LAYERS`) with phase 9's / 10's data and blocks: the
     duo explainer trainer, no coherency check (as in the JAX recipe),
     the seven reports, a second `measure_all` that launches nothing, the
     quality gate, cls_acc and accuracy against plain, the dual-task
     similarity against its plain run on the same masks
     (`DUAL_TASK_TOL`), the duo explainer step (fp32 and int8 teacher)
     against plain with its kernel calls and plain recomputes, timed with
     its spans.
  12. a random KernelSHAP BERT-base@512 (the shipped `net.params`, full
     depth, 1024 coalitions over 2 background rows: `KSHAP_SAMPLES`):
     `train_all` through `cli_main` (k-means on the host), the host final
     served at batch 2 for a `texts` request of 2 rows, fp32 and W8A8,
     its classifier slabs' kernel calls (`KSHAP_COUNTS`) and its
     probabilities and attributions against the plain versions on the
     card, the faithfulness quality gate over one input of 512 tokens,
     one profiled explained row per path.
  13. a random vanilla ViT-L/16@224 (`vit_large_imagenette_vanilla`'s
     `net.params`: hidden 1024, 16 heads, all 24 layers, MLP 4096, head
     4096; random_init, dropout 0): the routes the JAX gates pick at T =
     197 (`vit_large_routes`), the final served fp32 and W8A8 (phase 3's
     requests, 73 attention and 73 MLP blocks a slab: `VANILLA_COUNTS`),
     `fw_final` at B = 8 on W8A8 with bf16 parameters, bf16 and mode "1",
     each path against its plain forward, timed (expl/s) and profiled;
     each op at its ViT-L shape against plain with its device ms,
     launches, bound and library time (`[vit-l op]`); the image demo
     (`run_image_explanation` over 64 `cv_samples` images at 224 px, the
     kernels against plain, `[image demo]`).
  14. the demos and the other verbs through `cli_main` on phases 8's and
     9's checkpoints (`run_text_explanation --limit 2`, the Shapley
     preview of one sentence with the kernels against plain,
     `__show_fridge__`, `estimate_train_time`, `pretrain_classifier` into
     a temporary zoo store and a second experiment's conversion from it,
     `preload_all`; `[demos]` lines).  Then the native cores: WordPiece's
     build seconds and the texts it encoded over the run, the image
     core's resize against the numpy grid (`phase_native`; the run fails
     if a core did not load or WordPiece encoded none).
  15. (run right after phase 3, on its finals) `export_final` and `serve
     --artifact`: the `--kernels` artifacts (the kernel ops as
     `torch.library` custom ops) of the LTT ViT-B/16@224 final, fp32 and
     W8A8, and of the LTT BERT-base@512 final, W8A8, at B = 8, each
     served from its file with phase 3's requests: kernel calls a slab
     equal to phase 3's tables, every answer bit-identical to phase 3's
     live serving; the default artifact (the plain math, one file for
     cuda and cpu) loaded on the card and on the CPU, each within 1e-5 of
     the live plain forward (pallas mode "0") there, and a symbolic-batch
     one at B = 3 and 8, both of the final's first 4 layers
     (`EXPORT_PLAIN_LAYERS`: at full depth their traces and loads were the
     phase's largest part); export and load seconds, bytes, and expl/s of each
     artifact against its live path at B = 8 (`[export]` lines).
  16. (run right after phase 4) the multi-device slice, in child
     processes started together (`--dist-child`, each with its own
     timeout; budget 75 s, ~40-55 s measured): (a) a world of one
     through the CLI's own initialisation (AUTOGNOTHI_DIST_* on
     127.0.0.1, NCCL): phase 4's explainer step at B = 8 x M = 32 bit-
     identical to the step without the world, and a W8A8 serve of phase
     3's requests bit-identical to phase 3's answers with its kernel
     calls a slab; (b) two gloo ranks on the one card (NCCL takes one rank
     per card): the data-parallel step (4 images a rank) against the
     one-process step in the same arithmetic (loss within 1e-6 relative,
     the parameters within 1e-6 where the gradient is settled, the ranks
     bit for bit), the tensor-parallel (model 2) step in mode "0" at B =
     2 x M = 4 against the one-process plain step, the W8A8 slabs split
     over the ranks (each rank's kernel calls a slab) and a
     `--data-parallel 2 --kernels` artifact served, both against phase
     3's answers (`[dist]` lines, each with the card).

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
    # the vanilla towers: the explainer's first layer at the trunk
    # width, attention without LN1 (K6, K1), and the head on the trunk's
    # 768-wide hidden state (K3's wide route, F11)
    for name, (op, plain) in attn.items():
        ws = [t for _ in range(4) for t in lin(768, 768)]
        cases.append((name, "trunk 768 no-LN", op,
                      _plain(ab.attention_block_args, plain),
                      (act(b, T, 768), mask, tuple(ws), 12, "mul"), {}))
    (w1, b1), (w2, b2), (w3, b3) = lin(3072, 768), lin(3072, 3072), \
        lin(10, 3072)
    lnw, lnb, _ = ln(768)
    cases.append(("head_block", "768-3072-3072-10 wide",
                  hb.explainer_head_block,
                  _plain(hb.explainer_head_block_args, hb.head_int8_plain),
                  (act(b, T, 768), w1, b1, w2, b2, w3, b3, lnw, lnb, 1e-5),
                  {}))
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
    # the vanilla towers: the explainer's first layer at the trunk
    # width, attention without its LN (`ident_ln1`; K6, and K1 in bf16),
    # and the head on the trunk's 768-wide hidden state (K3's wide route)
    ws = tuple(x for _ in range(4) for x in lin(h, h))
    for name, op in attn:
        cases.append((name, "trunk 768 add no-LN", op, _under_plain(op),
                      (act(b, t, h), bias, ws, 12, "add"),
                      dict(ln=None, ln_position="epilogue")))
    (w1, b1), (w2, b2), (w3, b3) = lin(3072, h), lin(3072, 3072), lin(2, 3072)
    cases.append(("head_block", "768-3072-3072-2 no-LN wide",
                  hb.explainer_head_block,
                  _under_plain(hb.explainer_head_block),
                  (act(b, t, h), w1, b1, w2, b2, w3, b3, None, None, 1e-5),
                  {}))
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
                                    "ladder_attention_kernel",
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


# served paths whose capture raises, so that the service runs them eagerly:
# ViT-L's W8A8 final (its eager W8A8 denses copy a host tensor to the card
# inside the forward)
EAGER_SERVES = ("serve vanilla vit_large int8",)


def hold_slab_calls(tag: str, service, per_slab: dict, warm: dict,
                    warm_runs: dict, calls: dict, runs: dict,
                    slabs: int) -> dict:
    """The kernel ops count the calls of the slabs that ran through them,
    an eager slab's and a captured one's, and nothing for a replayed slab
    (`pipeline/serve.py`).  Holds the requests' calls (and, where the
    service replays, its warmup's, from counts of 0 before it started)
    against `per_slab` times those slabs; `runs` (the service's
    `slab_counts` over the requests) against the `slabs` served: every one
    replayed where the service replays, as warmup captured its keys, else
    every one eager.  A path of `EAGER_SERVES` must have fallen back in
    warmup (whose calls then include the failed captures') and serve
    eagerly.  -> the calls the service's kernels made."""
    fell_back = tag in EAGER_SERVES
    if fell_back:
        check(service.replays and warm_runs["graph_fallbacks"] > 0
              and warm_runs["graph_captures"] == 0,
              f"{tag}: expected every capture to fall back, {warm_runs}")
    for what, got, ran in (("warmup", warm, warm_runs),
                           ("requests", calls, runs)):
        n = ran["eager_slabs"] + ran["graph_captures"]
        want = {name: per_slab.get(name, 0) * n for name in got}
        print(f"[{tag}] {what}: {ran}; kernel calls {got} (expected "
              f"{want}: {n} slabs through the kernels)", flush=True)
        if what == "warmup" and (fell_back or not service.replays):
            continue
        check(got == want, f"{tag} {what}: kernel calls differ from "
                           f"{per_slab} per slab")
    way = ("graph_replays" if service.replays and not fell_back
           else "eager_slabs")
    check(runs[way] == slabs and runs["graph_fallbacks"] == 0,
          f"{tag}: {slabs} slabs served, {runs}")
    return _scaled((1, warm if service.replays else {}), (1, calls))


def serve_requests(exp: pathlib.Path, requests: list, per_slab: dict,
                   tag: str, artifact: pathlib.Path = None):
    """Serve the experiment's final (or `artifact`, an `export_final`
    artifact) on the card at batch 8 and post `requests`; the counts set
    to 0 just before the server starts and again just before the
    requests -> (kernel calls, service, the responses by request label).
    Three slabs of 8 (1 + 2), their kernel calls held against `per_slab`
    (`hold_slab_calls`)."""
    import numpy as np

    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import serve_in_thread

    env = ExpEnv(exp)
    t0 = time.perf_counter()
    reset_counts()
    server, service, thread = serve_in_thread(env, port=0, batch_size=8,
                                              device="cuda",
                                              artifact=artifact)
    warm, warm_runs = read_counts(), dict(service.slab_counts)
    port = server.server_address[1]
    print(f"[{tag}] server up on the card in "
          f"{time.perf_counter() - t0:.1f} s (warmup slabs run)",
          flush=True)
    try:
        check(_get(port, "/healthz") == {"status": "ok"}, "healthz")
        stats0 = _get(port, "/statz")
        reset_counts()
        got = {label: _post(port, {kind: np.asarray(rows).tolist()
                                   if kind != "texts" else rows})
               for label, kind, rows in requests}
        launches = read_counts()
        stats = _get(port, "/statz")
        slabs = stats["slabs"] - stats0["slabs"]
        runs = {k: stats[k] - stats0[k] for k in warm_runs}
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "server thread did not stop")
    env.close()

    print(f"[{tag}] {slabs} slabs", flush=True)
    check(slabs == 3, f"expected 3 slabs (1 + 2), got {slabs}")
    launches = hold_slab_calls(tag, service, per_slab, warm, warm_runs,
                               launches, runs, slabs)
    return launches, service, got


def phase_serve(dev, exp: pathlib.Path, int8: bool, model: str = "vit",
                per_slab: dict = None, tag: str = None,
                probabilities: bool = True):
    """Serve the experiment on one path; -> (kernel calls, service, the
    responses by request label).  Three slabs of 8 (1 + 2), their kernel
    calls against the path's table (the LTT finals' unless `per_slab` is
    given), the responses against the plain forward of the same module on
    the same path; `probabilities`: the logits are a softmax's (not the
    duo BERT's raw logits)."""
    import numpy as np
    import torch

    path = "int8" if int8 else "fp32"
    if model.startswith("vit"):
        table = INT8_COUNTS if int8 else FP32_COUNTS
        requests, n_labels, n_players = vit_requests(), 10, 196
    else:
        table = BERT_COUNTS[path]
        requests, n_labels, n_players = bert_requests(), 2, T_BERT - 1
    per_slab = per_slab or table
    tag = tag or f"serve {model} {path}"
    with int8_mode(int8):
        launches, service, got = serve_requests(exp, requests, per_slab, tag)
        for label, kind, rows in requests:
            logits = np.asarray(got[label]["logits"], np.float32)
            attr = np.asarray(got[label]["attributions"], np.float32)
            n = len(rows)
            check(logits.shape == (n, n_labels),
                  f"{label}: logits {logits.shape}")
            check(attr.shape == (n, n_labels, n_players),
                  f"{label}: attr {attr.shape}")
            check(not probabilities
                  or bool(np.abs(logits.sum(-1) - 1).max() < 1e-4),
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
                                                      init_ltt_bert)
    from autognothi_tpu_torch.params import save_params, to_flat

    hp = json.loads(BERT_EXP.read_text())
    exp = tmp / "ltt_bert_base"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    WordPieceTokenizer(build_vocab(CORPUS)).save(exp / "tokenizer")
    cfg = LttBertConfig(**hp["net"]["params"])
    t0 = time.perf_counter()
    model = init_ltt_bert(cfg, "final", torch.Generator().manual_seed(SEED))
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


# Profiled windows that lost device events and were profiled again
# (`profiled_kernels`), and the most calls a kept window needed ahead of
# it, printed at the end of the run
PROFILE_LOSSES = {"windows": 0, "lead": 0}
# the window's bounds: an int16 fill, which no op of the port launches
PROFILE_MARK = "FillFunctor<short"


def profiled_kernels(fn, reps: int, tries: int = 10) -> list:
    """The device kernels of `reps` calls of `fn` after one warmup call, as
    (name, device ms) in launch order.  One profiler session runs `lead`
    calls, an int16 fill, the `reps` calls kept and a second fill; the
    kept window is what lies between the fills.  On the H100's host, late
    in a long process, a session loses its first device events, as many
    as a few calls' worth and the same number on every try, and now and
    then all of them; the lead calls take that loss.  Every call launches
    the same kernels, so a session whose fills are not both seen, or
    whose window sees a kernel a number of times that is not a whole
    multiple of the calls (or no kernel at all), lost events: it is
    profiled again with twice the lead, and after `tries` such sessions
    this raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def mark():
        torch.zeros(1, dtype=torch.int16, device="cuda")

    fn()
    counts: dict = {}
    lead = reps
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                fn()
            mark()
            for _ in range(reps):
                fn()
            mark()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and e.name not in SPANS),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if PROFILE_MARK in e.name]
        counts = {}
        if len(marks) == 2:
            events = events[marks[0] + 1:marks[1]]
            for e in events:
                counts[e.name] = counts.get(e.name, 0) + 1
        if counts and all(n % reps == 0 for n in counts.values()):
            PROFILE_LOSSES["lead"] = max(PROFILE_LOSSES["lead"], lead)
            return [(e.name, e.time_range.elapsed_us() / 1e3)
                    for e in events]
        PROFILE_LOSSES["windows"] += 1
        print(f"[profile] {len(marks)} of 2 bounds and device events per "
              f"kernel in a window of {reps} calls after {lead} (try "
              f"{attempt + 1}): {counts}", file=sys.stderr, flush=True)
        lead *= 2
    raise RuntimeError(f"the profiler lost device events in {tries} "
                       f"sessions; the last: {counts}")


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
                                                    "attention_block",
                                                    "ladder_attention")
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
                if name == "ladder_attention":
                    # K10 at d = 8: every branch in one launch
                    check(launches == 1 and all(
                        "ladder_attention_kernel" in k for k in kernels),
                        f"{name} {tag}: {launches} launches per call "
                        f"({sorted(kernels)})")
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
    """The trained classifier and surrogate of a train_all experiment on
    the card (and its explainer, where `explainer` gives the explainer
    stage's batch and M), the first train batch of `batch` inputs, one
    `mask_purely_uniform` coalition per input and M Shapley masks per
    explainer input; each step on fresh copies of its stage's model."""

    def __init__(self, dev, exp: pathlib.Path, batch: int = TRAIN_B,
                 explainer: tuple = None):
        import torch

        from autognothi_tpu_torch.ops.shapley import (mask_purely_uniform,
                                                      mask_shapley)
        from autognothi_tpu_torch.pipeline.env import ExpEnv
        from autognothi_tpu_torch.pipeline.resources import (
            get_recipe, load_cfg_dataset, load_epoch_model, load_misc)

        sections = ("classifier", "surrogate") + (
            ("explainer",) if explainer else ())
        with ExpEnv(exp) as env:
            self.recipe, self.cfg = get_recipe(env.config)
            self.models = {s: load_epoch_model(env, self.recipe, s, dev)[1]
                           for s in sections}
            loader = load_cfg_dataset(env.config.dataset)
            misc = load_misc(env, self.recipe, self.cfg)
        raw_xs, raw_ys = next(iter(loader.train(batch)))
        xs, ys = self.recipe.gen_input(self.cfg, misc)(raw_xs, raw_ys)
        self.xs = torch.from_numpy(xs).to(dev)
        self.labels = torch.from_numpy(ys).to(dev)
        self.batch = batch
        self.n_players = p = self.recipe.n_players(self.cfg)
        self.ones = torch.ones((batch, p), dtype=torch.int32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        self.mask = mask_purely_uniform(gen, batch, p)
        self.w = torch.ones(batch, device=dev)
        if explainer:
            self.exp_b, self.m = explainer
            self.masks = mask_shapley(gen, self.exp_b * self.m, p).reshape(
                self.exp_b, self.m, p)
            with torch.no_grad(), train_env("2", "fp32"):
                nil = torch.from_numpy(self.recipe.gen_null(self.cfg, misc))
                self.null, _ = self.recipe.fw_surrogate(
                    self.cfg, self.models["surrogate"].requires_grad_(False),
                    nil.to(dev), torch.ones((1, p), dtype=torch.int32,
                                            device=dev))

    def fresh(self, stage: str, cfg=None, generator=None):
        """-> a run() that takes one train step of `stage` on its own copy
        of the model (the surrogate's teacher included), -> the loss.
        `cfg` replaces the model config (a dropout step), `generator`
        draws its dropout masks."""
        from autognothi_tpu_torch.parallel.train_step import \
            make_explainer_train_step
        from autognothi_tpu_torch.pipeline.train_classifier import \
            classifier_loss
        from autognothi_tpu_torch.pipeline.train_surrogate import (
            surrogate_loss, surrogate_teacher)
        from autognothi_tpu_torch.pipeline.training import (AdamW,
                                                            make_train_step)

        cfg = cfg or self.cfg
        is_ltt = self.recipe.progressive_trainable is not None
        model = copy.deepcopy(self.models[stage])
        trainable = self.recipe.trainable(cfg, stage)
        for name, p in model.named_parameters():
            p.requires_grad_(trainable(name))
        params = dict(model.named_parameters())
        opt = AdamW(params, trainable)
        ones = {k: 1.0 for k in params}
        depth = cfg.num_hidden_layers
        if stage == "classifier":
            step = make_train_step(classifier_loss(self.recipe, cfg, is_ltt))
            return lambda: step(model, opt, 5e-5, ones, self.xs, self.ones,
                                self.labels, generator, depth, self.w)[0]
        if stage == "explainer" and self.recipe.training.exp_variant_duo:
            # the duo step: cross-entropy on the explainer's head + Shapley
            from autognothi_tpu_torch.pipeline.train_duo_explainer import \
                make_duo_explainer_steps

            step, _ = make_duo_explainer_steps(self.recipe, cfg,
                                               self.n_players, self.m)
            xs, zs = self.xs[:self.exp_b], self.labels[:self.exp_b]
            return lambda: step(model, opt, self.models["surrogate"],
                                self.null, xs, zs, generator, 5e-5, ones,
                                masks=self.masks)[0]
        if stage == "explainer":
            step = make_explainer_train_step(self.recipe, cfg,
                                             self.n_players, self.m)
            xs = self.xs[:self.exp_b]
            return lambda: step(model, opt, self.models["surrogate"],
                                self.null, xs, generator, 5e-5, ones, depth,
                                masks=self.masks)
        step = make_train_step(surrogate_loss(self.recipe, cfg, is_ltt))
        teacher = surrogate_teacher(self.recipe, cfg)
        cls = self.models["classifier"]

        def run():
            orig = teacher(cls, self.xs, self.ones)
            return step(model, opt, 5e-5, ones, self.xs, self.mask, orig,
                        self.labels, generator, depth, self.w)[0]
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


def _depth(counts: dict, layers: int) -> dict:
    """Kernel calls counted for 12-layer towers (12 a layer's op per tower,
    plus fewer than 12 side layers' or heads') at `layers` layers."""
    return {k: v // 12 * layers + v % 12 for k, v in counts.items()}


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


def phase_stage_timing(case: StageCase, card: str,
                       runs=(("classifier", "classifier", "fp32"),
                             ("surrogate", "surrogate", "fp32")),
                       tag: str = "[stage-time]") -> None:
    """ms per step of each (label, stage, teacher) of `runs`, kernels and
    plain in turns (plain, kernels, kernels, plain), 3 steps after a
    warmup each; then one step of each split into its spans (the
    explainer's teacher, forward, backward, AdamW; the surrogate's teacher
    is outside them)."""
    import torch

    from autognothi_tpu_torch.utils import tracing

    reps = 3
    for label, stage, teacher in runs:
        steps = {"kernels": case.fresh(stage), "plain": case.fresh(stage)}
        ms = {"plain": [], "kernels": []}
        for which in ("plain", "kernels", "kernels", "plain"):
            ctx = plain_ops() if which == "plain" else contextlib.nullcontext()
            with train_env("2", teacher), ctx:
                steps[which]()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    steps[which]()
                torch.cuda.synchronize()
            ms[which].append((time.perf_counter() - t0) / reps * 1e3)
        batch = f"B={case.exp_b} x M={case.m}" if stage == "explainer" \
            else f"B={case.batch}"
        for which, vals in ms.items():
            print(f"{tag} {label} step {batch} {which:7s}: "
                  f"{' '.join(f'{v:.2f}' for v in vals)} ms/step | {card}",
                  flush=True)
        for which in ("kernels", "plain"):
            ctx = plain_ops() if which == "plain" else contextlib.nullcontext()
            timer = SpanTimer()
            with train_env("2", teacher), ctx, \
                    mock.patch.object(tracing, "span", timer):
                steps[which]()
            spans = timer.totals()
            print(f"{tag} {label} {which:7s} step split (CUDA "
                  f"events): "
                  f"{', '.join(f'{k} {v:.2f} ms' for k, v in spans.items())}"
                  f" | {card}", flush=True)


def serve_final(dev, exp: pathlib.Path, texts: list = None,
                tag: str = "[train_all]", layers: int = 12) -> dict:
    """`serve` from the experiment's final-epoch-0.ckpt: one `images`
    request of 3 rows (or, for a BERT experiment, the `texts` given),
    held against the plain forward of the served model at the serve gate;
    -> the request's kernel calls."""
    import numpy as np
    import torch

    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import serve_in_thread

    env = ExpEnv(exp)
    reset_counts()
    server, service, thread = serve_in_thread(env, port=0, batch_size=8,
                                              device="cuda")
    warm, warm_runs = read_counts(), dict(service.slab_counts)
    port = server.server_address[1]
    if texts is None:
        rows = np.random.RandomState(SEED + 7).rand(3, 3, 224, 224).astype(
            np.float32)
        payload, label, want_calls = {"images": rows.tolist()}, "images", \
            FP32_COUNTS
    else:
        rows, _ = service.gen_input(texts, [0] * len(texts))
        payload, label, want_calls = {"texts": texts}, "texts", \
            BERT_COUNTS["fp32"]
    try:
        reset_counts()
        got = _post(port, payload)
        calls = read_counts()
        runs = {k: v - warm_runs[k] for k, v in service.slab_counts.items()}
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
        print(f"{tag} served final, {label} x{len(rows)}, {what} "
              f"{tuple(mine.shape)} vs plain forward: {msg}", flush=True)
        check(ok, f"the served final's {what} differ from the plain forward")
    return hold_slab_calls(f"{tag.strip('[]')} serve", service,
                           _depth(want_calls, layers), warm, warm_runs,
                           calls, runs, 1)


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
    """Stands in for the port's one span primitive (`utils.tracing.span`)
    in the train step: CUDA events at each span's ends, so each span's time on the card's stream is read."""

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

    from autognothi_tpu_torch.utils import tracing

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
                    mock.patch.object(tracing, "span", timer):
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
            if name == "ladder_attention" and name not in per_op:
                t_lib = time_library_ladder_attention(args, card)
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
                        "mlp_ladder_block", "ladder_attention"):
            continue
        with torch.inference_mode():
            _, ok, msg = compare(op(*args, **kw), plain(*args, **kw),
                                 torch.bfloat16, name in INT8_OPS)
            timed_msg = "checked"
            if name == "ladder_attention":  # K10 in bf16: timed too
                t_kern = cuda_time(lambda: op(*args, **kw), reps=10)
                t_lib = time_library_ladder_attention(args, card)
                bound_ms, bound_by = op_bound(name, args)
                timed_msg = (f"kernel {t_kern:.4f} ms, SDPA {t_lib:.4f} "
                             f"ms, bound {bound_ms:.4f} ms ({bound_by})")
        print(f"[time] {name:20s} {tag:22s} bf16 B={B_TIME}: {timed_msg} "
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


def time_library_ladder_attention(args, card: str) -> float:
    """`F.scaled_dot_product_attention` per branch on the ladder attention
    op's inputs, its 0/1 mask row as a boolean `attn_mask`: the yardstick
    of K10, timed here only.  A masked key is left out there, while the
    op's "mul" mode multiplies its score by 0 (the JAX package's quirk):
    the same work, another function, so the difference is printed, not
    held."""
    import torch.nn.functional as F

    from autognothi_tpu_torch.ops import ladder_block as lb

    qkvs, mask_row, n_heads, mode = args
    keep = mask_row.bool()[:, None, None, :]
    heads = [tuple(lb._heads(x, n_heads) for x in tr) for tr in qkvs]

    def sdpa():
        return [F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
                for q, k, v in heads]

    want = _ladder_attention_plain(qkvs, mask_row, n_heads, mode, mode=mode)
    err = max(float((g.transpose(1, 2).reshape(w.shape) - w).abs().max())
              for g, w in zip(sdpa(), want))
    t_lib = cuda_time(sdpa, reps=10)
    print(f"[time] ladder_attention library yardstick "
          f"F.scaled_dot_product_attention x {len(qkvs)} "
          f"{tuple(heads[0][0].shape)} {qkvs[0][0].dtype}, boolean mask: "
          f"{t_lib:.4f} ms (max|sdpa - plain {mode}| = {err:.3e}, another "
          f"function) | {card}", flush=True)
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
    design at most three and BERT's post-norm LN; K3 at most three on its
    narrow route (`head_d1_kernel`), five on the wide one, none of
    `csrc/gemm.cu`'s (`gemm_tc_kernel`); neither a copy or fill."""
    if name == "mlp_block_int8":
        if any("mlp_narrow_kernel" in k for k in kernels):
            check(launches == 1, f"K4 {tag}: {launches} launches per call "
                                 f"on the narrow design")
        else:
            check(launches <= 3 + int(post_ln),
                  f"K4 {tag}: {launches} launches per call on the trunk "
                  f"design")
    else:
        narrow = any("head_d1_kernel" in k for k in kernels)
        check(launches <= (3 if narrow else 5),
              f"K3 {tag}: {launches} launches per call on the "
              f"{'narrow' if narrow else 'wide'} route")
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
# the duo recipes' seventh report
DUAL_TASK = ("measure_dual_task_similarity", "dual_task_similarity.json")
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
# the cut that keeps phase 7 inside the time limit: ViT-B/16@224 widths
# at 4 of the 12 layers (6 until phase 15 came; phase 3 serves the full
# depth), 8 test images at 16 faithfulness stops (10 classes x 16 stops x
# 2 directions = 320 coalitions an image).  The towers' run_all stays at 4
# (TOWER_RUN_ALL_LAYERS): at 3 the vanilla ViT surrogate step's loss is
# ~5e-5, a KL between near-identical heads, whose float noise passes the
# step gate's 1e-4 relative bound
RUN_ALL_LAYERS = 4
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
    at RUN_ALL_LAYERS, with the eval blocks of RUN_ALL_EVAL."""
    exp = write_train_all_experiment(tmp, name="run_all")
    hp = json.loads((exp / ".hparams.json").read_text())
    hp["net"]["params"]["num_hidden_layers"] = RUN_ALL_LAYERS
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
        for name in REPORT_FNS + DUAL_TASK[:1]:
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
        load_epoch_model, load_epoch_params, load_misc)
    from autognothi_tpu_torch.utils.seeding import iterative_generator

    with ExpEnv(exp) as env:
        cfg = env.config
        recipe, m_cfg = get_recipe(cfg)
        loader = load_cfg_dataset(cfg.dataset)
        misc = load_misc(env, recipe, m_cfg)
        gen_input = recipe.gen_input(m_cfg, misc)
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
                    m_cfg, misc, cls_p, srg_p, exp_p, iterative_generator(
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
                       want: dict, dev, tag: str = "[run_all]") -> None:
    """The kernel run's cls_acc or accuracy report equals the plain run's,
    or each difference is a flipped argmax the plain forward nearly ties
    (its two best classes within FLIP_MARGIN), named."""
    if got == want:
        print(f"{tag} {report}: kernels {got['accuracy']} == plain "
              f"{want['accuracy']}", flush=True)
        return
    preds = report_predictions(exp, report, dev)
    flips = [p for p in preds if p[1] != p[2]]
    for key, k_cls, p_cls, label, margin in flips:
        print(f"{tag} {report}: {key} flips kernel {k_cls} / plain "
              f"{p_cls} (label {label}), plain top-2 margin {margin:.2e}",
              flush=True)
    check(flips and all(p[4] <= FLIP_MARGIN for p in flips),
          f"{report}: kernels {got} != plain {want}, not explained by "
          f"near-tied flips")
    print(f"{tag} {report}: kernels {got['accuracy']} vs plain "
          f"{want['accuracy']}: {len(flips)} flipped argmax, each within "
          f"{FLIP_MARGIN:g} of a tie in the plain forward", flush=True)


def run_report_gate(dev, exp: pathlib.Path, faith_kernels: dict,
                    texts: dict, card: str, tag: str) -> dict:
    """The quality gate (faithfulness with the kernels against the plain
    versions on the card: fp32, W8A8, mode "1"; each kernel run launching
    `faith_kernels[path]`), then cls_acc and accuracy against the plain
    run; -> the kernel calls of the W8A8 and mode "1" faithfulness runs."""
    import torch

    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.measure_accuracy import \
        measure_accuracy
    from autognothi_tpu_torch.pipeline.measure_cls_acc import \
        measure_cls_acc
    from autognothi_tpu_torch.pipeline.measure_faithfulness import \
        measure_faithfulness
    from autognothi_tpu_torch.pipeline.reports import to_json

    total: dict = {}
    kernel_faith = {"fp32": json.loads(texts["faithfulness.json"])}
    for path in ("fp32", "int8", "mode 1"):
        pallas, int8 = FAITH_ENV[path]
        with report_env(pallas, int8):
            if path != "fp32":
                torch.cuda.synchronize()
                reset_counts()
                t1 = time.perf_counter()
                with ExpEnv(exp) as env:
                    kernel_faith[path] = to_json(measure_faithfulness(
                        env, device="cuda"))
                torch.cuda.synchronize()
                run = {k: v for k, v in read_counts().items() if v}
                print(f"{tag} faithfulness {path}: "
                      f"{time.perf_counter() - t1:.2f} s, kernel calls "
                      f"{run} | {card}", flush=True)
                check(all(run.get(k, 0) > 0 for k in faith_kernels[path]),
                      f"faithfulness {path} launched no "
                      f"{faith_kernels[path]} kernel: {run}")
                total = _scaled((1, total), (1, run))
            t1 = time.perf_counter()
            with plain_ops(), ExpEnv(exp) as env:
                plain = to_json(measure_faithfulness(env, device="cuda"))
            plain_s = time.perf_counter() - t1
        got = kernel_faith[path]
        worst, curve, points = faith_drift(got, plain)
        print(f"{tag} quality gate, faithfulness {path}: AUCs "
              + ", ".join(f"{c} {got[c]['auc']:.6f} (plain "
                          f"{plain[c]['auc']:.6f})" for c in CURVES)
              + f"; worst AUC drift {worst:.3e} on {curve} (limit "
              f"{FAITH_TOL[path]:g}); largest curve-point drift "
              f"{points:.3e}; plain run {plain_s:.2f} s | {card}",
              flush=True)
        check(worst <= FAITH_TOL[path],
              f"faithfulness {path}: AUC drift {worst:.3e} on {curve} "
              f"above {FAITH_TOL[path]:g}")
    for report, fn in (("cls_acc", measure_cls_acc),
                       ("accuracy", measure_accuracy)):
        with report_env("2", False), plain_ops(), ExpEnv(exp) as env:
            want = to_json(fn(env, device="cuda"))
        check_report_equal(exp, report, json.loads(texts[f"{report}.json"]),
                           want, dev, tag=tag)
    return total


def check_report_files(exp: pathlib.Path, calls: dict, seconds: dict,
                       kernels: tuple, card: str, tag: str,
                       dual_task: bool = False) -> dict:
    """The six files run_all wrote (seven with `dual_task`), each report's
    seconds and kernel calls (each launched every one of `kernels`), then
    a second `measure_all` that reloads them and launches nothing; -> the
    reports' texts."""
    import torch

    from autognothi_tpu_torch.cli import main as cli_main

    reports = exp / ".reports"
    files = tuple(sorted(p.name for p in reports.iterdir()))
    want_files = tuple(sorted(REPORT_FILES + DUAL_TASK[1:] * dual_task))
    check(files == want_files, f"run_all wrote {files}")
    for name in REPORT_FNS + DUAL_TASK[:1] * dual_task:
        got = calls.get(name, {})
        print(f"{tag} {name}: {seconds.get(name, 0.0):.2f} s, kernel calls "
              f"{got} | {card}", flush=True)
        check(all(got.get(k, 0) > 0 for k in kernels),
              f"{name} launched no {kernels} kernel: {got}")
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
    print(f"{tag} second measure_all: the {len(files)} reports reloaded, "
          f"nothing computed (0 kernel calls, files unchanged)", flush=True)
    return texts


def print_resource_reports(texts: dict, card: str, tag: str,
                           batch: int) -> None:
    """The performance report's ms/sample, GFLOPs and MiB per stage and
    the train resources' seconds and MiB per step, each checked above 0."""
    perf = json.loads(texts["performance.json"])
    for stage in ("classifier", "surrogate", "explainer", "final"):
        r = perf[stage]
        check(r["time_avg"] > 0 and r["gflops"] > 0 and r["mem_mib"] > 0,
              f"performance {stage}: {r}")
        print(f"{tag} performance {stage}: {r['time_avg'] * 1e3:.3f} "
              f"ms/sample (std {r['time_std'] * 1e3:.3f}, batch 1, "
              f"{len(r['time'])} samples), {r['gflops']:.3f} GFLOPs, "
              f"{r['params_all']:.3f} M params ({r['params_trainable']:.3f} "
              f"M trainable), {r['mem_mib']:.1f} MiB ({r['mem_estimator']}) "
              f"| {card}", flush=True)
    trn = json.loads(texts["train_resources.json"])
    print(f"{tag} train_resources: init {trn['init_tm']:.3f} s, "
          f"{trn['init_mem']:.1f} MiB; surrogate step "
          f"{trn['srg_tm']['avg'] * 1e3:.3f} ms/sample, "
          f"{trn['srg_mem']['avg']:.1f} MiB; explainer step "
          f"{trn['exp_tm']['avg'] * 1e3:.3f} ms/sample, "
          f"{trn['exp_mem']['avg']:.1f} MiB ({trn['mem_estimator']}, batch "
          f"{batch}) | {card}", flush=True)
    check(trn["srg_tm"]["avg"] > 0 and trn["exp_tm"]["avg"] > 0
          and trn["srg_mem"]["avg"] > 0 and trn["exp_mem"]["avg"] > 0,
          f"train_resources: {trn}")


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
    print(f"[run_all] train_all + measure_all in {seconds:.1f} s | {card}",
          flush=True)
    texts = check_report_files(exp, calls, report_seconds,
                               FP32_REPORT_KERNELS, card, "[run_all]")
    total = _scaled((1, total), (1, run_report_gate(
        dev, exp, FAITH_KERNELS, texts, card, "[run_all]")))
    print_resource_reports(texts, card, "[run_all]", TRAIN_B)
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------------- LTT BERT run_all

BERT_TRAIN_B, BERT_EXP_B, BERT_M = 8, 4, 2  # the shipped training blocks
# the cut that keeps the script nearer half its time limit: phase 8 at 4
# of the 12 layers (BERT-base@512 widths; phase 3 serves the full depth)
BERT_RUN_ALL_LAYERS = 4
# phase 8's eval blocks: experiments/bert_base_tayp_ltt's, cut where
# marked to keep the phase inside the time limit (widths are the shipped
# ones, the depth BERT_RUN_ALL_LAYERS; the data is the 24 bundled
# sentences)
BERT_RUN_ALL_EVAL = {
    "eval_accuracy": {"dataset": None, "batch_size": 8, "resolution": 8},
    # raised from the shipped 4 stops to 16: 2 classes x 16 stops x 2
    # directions = 64 coalitions a sentence, each a masked BERT-base@512
    "eval_faithfulness": {"dataset": None, "batch_size": 8,
                          "resolution": 16},
    "eval_cls_acc": {"dataset": None, "on_exp_epochs": None,
                     "batch_size": 8},
    "eval_performance": {"dataset": None, "loops": 2},
    # cut from the shipped 32 samples to 8 (4 steps of 2)
    "eval_train_resources": {"dataset": None, "batch_size": 2,
                             "max_samples": 8},
    # the shipped file has no CKA block; the JAX schema's batch of 8
    "eval_branches_cka": {"dataset": None, "batch_size": 8},
}
# the kernels of faithfulness on each path at BERT-base@512: fp32 K6, K7,
# K5; W8A8 with fp32 parameters the float trunk attention K6 (the JAX
# budget), the 2-tile K8q, K5, and the final's side layer K1 + K4 and head
# K3; pallas mode "1" K9
BERT_FAITH_KERNELS = {
    "fp32": FP32_REPORT_KERNELS,
    "int8": ("attention_block", "mlp_block_int8_tiled", "ladder_block",
             "attention_block_int8", "mlp_block_int8", "head_block"),
    "mode 1": ("masked_attention",),
}


def nlp_samples() -> list:
    """The sentences of the port's copy of the bundled sample set."""
    return [x["inputs"] for x in json.loads(
        (REPO / "autognothi_tpu_torch" / "data" / "nlp_samples.json")
        .read_text())]


def write_bert_run_all_experiment(tmp: pathlib.Path) -> pathlib.Path:
    """A `random_init` LTT BERT-base@512 experiment (experiments/
    bert_base_tayp_ltt's `net.params`, full width, BERT_RUN_ALL_LAYERS
    deep, dropout 0) on
    `nlp_samples`, with a `build_vocab` vocabulary over the port's copy of
    the sample set under `<exp>/tokenizer/` (`vocab_size` stays the
    shipped 30,522, as in phase 3), the shipped training blocks at one
    epoch each (the surrogate's progressive) and BERT_RUN_ALL_EVAL."""
    from autognothi_tpu_torch import RECIPE_VERSION
    from autognothi_tpu_torch.data.tokenizer import (WordPieceTokenizer,
                                                     build_vocab)

    hp = json.loads(BERT_EXP.read_text())
    hp["net"].update(version=RECIPE_VERSION, base_model="random_init",
                     params=dict(hp["net"]["params"],
                                 attention_probs_dropout_prob=0.0,
                                 hidden_dropout_prob=0.0,
                                 num_hidden_layers=BERT_RUN_ALL_LAYERS))
    hp["dataset"] = {"kind": "nlp_samples"}
    hp["seed"] = SEED
    for section in ("train_classifier", "train_surrogate",
                    "train_explainer"):
        hp[section].update(epochs=1, ckpt_when="_:%1==0")
    hp["train_surrogate"]["EXPERIMENTAL_progressive_training"] = True
    check((hp["train_classifier"]["batch_size"],
           hp["train_surrogate"]["batch_size"],
           hp["train_explainer"]["batch_size"],
           hp["train_explainer"]["n_mask_samples"])
          == (BERT_TRAIN_B, BERT_TRAIN_B, BERT_EXP_B, BERT_M),
          "the shipped BERT training blocks changed")
    hp.update(copy.deepcopy(BERT_RUN_ALL_EVAL))
    exp = tmp / "ltt_bert_run_all"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    WordPieceTokenizer(build_vocab(nlp_samples())).save(exp / "tokenizer")
    return exp


# the kernel calls of one step at 12 layers, by (stage, teacher), the
# steps held against their plain versions: a classifier or surrogate
# forward is TRUNK_FWD; the explainer's adds its side layer (K6 + K7); an
# int8 teacher forward runs the float trunk attention (K6, the JAX budget)
# and the 2-tile K8q (F4).  The classifier has no teacher; the
# surrogate's follows AUTOGNOTHI_INT8, the explainer's (the coalitions and
# v_1) AUTOGNOTHI_INT8_TEACHER
INT8_TEACHER_FWD = {"attention_block": 12, "mlp_block_int8_tiled": 24,
                    "ladder_block": 12}
EXPLAINER_FWD = _scaled((1, TRUNK_FWD),
                        (1, {"attention_block": 1, "mlp_block": 1}))
BERT_STEP_COUNTS = {
    ("classifier", "fp32"): TRUNK_FWD,
    ("surrogate", "fp32"): _scaled((2, TRUNK_FWD)),
    ("surrogate", "int8"): _scaled((1, TRUNK_FWD), (1, INT8_TEACHER_FWD)),
    ("explainer", "fp32"): _scaled((2, TRUNK_FWD), (1, EXPLAINER_FWD)),
    ("explainer", "int8"): _scaled((2, INT8_TEACHER_FWD),
                                   (1, EXPLAINER_FWD)),
}


def phase_bert_stage_steps(case: StageCase, card: str) -> dict:
    """One step of each stage and teacher with the kernels against the same
    step on the plain versions (loss within STEP_TOL); -> the kernel calls
    of one step, by (stage, teacher)."""
    import torch

    per_step = {}
    for (stage, teacher), want in BERT_STEP_COUNTS.items():
        want = _depth(want, case.cfg.num_hidden_layers)
        losses, calls = {}, {}
        for which in ("kernels", "plain"):
            run = case.fresh(stage)
            with train_env("2", teacher), \
                    int8_mode(stage == "surrogate" and teacher == "int8"), \
                    (plain_ops() if which == "plain"
                     else contextlib.nullcontext()):
                reset_counts()
                losses[which] = run().item()
                torch.cuda.synchronize()
                calls[which] = {k: v for k, v in read_counts().items() if v}
        rel = abs(losses["kernels"] - losses["plain"]) \
            / abs(losses["plain"])
        print(f"[bert stage-step] {stage} teacher={teacher}: loss kernels "
              f"{losses['kernels']:.8f}, plain {losses['plain']:.8f}, rel "
              f"diff {rel:.3e} (limit {STEP_TOL[teacher]:.0e}); kernel calls "
              f"{calls['kernels']} (expected {want}) | {card}", flush=True)
        check(not calls["plain"], "the plain step launched kernels")
        check(calls["kernels"] == want,
              f"{stage} teacher={teacher}: one step's kernel calls differ")
        check(rel <= STEP_TOL[teacher] and
              all(math.isfinite(v) for v in losses.values()),
              f"{stage} teacher={teacher}: the kernel step's loss differs "
              f"from the plain step's")
        per_step[(stage, teacher)] = calls["kernels"]
    return per_step


def phase_bert_dropout_step(case: StageCase, dev, card: str) -> None:
    """One surrogate step at the shipped dropout 0.1: a finite loss, no
    kernel call in the differentiated forward (dropout keeps it on the
    unfused math), kernel calls in its teacher (the step's calls less
    those of one teacher call alone)."""
    import dataclasses

    import torch

    from autognothi_tpu_torch.pipeline.train_surrogate import \
        surrogate_teacher

    cfg = dataclasses.replace(case.cfg, attention_probs_dropout_prob=0.1,
                              hidden_dropout_prob=0.1)
    run = case.fresh("surrogate", cfg=cfg,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
    with train_env("2", "fp32"):
        reset_counts()
        surrogate_teacher(case.recipe, cfg)(case.models["classifier"],
                                            case.xs, case.ones)
        torch.cuda.synchronize()
        teacher = {k: v for k, v in read_counts().items() if v}
        reset_counts()
        t0 = time.perf_counter()
        loss = run().item()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        step = {k: v for k, v in read_counts().items() if v}
    student = {k: v - teacher.get(k, 0) for k, v in step.items()
               if v - teacher.get(k, 0)}
    print(f"[bert stage-step] surrogate at dropout 0.1: loss {loss:.8f}, "
          f"{ms:.1f} ms; teacher kernel calls {teacher}, differentiated "
          f"forward {student} | {card}", flush=True)
    check(math.isfinite(loss), "the dropout step's loss is not finite")
    check(teacher and not student,
          "dropout 0.1: the teacher launched no kernel or the "
          "differentiated forward launched one")


def phase_bert_run_all(dev, tmp: pathlib.Path, card: str) -> dict:
    """`python -m autognothi_tpu_torch run_all <exp> --device cuda` through
    `cli_main` on a random_init LTT BERT-base@512 experiment on
    `nlp_samples`: the seven stages' kernel calls against their steps' and
    forwards', the coherency line, the served final (`texts`), the six
    reports and their kernel calls, a second `measure_all` that launches
    nothing, the quality gate (faithfulness with the kernels against the
    plain versions on the card: fp32, W8A8, pallas mode "1"), cls_acc and
    accuracy against the plain run, the three stages' steps against their
    plain versions and their times, a step at dropout 0.1, and the
    performance and train-resources numbers; -> the kernel calls of the
    counted paths (run_all, the served request, the W8A8 and mode "1"
    faithfulness runs)."""
    import re

    import torch

    from autognothi_tpu_torch.cli import main as cli_main

    tag = "[bert run_all]"
    exp = write_bert_run_all_experiment(tmp)
    stage_calls: dict = {}
    calls: dict = {}
    report_seconds: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # each stage starts from counts of 0; each report is read as the counts'
    # difference across it: their sum is the whole run's
    with report_env("2", False), counted_stages(stage_calls), \
            counted_reports(calls, report_seconds):
        cli_main(["run_all", str(exp), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = _scaled(*((1, c) for c in stage_calls.values()),
                    *((1, c) for c in calls.values()))
    log = (exp / ".log.txt").read_text()
    diffs = re.search(r"cls_diff: (\S+), exp_diff: (\S+)", log)
    check("current stage: 0 / 7" in log and diffs is not None
          and "verified final model is coherent" in log,
          "train_all did not verify the final's coherency")
    check("freeze side branches exc. first 1 layers" in log,
          "the surrogate stage did not train progressively")
    print(f"{tag} LTT BERT-base@512 at {BERT_RUN_ALL_LAYERS} layers on "
          f"nlp_samples "
          f"({len(nlp_samples())} sentences): "
          f"train_all + measure_all in {seconds:.1f} s (the six reports "
          f"{sum(report_seconds.values()):.1f} s); coherency on the card: "
          f"cls_diff {diffs.group(1)}, exp_diff {diffs.group(2)} (limit "
          f"1e-05) | {card}", flush=True)

    case = StageCase(dev, exp, BERT_TRAIN_B, (BERT_EXP_B, BERT_M))
    per_step = phase_bert_stage_steps(case, card)
    evals = {s: case.eval_calls(s) for s in ("classifier", "surrogate")}
    n = len(nlp_samples())
    batches = {s: -(-n // b) for s, b in (("classifier", BERT_TRAIN_B),
                                         ("explainer", BERT_EXP_B))}
    expected = {
        "conv_pretrained_classifier": {},
        "train_classifier": _scaled(
            (batches["classifier"], per_step[("classifier", "fp32")]),
            (batches["classifier"], evals["classifier"])),
        "conv_classifier_surrogate": {},
        "train_surrogate": _scaled(
            (batches["classifier"], per_step[("surrogate", "fp32")]),
            (batches["classifier"], evals["surrogate"])),
        "conv_surrogate_explainer": {},
        # train and eval steps alike: the teacher and the explainer forward
        "train_explainer": _scaled(
            (2 * batches["explainer"], per_step[("explainer", "int8")]),
            (1, _depth(NULL_COUNTS["2"], BERT_RUN_ALL_LAYERS))),
        "conv_explainer_final": _depth(FINAL_COUNTS, BERT_RUN_ALL_LAYERS),
    }
    for stage in STAGES:
        print(f"{tag} {stage}: kernel calls {stage_calls.get(stage)} "
              f"(expected {expected[stage]})", flush=True)
        check(stage_calls.get(stage) == expected[stage],
              f"{stage}: kernel calls differ from its steps' and forwards'")
    with report_env("2", False):
        total = _scaled((1, total), (1, serve_final(
            dev, exp, texts=[x for x in CORPUS[:3]], tag=tag,
            layers=BERT_RUN_ALL_LAYERS)))

    texts = check_report_files(exp, calls, report_seconds,
                               FP32_REPORT_KERNELS, card, tag)
    total = _scaled((1, total), (1, run_report_gate(
        dev, exp, BERT_FAITH_KERNELS, texts, card, tag)))
    print_resource_reports(
        texts, card, tag,
        BERT_RUN_ALL_EVAL["eval_train_resources"]["batch_size"])

    phase_bert_dropout_step(case, dev, card)
    phase_stage_timing(case, card, (
        ("classifier", "classifier", "fp32"),
        ("surrogate", "surrogate", "fp32"),
        ("explainer teacher=fp32", "explainer", "fp32"),
        ("explainer teacher=int8", "explainer", "int8")),
        tag="[bert stage-time]")
    del case
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


# --------------------------------------------- vanilla and froyo towers

# the shipped experiments whose `net.params` phases 9 and 10 run (full
# width and depth, random_init, dropout 0)
TOWER_EXP = {"vit": REPO / "experiments" / "vit_base_imagenette_vanilla"
             / ".hparams.json",
             "bert": REPO / "experiments" / "bert_base_tayp_vanilla"
             / ".hparams.json"}
TOWER_EXP["vit_large"] = (REPO / "experiments"
                          / "vit_large_imagenette_vanilla" / ".hparams.json")
TOWER_NAME = {"vit": "ViT-B/16@224", "bert": "BERT-base@512",
              "vit_large": "ViT-L/16@224"}
# the duo BERT's shipped experiment (the same `net.params`); the repo ships
# no duo ViT experiment, so phase 11 takes the vanilla ViT's
DUO_EXP = {"vit": TOWER_EXP["vit"],
           "bert": REPO / "experiments" / "bert_base_tayp_duo_vanilla"
           / ".hparams.json"}
# the eval blocks: phase 7's (ViT) and phase 8's (BERT), cut to 8
# faithfulness stops (ViT 160 coalitions an image, BERT 32 a sentence,
# each held against plain three times over) and one performance loop to
# keep the script inside half its time limit
TOWER_EVAL = {
    family: dict(copy.deepcopy(blocks),
                 eval_faithfulness=dict(blocks["eval_faithfulness"],
                                        resolution=8),
                 eval_performance=dict(blocks["eval_performance"], loops=1))
    for family, blocks in (("vit", RUN_ALL_EVAL),
                           ("bert", BERT_RUN_ALL_EVAL),
                           ("vit_large", RUN_ALL_EVAL))}
# kernel calls per slab (or per fw_final) of a vanilla final: three
# 12-layer towers and the explainer's layer, 37 attention and 37 MLP
# blocks, and the head.  ViT: fp32 K6 + K7; W8A8 K1 + K4 (trunk design)
# and K3 on its wide route; mode "1" K9.  BERT-base@512 (the JAX gates,
# F4): fp32 K6 + K7 (the fp32 split only reorders a sum); W8A8 with fp32
# parameters a float attention (K6) and the 2-tile K8q, with bf16
# parameters K1 and K8q; bf16 without int8 K6 and the 2-tile K8 chain
VANILLA_COUNTS = {
    ("vit", "fp32"): {"attention_block": 37, "mlp_block": 37},
    ("vit", "int8"): {"attention_block_int8": 37, "mlp_block_int8": 37,
                      "head_block": 1},
    ("vit", "mode 1"): {"masked_attention": 37},
    ("bert", "fp32"): {"attention_block": 37, "mlp_block": 37},
    ("bert", "int8"): {"attention_block": 37, "mlp_block_int8_tiled": 74,
                       "head_block": 1},
    ("bert", "int8 bf16"): {"attention_block_int8": 37,
                            "mlp_block_int8_tiled": 74, "head_block": 1},
    ("bert", "bf16"): {"attention_block": 37, "mlp_block_tiled": 74},
    ("bert", "mode 1"): {"masked_attention": 37},
    # ViT-L/16@224 (phase 13): 3 x 24 + 1 = 73 blocks of each kind, the
    # routes of VIT_L_ROUTES
    ("vit_large", "fp32"): {"attention_block": 73, "mlp_block": 73},
    ("vit_large", "int8"): {"attention_block_int8": 73,
                            "mlp_block_int8_tiled": 146},
    ("vit_large", "int8 bf16"): {"attention_block_int8": 73,
                                 "mlp_block_int8": 73},
    ("vit_large", "bf16"): {"attention_block": 73, "mlp_block_tiled": 146},
    ("vit_large", "mode 1"): {"masked_attention": 73},
}
# a duo final runs the surrogate's tower and the duo explainer's (its
# trunk and its layer): 25 attention and 25 MLP blocks a slab, and the head
DUO_COUNTS = {
    ("vit", "fp32"): {"attention_block": 25, "mlp_block": 25},
    ("vit", "int8"): {"attention_block_int8": 25, "mlp_block_int8": 25,
                      "head_block": 1},
    ("vit", "mode 1"): {"masked_attention": 25},
    ("bert", "fp32"): {"attention_block": 25, "mlp_block": 25},
    ("bert", "int8"): {"attention_block": 25, "mlp_block_int8_tiled": 50,
                       "head_block": 1},
    ("bert", "int8 bf16"): {"attention_block_int8": 25,
                            "mlp_block_int8_tiled": 50, "head_block": 1},
    ("bert", "bf16"): {"attention_block": 25, "mlp_block_tiled": 50},
    ("bert", "mode 1"): {"masked_attention": 25},
}
TOWER_COUNTS = {"vanilla": VANILLA_COUNTS, "duo": DUO_COUNTS}
# a froyo final runs one trunk and the explainer's layer: 13 of each block
FROYO_COUNTS = {
    ("vit", "fp32"): {"attention_block": 13, "mlp_block": 13},
    ("vit", "int8"): {"attention_block_int8": 13, "mlp_block_int8": 13,
                      "head_block": 1},
    ("bert", "fp32"): {"attention_block": 13, "mlp_block": 13},
    ("bert", "int8"): {"attention_block": 13, "mlp_block_int8_tiled": 26,
                       "head_block": 1},
}
# one forward of a 12-layer tower, by family and arithmetic: fp32, and the
# int8 teacher's (ViT K1 + K4; BERT-base@512 with fp32 parameters K6 and
# the 2-tile K8q)
TOWER_FWD = {("vit", "fp32"): {"attention_block": 12, "mlp_block": 12},
             ("vit", "int8"): {"attention_block_int8": 12,
                               "mlp_block_int8": 12},
             ("bert", "fp32"): {"attention_block": 12, "mlp_block": 12},
             ("bert", "int8"): {"attention_block": 12,
                                "mlp_block_int8_tiled": 24}}
EXPLAINER_LAYER = {"attention_block": 1, "mlp_block": 1}
# the kernels faithfulness launches on each path (its surrogate's
# coalitions and the final)
TOWER_FAITH_KERNELS = {
    "vit": {"fp32": ("attention_block", "mlp_block"),
            "int8": ("attention_block_int8", "mlp_block_int8",
                     "head_block"),
            "mode 1": ("masked_attention",)},
    "bert": {"fp32": ("attention_block", "mlp_block"),
             "int8": ("attention_block", "mlp_block_int8_tiled",
                      "head_block"),
             "mode 1": ("masked_attention",)},
}


def tower_step_counts(family: str, stage: str, teacher: str,
                      layers: int = 12) -> dict:
    """The kernel calls of one vanilla (or duo) step: the classifier one
    forward (it trains nothing); the surrogate its teacher (the
    classifier, in the arithmetic AUTOGNOTHI_INT8 picks) and its own
    forward; the explainer its teacher's coalitions and v_1 and its own
    forward (the tower and its layer)."""
    fwd = _depth(TOWER_FWD[(family, "fp32")], layers)
    teach = _depth(TOWER_FWD[(family, teacher)], layers)
    if stage == "classifier":
        return fwd
    if stage == "surrogate":
        return _scaled((1, fwd), (1, teach))
    return _scaled((2, teach), (1, fwd), (1, EXPLAINER_LAYER))


def write_tower_experiment(tmp: pathlib.Path, family: str, kind: str,
                           name: str, layers: int = None) -> pathlib.Path:
    """A `random_init` experiment of net kind `kind` with the shipped
    `net.params` of TOWER_EXP[family] (DUO_EXP for a duo kind; dropout 0;
    `layers` deep where given).  ViT: phase 6's data and training blocks
    (`cv_samples` at 224 px, 2 train and 1 test batch of TRAIN_B,
    explainer M = TRAIN_M) and phase 7's eval blocks; BERT: `nlp_samples`
    with a `build_vocab` vocabulary, the shipped training blocks at one
    epoch each and phase 8's eval blocks; a duo kind adds the dual-task
    block at the eval batch."""
    from autognothi_tpu_torch import RECIPE_VERSION
    from autognothi_tpu_torch.data.tokenizer import (WordPieceTokenizer,
                                                     build_vocab)

    duo = kind.startswith("duo")
    hp = json.loads((DUO_EXP if duo else TOWER_EXP)[family].read_text())
    params = dict(hp["net"]["params"], attention_probs_dropout_prob=0.0,
                  hidden_dropout_prob=0.0)
    if layers is not None:
        params["num_hidden_layers"] = layers
    hp["net"].update(kind=kind, version=RECIPE_VERSION,
                     base_model="random_init", params=params)
    hp["seed"] = SEED
    if family.startswith("vit"):
        hp["dataset"] = {"kind": "cv_samples", "train_size": 2 * TRAIN_B,
                         "test_size": TRAIN_B, "img_px_size": 224,
                         "num_classes": 10, "seed": SEED}
        every = {"ckpt_when": "_:%1==0", "lr": 5e-5, "batch_size": TRAIN_B}
        hp["train_classifier"] = {"epochs": 1, **every}
        hp["train_surrogate"] = {"epochs": 1, **every}
        hp["train_explainer"] = {"epochs": 1, **every,
                                 "n_mask_samples": TRAIN_M,
                                 "lambda_efficiency": 0.0,
                                 "lambda_norm": 0.0}
    else:
        hp["dataset"] = {"kind": "nlp_samples"}
        for section in ("train_classifier", "train_surrogate",
                        "train_explainer"):
            hp[section].update(epochs=1, ckpt_when="_:%1==0")
        check((hp["train_classifier"]["batch_size"],
               hp["train_surrogate"]["batch_size"],
               hp["train_explainer"]["batch_size"],
               hp["train_explainer"]["n_mask_samples"])
              == (BERT_TRAIN_B, BERT_TRAIN_B, BERT_EXP_B, BERT_M),
              "the shipped vanilla BERT training blocks changed")
    hp.update(copy.deepcopy(TOWER_EVAL[family]))
    if duo:
        hp["eval_dual_task_similarity"] = {
            "dataset": None,
            "batch_size": hp["eval_faithfulness"]["batch_size"]}
    exp = tmp / name
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    if family == "bert":
        WordPieceTokenizer(build_vocab(nlp_samples() + CORPUS)).save(
            exp / "tokenizer")
    return exp


def write_tower_final(tmp: pathlib.Path, family: str,
                      kind: str = "vanilla") -> pathlib.Path:
    """A random vanilla (or duo) final (seeded torch.Generator,
    surrogate_null 0.1) beside a phase 9/10 (11) experiment."""
    import numpy as np
    import torch

    from autognothi_tpu_torch.params import save_params
    from autognothi_tpu_torch.pipeline.config import parse_config
    from autognothi_tpu_torch.pipeline.resources import get_recipe

    arch = "vit" if family.startswith("vit") else family
    net_kind = f"{kind}_{arch}" if kind == "vanilla" \
        else f"duo_vanilla_{arch}"
    exp = write_tower_experiment(tmp, family, net_kind,
                                 f"{kind}_{family}_serve")
    recipe, cfg = get_recipe(parse_config(json.loads(
        (exp / ".hparams.json").read_text())))
    t0 = time.perf_counter()
    flat = recipe.init_final(cfg, torch.Generator().manual_seed(SEED))
    flat["surrogate_null"] = np.full_like(flat["surrogate_null"], 0.1)
    save_params(exp / "final-epoch-0.ckpt", flat)
    print(f"[{kind} {family}] {kind} {TOWER_NAME[family]} final: "
          f"{sum(v.size for v in flat.values())} parameters, seed {SEED}, "
          f"written in {time.perf_counter() - t0:.1f} s", flush=True)
    return exp


def phase_tower_paths(dev, family: str, service, card: str,
                      kind: str = "vanilla") -> dict:
    """fw_final of the served vanilla (or duo) model at batch 8 on each
    path the serve phase does not take (ViT mode "1"; BERT-base and ViT-L
    int8 with bf16 parameters, bf16 without int8, mode "1"), each against
    its plain
    forward with its kernel calls (TOWER_COUNTS[kind]), timed in turns;
    one profiled forward per path (the served paths' too); -> the kernel
    calls."""
    import torch

    model, cfg, recipe = service.model, service.m_config, service.recipe
    gen = torch.Generator().manual_seed(SEED)
    if family.startswith("vit"):
        xs = torch.rand((8, 3, 224, 224), generator=gen).to(dev)
    else:
        xs = torch.randint(1, cfg.vocab_size, (8, T_BERT),
                           generator=gen).to(dev)
    # the bf16 paths (BERT-base and ViT-L): bf16 parameters, and pixels
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16) \
        if family != "vit" else None
    xs16 = xs.to(torch.bfloat16) if xs.is_floating_point() else xs

    def forward(m, x, pallas: str, int8: bool, plain: bool):
        def run():
            with mock.patch.dict(os.environ, {"AUTOGNOTHI_PALLAS": pallas}), \
                    int8_mode(int8), torch.inference_mode(), \
                    (plain_ops() if plain else contextlib.nullcontext()):
                return recipe.fw_final(cfg, m, x)
        return run

    paths = [("fp32", model, xs, "2", False, torch.float32),
             ("int8", model, xs, "2", True, torch.float32),
             ("mode 1", model, xs, "1", False, torch.float32)]
    if model_bf16 is not None:
        paths[2:2] = [("int8 bf16", model_bf16, xs16, "2", True,
                       torch.bfloat16),
                      ("bf16", model_bf16, xs16, "2", False,
                       torch.bfloat16)]
    calls_all: dict = {}
    for label, m, x, pallas, int8, dtype in paths:
        fw = forward(m, x, pallas, int8, False)
        reset_counts()
        fw()
        torch.cuda.synchronize()
        calls = {k: v for k, v in read_counts().items() if v}
        want = TOWER_COUNTS[kind][(family, label)]
        print(f"[{kind} {family}] fw_final {label} B=8: kernel calls "
              f"{calls} (expected {want})", flush=True)
        check(calls == want, f"{kind} {family} fw_final {label}: kernel "
                             f"calls differ from the table")
        calls_all = _scaled((1, calls_all), (1, calls))
        time_fw_final(f"{kind} {TOWER_NAME[family]} {label}", fw,
                      forward(m, x, pallas, int8, True), dtype, int8, card,
                      8)
        profile_forward(f"{kind} {TOWER_NAME[family]} {label} B=8", fw,
                        card)
    del model_bf16
    torch.cuda.empty_cache()
    return calls_all


def phase_tower_serve(dev, tmp: pathlib.Path, card: str, family: str,
                      kind: str = "vanilla",
                      exp: pathlib.Path = None) -> dict:
    """Serve a random vanilla (or duo) final on the card (`exp`'s, else a
    new one), fp32 and W8A8 (phase 3's requests), against its plain
    forward with the kernel calls per slab, then the other paths of
    `phase_tower_paths`; -> the kernel calls.  The duo BERT's head gives
    raw logits."""
    exp = exp or write_tower_final(tmp, family, kind)
    probs = not (kind == "duo" and family == "bert")
    launches, service, _ = phase_serve(
        dev, exp, int8=False, model=family,
        per_slab=TOWER_COUNTS[kind][(family, "fp32")],
        tag=f"serve {kind} {family} fp32", probabilities=probs)
    launches_int8, _, _ = phase_serve(
        dev, exp, int8=True, model=family,
        per_slab=TOWER_COUNTS[kind][(family, "int8")],
        tag=f"serve {kind} {family} int8", probabilities=probs)
    total = _scaled((1, launches), (1, launches_int8),
                    (1, phase_tower_paths(dev, family, service, card,
                                          kind)))
    del service
    return total


def recomputes() -> int:
    from autognothi_tpu_torch.kernels.primitives import RECOMPUTES

    return RECOMPUTES.count


ALL_STAGE_STEPS = (("classifier", "fp32"), ("surrogate", "fp32"),
                   ("surrogate", "int8"), ("explainer", "fp32"),
                   ("explainer", "int8"))


def phase_tower_steps(case: StageCase, family: str, card: str,
                      tag: str, stages: tuple = ALL_STAGE_STEPS,
                      layers: int = 12) -> dict:
    """One step of each (stage, teacher) of `stages` (by default the
    classifier, then the surrogate and explainer with the fp32 and the
    int8 teacher) with the kernels against the same step on the plain
    versions (loss within STEP_TOL), its kernel calls against
    `tower_step_counts` and the plain recomputes of its backward (one per
    differentiated kernel call); -> the kernel calls by (stage,
    teacher)."""
    import torch

    from autognothi_tpu_torch.kernels.primitives import RECOMPUTES

    froyo = case.recipe.id.startswith("froyo")
    per_step = {}
    for stage, teacher in stages:
        losses, calls = {}, {}
        for which in ("kernels", "plain"):
            run = case.fresh(stage)
            with train_env("2", teacher), \
                    int8_mode(stage == "surrogate" and teacher == "int8"), \
                    (plain_ops() if which == "plain"
                     else contextlib.nullcontext()):
                reset_counts()
                RECOMPUTES.reset()
                losses[which] = run().item()
                torch.cuda.synchronize()
                calls[which] = {k: v for k, v in read_counts().items() if v}
                if which == "kernels":
                    redone = RECOMPUTES.count
        want = tower_step_counts(family, stage, teacher, layers)
        # the backward recomputes each differentiated kernel call: the
        # whole student's, or under froyo's frozen trunk the explainer's
        # layer only (the surrogate's head is a plain dense)
        if stage == "classifier":
            want_redone = 0
        elif froyo:
            want_redone = 2 if stage == "explainer" else 0
        else:
            want_redone = 2 * (layers + (stage == "explainer"))
        rel = abs(losses["kernels"] - losses["plain"]) \
            / max(abs(losses["plain"]), 1e-30)
        print(f"{tag} {stage} teacher={teacher}: loss kernels "
              f"{losses['kernels']:.8f}, plain {losses['plain']:.8f}, rel "
              f"diff {rel:.3e} (limit {STEP_TOL[teacher]:.0e}); kernel calls "
              f"{calls['kernels']} (expected {want}); plain recomputes in "
              f"the backward {redone} (expected {want_redone}) | {card}",
              flush=True)
        check(not calls["plain"], "the plain step launched kernels")
        check(calls["kernels"] == want,
              f"{stage} teacher={teacher}: one step's kernel calls differ")
        check(redone == want_redone,
              f"{stage} teacher={teacher}: {redone} plain recomputes in "
              f"the backward, expected {want_redone}")
        check(rel <= STEP_TOL[teacher] and
              all(math.isfinite(v) for v in losses.values()),
              f"{stage} teacher={teacher}: the kernel step's loss differs "
              f"from the plain step's")
        per_step[(stage, teacher)] = calls["kernels"]
    return per_step


def coherency(exp: pathlib.Path, tag: str, card: str) -> None:
    """The train_all log's coherency line, on the card: cls_diff and
    exp_diff 0.0 (the final runs the same kernels on the same parameters
    as the stages' models)."""
    import re

    log = (exp / ".log.txt").read_text()
    diffs = re.search(r"cls_diff: (\S+), exp_diff: (\S+)", log)
    check("current stage: 0 / 7" in log and diffs is not None
          and "verified final model is coherent" in log,
          "train_all did not verify the final's coherency")
    print(f"{tag} coherency on the card: cls_diff {diffs.group(1)}, "
          f"exp_diff {diffs.group(2)} (limit 1e-05) | {card}", flush=True)
    check(float(diffs.group(1)) == 0.0 and float(diffs.group(2)) == 0.0,
          "the final's coherency differences are not 0.0")


def tower_batches(family: str) -> tuple:
    """(classifier / surrogate batch, explainer batch, M) of the phase's
    experiment."""
    return (TRAIN_B, TRAIN_B, TRAIN_M) if family == "vit" \
        else (BERT_TRAIN_B, BERT_EXP_B, BERT_M)


# the cut that keeps the script nearer half its time limit: the vanilla
# and duo towers' run_all (and froyo's train_all) at 4 of the 12 layers;
# their served finals and timed forwards stay at full depth
TOWER_RUN_ALL_LAYERS = 4


def phase_tower_run_all(dev, tmp: pathlib.Path, card: str, family: str,
                        kind: str = "vanilla",
                        layers: int = TOWER_RUN_ALL_LAYERS) -> dict:
    """`python -m autognothi_tpu_torch run_all <exp> --device cuda` through
    `cli_main` on a random_init vanilla (or duo) experiment at `layers` of
    the 12 layers: each stage's kernel calls, the coherency line (0.0 /
    0.0; the duo recipes check none, as the JAX package's), the six
    reports (seven for duo) with their seconds and kernel calls, a second
    `measure_all` that launches nothing, the quality gate, cls_acc and
    accuracy against plain (and duo's dual-task similarity), the steps
    against their plain versions with their ms/step and spans (duo: the
    duo explainer step only, the other stages are the vanilla ones), the
    performance and train-resources numbers; -> the kernel calls of the
    counted paths (run_all, the W8A8 and mode "1" faithfulness runs)."""
    import torch

    from autognothi_tpu_torch.cli import main as cli_main

    duo = kind == "duo"
    tag = f"[{kind} {family} run_all]"
    net_kind = f"duo_vanilla_{family}" if duo else f"vanilla_{family}"
    exp = write_tower_experiment(tmp, family, net_kind,
                                 f"{kind}_{family}_run_all", layers)
    stage_calls: dict = {}
    calls: dict = {}
    report_seconds: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with report_env("2", False), counted_stages(stage_calls), \
            counted_reports(calls, report_seconds):
        cli_main(["run_all", str(exp), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    total = _scaled(*((1, c) for c in stage_calls.values()),
                    *((1, c) for c in calls.values()))
    print(f"{tag} {kind} {TOWER_NAME[family]} at {layers} layers: train_all "
          f"+ measure_all in {seconds:.1f} s (the {len(report_seconds)} "
          f"reports {sum(report_seconds.values()):.1f} s) | {card}",
          flush=True)
    if duo:
        log = (exp / ".log.txt").read_text()
        check("train duo explainer" in log and "skipped: net recipe does "
              "not support this" in log, "the duo train_all log")
        print(f"{tag} the duo explainer trainer ran; coherency skipped (the "
              f"final has no classifier tower, as in the JAX recipe)",
              flush=True)
    else:
        coherency(exp, tag, card)
    for stage in STAGES:
        print(f"{tag} {stage}: kernel calls {stage_calls.get(stage)}",
              flush=True)
    check(all(stage_calls.get(s) for s in ("train_classifier",
                                           "train_surrogate",
                                           "train_explainer",
                                           "conv_explainer_final")),
          "a stage that runs forwards launched no kernel")
    texts = check_report_files(exp, calls, report_seconds,
                               TOWER_FAITH_KERNELS[family]["fp32"], card,
                               tag, dual_task=duo)
    total = _scaled((1, total), (1, run_report_gate(
        dev, exp, TOWER_FAITH_KERNELS[family], texts, card, tag)))
    if duo:
        dual_task_gate(exp, texts, card, tag)
    batch, exp_b, m = tower_batches(family)
    print_resource_reports(
        texts, card, tag,
        TOWER_EVAL[family]["eval_train_resources"]["batch_size"])
    case = StageCase(dev, exp, batch, (exp_b, m))
    phase_tower_steps(case, family, card, f"[{kind} {family} stage-step]",
                      stages=(ALL_STAGE_STEPS[3:] if duo
                              else ALL_STAGE_STEPS), layers=layers)
    peak0 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    phase_stage_timing(case, card, (
        (("explainer teacher=int8", "explainer", "int8"),) if duo else (
            ("surrogate", "surrogate", "fp32"),
            ("explainer teacher=int8", "explainer", "int8"))),
        tag=f"[{kind} {family} stage-time]")
    print(f"[{kind} {family} stage-time] peak device memory of the timed "
          f"steps {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
          f"(earlier {peak0 / 2**20:.1f} MiB) | {card}", flush=True)
    del case
    torch.cuda.empty_cache()
    return total


# the dual-task report's cos_sim_avg, kernels against plain on the same
# masks (both draw them from the same seeded CPU generators): the kernel
# ops' backward recomputes the plain versions, so the two runs' gradients
# differ only through the saved activations (fp32, ~1e-6 relative a
# layer); a cosine of two such gradients moves by about as much
DUAL_TASK_TOL = 1e-4


def dual_task_gate(exp: pathlib.Path, texts: dict, card: str,
                   tag: str) -> None:
    """The dual-task report with the kernels (run_all's file) against the
    same report on the plain versions: each epoch's cos_sim_avg and
    cos_sim_std within DUAL_TASK_TOL."""
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.measure_dual_task_similarity import \
        measure_dual_task_similarity
    from autognothi_tpu_torch.pipeline.reports import to_json

    got = json.loads(texts[DUAL_TASK[1]])
    t0 = time.perf_counter()
    with report_env("2", False), plain_ops(), ExpEnv(exp) as env:
        want = to_json(measure_dual_task_similarity(env, device="cuda"))
    worst = max(abs(a - b) for key in ("cos_sim_avg", "cos_sim_std")
                for a, b in zip(got[key], want[key]))
    print(f"{tag} dual-task similarity: epochs {got['epochs']}, cos_sim_avg "
          f"kernels {got['cos_sim_avg']} plain {want['cos_sim_avg']}, std "
          f"{got['cos_sim_std']} / {want['cos_sim_std']}; worst drift "
          f"{worst:.3e} (limit {DUAL_TASK_TOL:g}); plain run "
          f"{time.perf_counter() - t0:.2f} s | {card}", flush=True)
    check(got["epochs"] == want["epochs"] and worst <= DUAL_TASK_TOL
          and all(math.isfinite(v) for v in got["cos_sim_avg"]),
          f"dual-task similarity: kernels {got} against plain {want}")


def phase_froyo(dev, tmp: pathlib.Path, card: str, family: str) -> dict:
    """`train_all` of a random_init froyo experiment (the vanilla phase's
    widths, data and blocks) through `cli_main`: the coherency line, the
    final served fp32 and W8A8 against its plain forward with its kernel
    calls per slab; each stage's step against plain, whose backward
    recomputes no frozen trunk op (`phase_tower_steps`), and the
    explainer step timed against plain; -> the kernel calls of train_all
    and the two serves."""
    import torch

    from autognothi_tpu_torch.cli import main as cli_main

    tag = f"[froyo {family}]"
    layers = TOWER_RUN_ALL_LAYERS
    exp = write_tower_experiment(tmp, family, f"froyo_{family}",
                                 f"froyo_{family}", layers)
    stage_calls: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with report_env("2", False), counted_stages(stage_calls):
        cli_main(["train_all", str(exp), "--device", "cuda"])
    torch.cuda.synchronize()
    print(f"{tag} froyo {TOWER_NAME[family]} train_all in "
          f"{time.perf_counter() - t0:.1f} s; kernel calls by stage "
          f"{stage_calls} | {card}", flush=True)
    coherency(exp, tag, card)
    total = _scaled(*((1, c) for c in stage_calls.values()))
    for int8 in (False, True):
        path = "int8" if int8 else "fp32"
        launches, _, _ = phase_serve(
            dev, exp, int8=int8, model=family,
            per_slab=_depth(FROYO_COUNTS[(family, path)], layers),
            tag=f"serve froyo {family} {path}")
        total = _scaled((1, total), (1, launches))
    batch, exp_b, m = tower_batches(family)
    case = StageCase(dev, exp, batch, (exp_b, m))
    # the frozen trunk leaves the surrogate's head where the classifier's
    # put it: a KL of ~1e-6 is float noise relative to itself.  Biasing
    # the head apart makes the step's loss one to hold against plain
    with torch.no_grad():
        bias = case.models["surrogate"].classifier.bias
        bias.add_(torch.linspace(-1.0, 1.0, bias.numel(), device=dev))
    phase_tower_steps(case, family, card, f"{tag} stage-step",
                      layers=layers)
    phase_stage_timing(case, card, (
        ("froyo explainer teacher=int8", "explainer", "int8"),),
        tag=f"{tag} stage-time")
    del case
    torch.cuda.empty_cache()
    return total


# --------------------------------------------------- duo towers (11)


def phase_duo(dev, tmp: pathlib.Path, card: str, family: str) -> dict:
    """Phase 11 for one family: the served duo final (fp32, W8A8, then the
    other paths at B = 8) and `run_all` of a duo experiment with the
    dual-task gate and the duo explainer steps; -> the kernel calls."""
    return _scaled(
        (1, phase_tower_serve(dev, tmp, card, family, "duo")),
        (1, phase_tower_run_all(dev, tmp, card, family, "duo")))


# ----------------------------------------------- KernelSHAP BERT (12)

KSHAP_EXP = REPO / "experiments" / "bert_base_tayp_kernel_shap" \
    / ".hparams.json"
# the cut of the shipped 2048 coalition samples over 16 background rows
# (~32,800 classifier rows of 512 tokens a sentence): 1024 over 2.  With
# 512 players 1024 rows are every singleton and its complement, which
# `_sample_coalitions` enumerates exactly, so the WLS is determined and the
# kernels-against-plain comparison well posed: 2 + 1 + 2 x 1024 = 2051
# rows a sentence, ~200 TFLOP
KSHAP_SAMPLES, KSHAP_DATA = 1024, 2
# classifier slabs of 64 rows per explained sentence: the background, the
# input, the 2048 composed rows
KSHAP_SLABS = 1 + 1 + 2 * KSHAP_SAMPLES // 64
# kernel calls per slab of the classifier sweep: fp32 K6 + K7 a layer;
# W8A8 with fp32 parameters a float attention (K6, the JAX budget) and the
# 2-tile K8q
KSHAP_COUNTS = {"fp32": {"attention_block": 12, "mlp_block": 12},
                "int8": {"attention_block": 12, "mlp_block_int8_tiled": 24}}
KSHAP_FAITH_KERNELS = {"fp32": ("attention_block", "mlp_block"),
                       "int8": ("attention_block", "mlp_block_int8_tiled")}


def write_kernel_shap_experiment(tmp: pathlib.Path) -> pathlib.Path:
    """A `random_init` KernelSHAP BERT-base@512 experiment (the shipped
    `net.params`, full depth, dropout 0, the sample cut KSHAP_SAMPLES /
    KSHAP_DATA) on `nlp_samples` with a `build_vocab` vocabulary; the
    classifier and surrogate at 0 epochs (the shipped surrogate's 5 stop
    `train_all`: F12), the explainer (k-means) at 1."""
    from autognothi_tpu_torch import RECIPE_VERSION
    from autognothi_tpu_torch.data.tokenizer import (WordPieceTokenizer,
                                                     build_vocab)

    hp = json.loads(KSHAP_EXP.read_text())
    hp["net"].update(version=RECIPE_VERSION, base_model="random_init",
                     params=dict(hp["net"]["params"],
                                 attention_probs_dropout_prob=0.0,
                                 hidden_dropout_prob=0.0,
                                 kernel_shap_n_samples=KSHAP_SAMPLES,
                                 kernel_shap_data_size=KSHAP_DATA))
    hp["dataset"] = {"kind": "nlp_samples"}
    hp["seed"] = SEED
    hp["train_classifier"].update(epochs=0)
    hp["train_surrogate"].update(epochs=0)
    hp["train_explainer"].update(epochs=1, ckpt_when="_:%1==0")
    exp = tmp / "kernel_shap_bert"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    WordPieceTokenizer(build_vocab(nlp_samples() + CORPUS)).save(
        exp / "tokenizer")
    return exp


def serve_host_final(dev, exp: pathlib.Path, int8: bool, card: str,
                     tag: str) -> dict:
    """Serve the KernelSHAP final at batch 2 (the host final) and answer a
    `texts` request of 2 rows: its classifier slabs' kernel calls, its wall
    time, and its probabilities and attributions against the same final
    on the plain versions on the card (the serve gate); -> the request's
    kernel calls."""
    import numpy as np
    import torch

    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import serve_in_thread

    path = "int8" if int8 else "fp32"
    texts = CORPUS[:2]
    env = ExpEnv(exp)
    with int8_mode(int8):
        t0 = time.perf_counter()
        server, service, thread = serve_in_thread(env, port=0, batch_size=2,
                                                  device="cuda")
        up = time.perf_counter() - t0
        port = server.server_address[1]
        try:
            reset_counts()
            t0 = time.perf_counter()
            got = _post(port, {"texts": texts})
            served = time.perf_counter() - t0
            calls = {k: v for k, v in read_counts().items() if v}
        finally:
            server.shutdown()
            server.server_close()
            service.close()
            thread.join(timeout=60)
        check(not thread.is_alive(), "server thread did not stop")
        env.close()
        xs = torch.from_numpy(service.gen_input(texts, [0, 0])[0]).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plain_ops(), torch.inference_mode():
            ref = service.recipe.fw_final(service.m_config, service.model, xs)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    slabs = 1 + len(texts) * KSHAP_SLABS
    want = {k: v * slabs for k, v in KSHAP_COUNTS[path].items()}
    print(f"{tag} served {path} `texts` x{len(texts)} through the host "
          f"final: server up in {up:.1f} s (a warmup slab of 2 explained), "
          f"request {served:.2f} s ({len(texts) / served:.3f} expl/s), "
          f"plain versions {plain_s:.2f} s ({len(texts) / plain_s:.3f} "
          f"expl/s); kernel calls {calls} (expected {want}: {slabs} "
          f"classifier slabs of 64 x 512, {KSHAP_SLABS} an explained row, "
          f"{ {k: v * KSHAP_SLABS for k, v in KSHAP_COUNTS[path].items()} } "
          f"a row) | {card}", flush=True)
    check(calls == want, f"{tag} {path}: kernel calls differ")
    for what, want_t in (("logits", ref[0]), ("attributions", ref[1])):
        mine = torch.from_numpy(np.asarray(got[what], np.float32))
        check(mine.shape == want_t.shape, f"served {what} "
                                          f"{tuple(mine.shape)}")
        _, ok, msg = compare(mine, want_t.cpu(), torch.float32, int8,
                             whole=True)
        rel = (mine - want_t.cpu()).abs().max().item() \
            / max(want_t.abs().max().item(), 1e-30)
        print(f"{tag} {path} {what} {tuple(mine.shape)} served vs plain: "
              f"{msg}; relative to max|ref| {rel:.3e} (max|ref| "
              f"{want_t.abs().max().item():.3e})", flush=True)
        check(ok, f"{tag} {path} {what}: served differs from plain")
    check(np.abs(np.asarray(got["logits"]).sum(-1) - 1).max() < 1e-4,
          "KernelSHAP probabilities do not sum to 1")
    return calls


def long_text_loader():
    """One test input of more than 511 tokens (the sample sentences
    joined, twice) labelled as the first: every player holds a token where
    the background rows hold padding.  A padded input's padding players
    are tied by symmetry, and float noise orders them: on the first
    sample sentence (15 tokens) the fp32 AUCs moved by 2.2e-3 between the
    kernel and plain runs on the H100, over the 1e-3 gate."""
    from autognothi_tpu_torch.data.loader import DatasetLoader

    samples = json.loads((REPO / "autognothi_tpu_torch" / "data"
                          / "nlp_samples.json").read_text())
    item = ([" ".join(nlp_samples() * 2)], [samples[0]["targets"]])
    item = (*item, list(item[0]), list(item[1]))
    return DatasetLoader(train_raw=lambda b: iter([item]),
                         test_raw=lambda b: iter([item]))


def phase_kernel_shap(dev, tmp: pathlib.Path, card: str) -> dict:
    """Phase 12: `train_all` of a random KernelSHAP BERT-base@512 through
    `cli_main` (k-means on the host), the host final served fp32 and W8A8
    against plain, the faithfulness quality gate on the host final over
    one input that fills the 512 tokens (`long_text_loader`; fp32 within
    1e-3, W8A8 within 5e-3), and one profiled explained row per path; ->
    the kernel calls."""
    import numpy as np
    import torch

    from autognothi_tpu_torch.cli import main as cli_main
    from autognothi_tpu_torch.params import load_params_file
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.measure_faithfulness import \
        measure_faithfulness
    from autognothi_tpu_torch.pipeline.reports import to_json
    from autognothi_tpu_torch.pipeline.resources import (get_recipe,
                                                         load_epoch_model,
                                                         load_misc)

    tag = "[kernel_shap]"
    exp = write_kernel_shap_experiment(tmp)
    stage_calls: dict = {}
    t0 = time.perf_counter()
    with report_env("2", False), counted_stages(stage_calls):
        cli_main(["train_all", str(exp), "--device", "cuda"])
    log = (exp / ".log.txt").read_text()
    xs_train = load_params_file(exp / "final-epoch-0.ckpt")[
        "explainer.Xs_train"]
    print(f"{tag} KernelSHAP BERT-base@512 train_all in "
          f"{time.perf_counter() - t0:.1f} s (k-means on the host); kernel "
          f"calls by stage {stage_calls}; Xs_train {xs_train.shape} "
          f"{xs_train.dtype}, {int((xs_train != 0).sum())} non-pad ids | "
          f"{card}", flush=True)
    check(f"> compressed data: ({KSHAP_DATA}, {T_BERT})" in log
          and "all stages ok" in log and xs_train.dtype == np.int32
          and (xs_train != 0).any(), "KernelSHAP train_all")
    total: dict = {}
    for int8 in (False, True):
        total = _scaled((1, total), (1, serve_host_final(
            dev, exp, int8, card, f"{tag} serve")))
    loader = long_text_loader()
    for path, int8 in (("fp32", False), ("int8", True)):
        with report_env("2", int8):
            reset_counts()
            t1 = time.perf_counter()
            with ExpEnv(exp) as env:
                got = to_json(measure_faithfulness(env, d_loader=loader,
                                                   device="cuda"))
            torch.cuda.synchronize()
            kernel_s = time.perf_counter() - t1
            run = {k: v for k, v in read_counts().items() if v}
            t1 = time.perf_counter()
            with plain_ops(), ExpEnv(exp) as env:
                want = to_json(measure_faithfulness(env, d_loader=loader,
                                                    device="cuda"))
            plain_s = time.perf_counter() - t1
        worst, curve, points = faith_drift(got, want)
        print(f"{tag} quality gate, faithfulness {path} (1 input of 511 "
              f"players): AUCs "
              + ", ".join(f"{c} {got[c]['auc']:.6f} (plain "
                          f"{want[c]['auc']:.6f})" for c in CURVES)
              + f"; worst AUC drift {worst:.3e} on {curve} (limit "
              f"{FAITH_TOL[path]:g}); largest curve-point drift "
              f"{points:.3e}; kernels {kernel_s:.2f} s, plain {plain_s:.2f} "
              f"s; kernel calls {run} | {card}", flush=True)
        check(all(run.get(k, 0) > 0 for k in KSHAP_FAITH_KERNELS[path]),
              f"KernelSHAP faithfulness {path} launched {run}")
        check(worst <= FAITH_TOL[path],
              f"KernelSHAP faithfulness {path}: AUC drift {worst:.3e}")
        total = _scaled((1, total), (1, run))
    with ExpEnv(exp) as env:
        recipe, cfg = get_recipe(env.config)
        _, model = load_epoch_model(env, recipe, "final", dev)
        xs = torch.from_numpy(recipe.gen_input(
            cfg, load_misc(env, recipe, cfg))(CORPUS[:1], [0])[0]).to(dev)
    for path, int8 in (("fp32", False), ("int8", True)):
        with int8_mode(int8), torch.inference_mode():
            profile_forward(f"KernelSHAP BERT-base@512 {path}, one explained "
                            f"row ({KSHAP_SLABS} slabs of 64 x 512)",
                            lambda: recipe.fw_final(cfg, model, xs), card)
    del model
    torch.cuda.empty_cache()
    return total


def phase_native() -> None:
    """The native WordPiece core on this host: loaded (built by this run
    or found under `build/native/`), and the texts each path encoded over
    the whole run; fails where the core did not load or encoded nothing."""
    from autognothi_tpu_torch import native
    from autognothi_tpu_torch.data.tokenizer import ENCODES

    lib = native.library_path("wordpiece")
    built = native.build_seconds.get("wordpiece")
    print(f"[native] wordpiece core {lib.relative_to(REPO)}: "
          + (f"built by g++ in {built:.2f} s" if built is not None
             else "loaded from an earlier build")
          + f"; texts encoded natively {ENCODES['native']}, by the Python "
          f"path {ENCODES['python']}", flush=True)
    check(native._libs.get("wordpiece") is not None,
          f"the native WordPiece core did not load: "
          f"{native.build_errors.get('wordpiece')}")
    check(ENCODES["native"] > 0, "no text went through the native core")
    phase_native_imageproc()


def phase_native_imageproc() -> None:
    """The native image core on this host: loaded (built by this run or
    found under `build/native/`), its resize of an odd-sized image to 224
    x 224 against the numpy grid (within 1e-5: fp32 against float64) and
    both paths' ms; fails where the core did not load."""
    import numpy as np

    from autognothi_tpu_torch import native
    from autognothi_tpu_torch.data import loader

    lib = loader._native_imageproc()
    check(lib is not None, f"the native image core did not load: "
                           f"{native.build_errors.get('imageproc')}")
    built = native.build_seconds.get("imageproc")
    img = np.random.RandomState(SEED).rand(3, 500, 375).astype(np.float32)
    times = {}
    for name, fn in (("native", loader._resize_chw),
                     ("numpy", loader._resize_chw_numpy)):
        t0 = time.perf_counter()
        for _ in range(10):
            out = fn(img, 224, 224)
        times[name] = ((time.perf_counter() - t0) * 100, out)
    err = float(np.abs(times["native"][1] - times["numpy"][1]).max())
    print(f"[native] image core "
          f"{native.library_path('imageproc').relative_to(REPO)}: "
          + (f"built by g++ in {built:.2f} s" if built is not None
             else "loaded from an earlier build")
          + f"; resize <3, 500, 375> -> 224 x 224: {times['native'][0]:.2f}"
          f" ms, numpy {times['numpy'][0]:.2f} ms (host), max|native - "
          f"numpy| {err:.2e} (limit 1e-05)", flush=True)
    check(err <= 1e-5, "the native resize differs from the numpy grid")


def phase_k3_wide(dev, card: str) -> None:
    """K3's wide route (F11) alone at the vanilla heads: <64, 197, 768> ->
    3072 -> 3072 -> 10 with LN, fp32 and bf16, and <8, 512, 768> -> 3072
    -> 3072 -> 2 without: against its plain version, CUDA-event and device
    ms, its launches per call, beside its bound and `torch._int_mm` (+ d3
    on `torch.matmul`) on the same products."""
    import torch

    from autognothi_tpu_torch.ops import head_block as hb

    g = torch.Generator().manual_seed(SEED + 13)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    for b, t, c, has_ln, dtype in ((B_TIME, T, 10, True, torch.float32),
                                   (B_TIME, T, 10, True, torch.bfloat16),
                                   (B_BERT, T_BERT, 2, False,
                                    torch.float32)):
        h_in, inter = 768, 3072
        args = (rnd(b, t, h_in).to(dtype),
                rnd(inter, h_in, scale=h_in ** -0.5), rnd(inter, scale=0.1),
                rnd(inter, inter, scale=inter ** -0.5),
                rnd(inter, scale=0.1), rnd(c, inter, scale=inter ** -0.5),
                rnd(c, scale=0.1),
                (1 + rnd(h_in, scale=0.1)) if has_ln else None,
                rnd(h_in, scale=0.1) if has_ln else None, 1e-5)
        label = (f"<{b}, {t}, {h_in}> -> {inter} -> {inter} -> {c} "
                 f"{'LN' if has_ln else 'no-LN'} {str(dtype)[6:]}")
        check(hb.k3_route(h_in, inter, c) == "wide", "K3's route")
        with torch.inference_mode():
            op = lambda: hb.explainer_head_block(*args)  # noqa: E731
            tensors, static = hb.explainer_head_block_args(*args)
            plain = lambda: hb.head_int8_plain(*tensors, **static)  # noqa
            _, ok, msg = compare(op(), plain(), dtype, True)
            kernels = profiled_kernels(op, 4)
            dev_ms = sum(ms for _, ms in kernels) / 4
            t_kern = cuda_time(op, reps=10)
            t_plain = cuda_time(plain, reps=10)
            t_lib = time_library_int8("head_block", args, card)
        bound_ms, bound_by = op_bound("head_block", args)
        names = sorted({n[:40] for n, _ in kernels})
        print(f"[k3-wide] {label}: kernel {t_kern:.4f} ms (device "
              f"{dev_ms:.4f}, {len(kernels) // 4} launches: "
              f"{', '.join(names)}), plain {t_plain:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), torch._int_mm x 2 + d3 "
              f"{t_lib:.4f} ms ({msg}) | {card}", flush=True)
        check(ok, f"K3 wide {label}: kernel disagrees with plain")
        check(len(kernels) <= 5 * 4, f"K3 wide {label}: "
                                     f"{len(kernels) / 4} launches a call")
    torch.cuda.empty_cache()


# ------------------------------------------- phase 13: ViT-L/16@224

VIT_L_T, VIT_L_H, VIT_L_HEADS, VIT_L_INTER, VIT_L_B = 197, 1024, 16, 4096, 8
# the image demo's test set: `cv_samples` at 224 px in 10 balanced classes
DEMO_IMAGES = 64


def vit_large_routes() -> dict:
    """The JAX gates' choice for each ViT-L block at T = 197 (`ops/
    gates.py`): -> {path: text}, printed, and the tile counts checked
    against the kernel-call table."""
    import torch

    from autognothi_tpu_torch.ops import gates

    t, h, inter = VIT_L_T, VIT_L_H, VIT_L_INTER
    routes = {}
    for label, dtype, quant in (("fp32", torch.float32, "none"),
                                ("int8", torch.float32, "int8"),
                                ("int8 bf16", torch.bfloat16, "int8"),
                                ("bf16", torch.bfloat16, "none")):
        tiles = gates.mlp_block_tiles(t, h, inter, dtype, quant)
        fits = gates.attention_block_fits(t, h, dtype, quant)
        routes[label] = (tiles, fits)
    head = gates.head_token_tile(t, h, VIT_L_INTER, 10)
    check(routes == {"fp32": (4, False), "int8": (2, True),
                     "int8 bf16": (1, True), "bf16": (2, True)}
          and head is None, f"the ViT-L gates moved: {routes}, head {head}")
    return {"fp32": "attention K6 (JAX: its XLA block, the weights do not "
                    "fit), MLP K7 (JAX: 4 float tiles, the same sum)",
            "int8": "attention K1, MLP K8q in 2 tiles",
            "int8 bf16": "attention K1, MLP K4 in one pass",
            "bf16": "attention K6, MLP the K8 chain in 2 tiles",
            "mode 1": "every attention core K9",
            "int8 head": "eager W8A8 denses (no token tile fits), no K3"}


def vit_large_op_cases(dev):
    """(name, tag, op, plain, args, kwargs, dtype) of each kernel op on the
    ViT-L paths at its shape (B = 8, T = 197, 1024 wide, 16 heads, MLP
    4096; the ops' gates choose the route, and the plain version is the
    same op with its kernels routed to their plain versions)."""
    import torch

    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import flash_attention as fa
    from autognothi_tpu_torch.ops import mlp_block as mb

    g = torch.Generator().manual_seed(SEED + 15)
    b, t, h, inter = VIT_L_B, VIT_L_T, VIT_L_H, VIT_L_INTER

    def lin(d_out, d_in):
        bound_ = d_in ** -0.5
        return ((torch.rand(d_out, d_in, generator=g) * 2 - 1) * bound_
                ).to(dev), ((torch.rand(d_out, generator=g) * 2 - 1)
                            * bound_).to(dev)

    ln = ((1 + 0.1 * torch.randn(h, generator=g)).to(dev),
          (0.1 * torch.randn(h, generator=g)).to(dev), 1e-12)
    x32 = torch.randn((b, t, h), generator=g).to(dev)
    ws = tuple(x for _ in range(4) for x in lin(h, h))
    (w1, b1), (w2, b2) = lin(inter, h), lin(h, inter)
    mask = torch.ones(b, t, device=dev)
    cases = []
    for name, quant, dtype, path in (
            ("attention_block", "none", torch.float32, "fp32"),
            ("attention_block", "none", torch.bfloat16, "bf16"),
            ("attention_block_int8", "int8", torch.float32, "W8A8"),
            ("attention_block_int8", "int8", torch.bfloat16,
             "W8A8 bf16 params")):
        op = functools.partial(ab.attention_block, quant=quant)
        w = tuple(x.to(dtype) for x in ws)
        cases.append((name, f"<{b},{t},{h}> {VIT_L_HEADS} heads LN {path}",
                      op, _under_plain(op),
                      (x32.to(dtype), mask, w, VIT_L_HEADS, "mul"),
                      dict(ln=ln, ln_position="prologue"), dtype))
    for name, quant, dtype, path in (
            ("mlp_block", "none", torch.float32, "fp32 one pass"),
            ("mlp_block_int8_tiled", "int8", torch.float32,
             "W8A8 2 tiles"),
            ("mlp_block_int8", "int8", torch.bfloat16,
             "W8A8 bf16 params one pass"),
            ("mlp_block_tiled", "none", torch.bfloat16, "bf16 2 tiles")):
        op = functools.partial(mb.mlp_block, quant=quant)
        cases.append((name, f"{h}/{inter} LN {path}", op, _under_plain(op),
                      (x32.to(dtype), w1.to(dtype), b1.to(dtype),
                       w2.to(dtype), b2.to(dtype)),
                      dict(ln=ln, ln_position="prologue"), dtype))
    d = h // VIT_L_HEADS
    q, k, v = (torch.randn((b, VIT_L_HEADS, t, d), generator=g).to(dev)
               for _ in range(3))
    keep = (torch.rand(b, t, generator=g) > 0.4).float()
    keep[:, 0] = 1
    rows = {"mul": keep.to(dev),
            "add": ((1 - keep) * torch.finfo(torch.float32).min).to(dev)}
    for mode in ("add", "mul"):
        op = functools.partial(fa.masked_attention, mode=mode)
        cases.append(("masked_attention",
                      f"<{b},{VIT_L_HEADS},{t},{d}> {mode}", op,
                      _under_plain(op), (q, k, v, rows[mode]), {},
                      torch.float32))
    return cases


def time_library_float(args: tuple, card: str) -> float:
    """The K8 chain's two products on bf16 `torch.matmul` (x W1^T, h
    W2^T), device ms per call: the yardstick, timed here only."""
    import torch

    x, w1, w2 = args[0], args[1], args[3]
    x2 = x.reshape(-1, x.shape[-1])
    hid = torch.randn((x2.shape[0], w1.shape[0]),
                      generator=torch.Generator().manual_seed(SEED)
                      ).to(x.device, x.dtype)

    def run():
        torch.matmul(x2, w1.T)
        torch.matmul(hid, w2.T)
    ms = device_time(run, 10)
    print(f"[vit-l op] mlp_block_tiled library yardstick torch.matmul x 2 "
          f"bf16: device {ms:.4f} ms | {card}", flush=True)
    return ms


def phase_vit_large_ops(dev, card: str) -> None:
    """Each kernel op of the ViT-L paths at its shape: its route (the op's
    counter and no other), against its plain version, CUDA-event ms of
    kernel and plain, device ms and launches a call, its bound and the
    library's time where one call computes the same (`torch._int_mm` on
    K8q's and K4's products, SDPA for K9's "add", bf16 `torch.matmul` for
    K8's)."""
    import torch

    for name, tag, op, plain, args, kw, dtype in vit_large_op_cases(dev):
        with torch.inference_mode():
            reset_counts()
            got = op(*args, **kw)
            torch.cuda.synchronize()
            calls = {k: v for k, v in read_counts().items() if v}
            check(set(calls) == {name},
                  f"ViT-L {name} {tag}: the op went to {calls}")
            _, ok, msg = compare(got, plain(*args, **kw), dtype,
                                 name in INT8_OPS)
            kernels = profiled_kernels(lambda: op(*args, **kw), 4)
            dev_ms = sum(ms for _, ms in kernels) / 4
            t_kern = cuda_time(lambda: op(*args, **kw), reps=10)
            t_plain = cuda_time(lambda: plain(*args, **kw), reps=10)
            t_lib = None
            if name == "masked_attention" and tag.endswith(" add"):
                t_lib = time_library_attention(args, card)
            elif name in ("mlp_block_int8", "mlp_block_int8_tiled"):
                t_lib = time_library_int8(name, args, card)
            elif name == "mlp_block_tiled":
                t_lib = time_library_float(args, card)
        bound_ms, bound_by = op_bound(name, args)
        print(f"[vit-l op] {name:20s} {tag}: kernel {t_kern:.4f} ms "
              f"(device {dev_ms:.4f}, {len(kernels) // 4} launches), plain "
              f"{t_plain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
              + (f", library {t_lib:.4f} ms" if t_lib is not None else "")
              + f" ({msg}) | {card}", flush=True)
        check(ok, f"ViT-L {name} {tag}: kernel disagrees with plain")
    torch.cuda.empty_cache()


def phase_image_demo(exp: pathlib.Path, card: str) -> dict:
    """`run_image_explanation` of the ViT-L final over DEMO_IMAGES
    `cv_samples` test images at 224 px, 10 classes, with the kernels and
    then plain: the same items, their attributions within the serve
    gate (fp32), the JPEGs equal; at least one item.  Where Pillow is
    missing on this host the verb refuses before loading a model, and
    its device part (`explain_images`) runs instead; -> the kernel calls
    of the kernels' run."""
    import numpy as np
    import torch

    from autognothi_tpu_torch.data.loader import load_cv_samples
    from autognothi_tpu_torch.pipeline import run_image_explanation as rie
    from autognothi_tpu_torch.pipeline.env import ExpEnv

    loader = load_cv_samples(train_size=TRAIN_B, test_size=DEMO_IMAGES,
                             img_px_size=224, num_classes=10, seed=SEED)
    try:
        rie.require_pillow()
        pil = True
    except ImportError as err:
        pil = False
        print(f"[image demo] {err}: the verb refused before loading a "
              f"model; its device part runs, and the JPEG field is not "
              f"written on this host", flush=True)
    got, calls, seconds = {}, {}, {}
    for which in ("kernels", "plain"):
        env = ExpEnv(exp)
        reset_counts()
        t0 = time.perf_counter()
        with (plain_ops() if which == "plain" else contextlib.nullcontext()):
            if pil:
                into = exp / f"image_explanation_{which}.json"
                rie.run_image_explanation(env, loader, into, None,
                                          device="cuda")
                items = json.loads(into.read_text())["items"]
                got[which] = [(v["image"], np.asarray(v["explanation"],
                                                      np.float32))
                              for _, v in sorted(items.items(),
                                                 key=lambda kv: int(kv[0]))]
            else:
                got[which] = [(i, attr) for i, _, attr in
                              rie.explain_images(env, loader, None, "cuda")]
        torch.cuda.synchronize()
        seconds[which] = time.perf_counter() - t0
        if which == "kernels":
            calls = {k: v for k, v in read_counts().items() if v}
        env.close()
    kern, plain = got["kernels"], got["plain"]
    check(len(kern) >= 1, "the image demo kept no image")
    check([k for k, _ in kern] == [k for k, _ in plain],
          "the image demo kept other items (or JPEGs) with the kernels "
          "than plain")
    worst = max((float(np.abs(a - b).max()), float(np.abs(b).max()))
                for (_, a), (_, b) in zip(kern, plain))
    lim = TOL["float32"] * max(1.0, worst[1])
    print(f"[image demo] ViT-L/16@224 over {DEMO_IMAGES} cv_samples test "
          f"images: {len(kern)} items kept (prediction = label), the same "
          f"with the kernels and plain{'' if pil else ' (test indices)'}; "
          f"max|kernel-plain| attribution {worst[0]:.3e} (limit {lim:.3e});"
          f" JPEG field {'written, equal' if pil else 'not written'}; "
          f"{seconds['kernels']:.1f} s with the kernels, "
          f"{seconds['plain']:.1f} s plain; kernel calls {calls} | {card}",
          flush=True)
    check(worst[0] <= lim, "the image demo's attributions differ from "
                           "plain")
    check(calls == _scaled((DEMO_IMAGES, VANILLA_COUNTS[("vit_large",
                                                         "fp32")])),
          f"the image demo's kernel calls {calls}")
    return calls


def phase_vit_large(dev, tmp: pathlib.Path, card: str) -> dict:
    """Phase 13: a random vanilla ViT-L/16@224 final at the published
    widths and all 24 layers, served fp32 and W8A8 (fp32 parameters;
    phase 3's `images` and `images_u8` requests, 3 slabs of 8, each held
    against the plain forward), `fw_final` at B = 8 on W8A8 with bf16
    parameters, bf16 and mode "1" against plain, every path timed
    (expl/s) and profiled, with the routes the JAX gates chose and the
    kernel calls a slab (`VANILLA_COUNTS`); each op at its ViT-L shape
    (`phase_vit_large_ops`); the image demo (`phase_image_demo`); -> the
    kernel calls of the served, forwarded and demo paths."""
    import torch

    for path, route in vit_large_routes().items():
        print(f"[vit-l] route {path}: {route}", flush=True)
    exp = write_tower_final(tmp, "vit_large")
    total = phase_tower_serve(dev, tmp, card, "vit_large", exp=exp)
    phase_vit_large_ops(dev, card)
    total = _scaled((1, total), (1, phase_image_demo(exp, card)))
    torch.cuda.empty_cache()
    return total


# ---------------------------------------- phase 14: demos and verbs

DEMO_REPS = 8  # the Shapley preview's repetitions, the JAX default


def counted(fn, *args, **kwargs):
    """-> (fn's result, the kernel calls it made from counts of 0, its
    seconds)."""
    import torch

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return (out, {k: v for k, v in read_counts().items() if v},
            time.perf_counter() - t0)


def one_sentence_loader(text: str, label: int):
    from autognothi_tpu_torch.data.loader import DatasetLoader

    def it(batch_size: int):
        yield [text], [label], [text], [label]

    return DatasetLoader(train_raw=it, test_raw=it)


def phase_demos(dev, tmp: pathlib.Path, card: str) -> dict:
    """Phase 14: the demos and the other verbs through `cli_main` on the
    checkpoints phases 8 and 9 wrote (the LTT BERT-base@512 and the
    vanilla ViT-B/16@224, at their cut depths): `run_text_explanation
    --limit 2`; `__preview_text_shapley__` on one sentence with
    DEMO_REPS permutations, its Shapley values with the kernels against
    plain; `__show_fridge__`; `estimate_train_time` (the cached train
    resources report); `pretrain_classifier` of a 2-layer vanilla ViT into
    a temporary zoo store, and a second experiment's
    `conv_pretrained_classifier` loading that base bit for bit;
    `preload_all`, which names what is not in the local caches; -> the
    kernel calls of the counted verbs."""
    import numpy as np
    import torch

    from autognothi_tpu_torch.cli import main as cli_main
    from autognothi_tpu_torch.params import load_params_file
    from autognothi_tpu_torch.pipeline import preview_text_shapley as pts
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.zoo import loader as zoo

    bert, vit = tmp / "ltt_bert_run_all", tmp / "vanilla_vit_run_all"
    for exp in (bert, vit):
        check((exp / "final-epoch-0.ckpt").exists(),
              f"phase 14 needs {exp.name}'s final")
    total: dict = {}

    into = tmp / "text_explanation.json"
    _, calls, sec = counted(cli_main, [
        "run_text_explanation", str(bert), "--into", str(into), "--limit",
        "2", "--device", "cuda"])
    items = json.loads(into.read_text())["items"]
    check(all(isinstance(t, str) and math.isfinite(a)
              for pairs in items.values() for t, a in pairs),
          "run_text_explanation wrote a malformed item")
    print(f"[demos] run_text_explanation --limit 2 (LTT BERT-base@512 at "
          f"{BERT_RUN_ALL_LAYERS} layers): {len(items)} items (prediction ="
          f" label), {sum(len(p) for p in items.values())} tokens, "
          f"{sec:.1f} s; kernel calls {calls} | {card}", flush=True)
    check(len(calls) > 0, "run_text_explanation launched no kernel")
    total = _scaled((1, total), (1, calls))

    sample = json.loads((REPO / "autognothi_tpu_torch" / "data"
                         / "nlp_samples.json").read_text())[0]
    env = ExpEnv(bert)
    svs: dict = {}
    for which in ("kernels", "plain"):
        got = []

        def record(*args, **kwargs):
            out = montecarlo(*args, **kwargs)
            got.append(out)
            return out

        montecarlo = pts.montecarlo_shapley
        with mock.patch.object(pts, "montecarlo_shapley", record), \
                (plain_ops() if which == "plain"
                 else contextlib.nullcontext()):
            _, calls, sec = counted(
                pts.preview_text_shapley, env,
                one_sentence_loader(sample["inputs"], sample["targets"]),
                reps=DEMO_REPS, device="cuda")
        svs[which] = (got[0], calls, sec)
    env.close()
    (sv, v0, vn), calls, sec = svs["kernels"]
    (sv_p, v0_p, vn_p), _, sec_p = svs["plain"]
    scale = max(1.0, float(np.abs(sv_p).max()))
    drift = max(float(np.abs(a - b).max())
                for a, b in ((sv, sv_p), (v0, v0_p), (vn, vn_p)))
    lim = TOL["float32"] * scale
    print(f"[demos] __preview_text_shapley__ one sentence, {DEMO_REPS} "
          f"permutations of {sv.shape[1]} players ({DEMO_REPS} x "
          f"{sv.shape[1] + 1} coalition rows): {sec:.1f} s with the "
          f"kernels, {sec_p:.1f} s plain; max|kernel-plain| of sv, v0, vN "
          f"{drift:.3e} (limit {lim:.3e}); kernel calls {calls} | {card}",
          flush=True)
    check(drift <= lim and np.isfinite(sv).all(),
          "the Shapley preview's values differ from plain")
    total = _scaled((1, total), (1, calls))

    for exp in (bert, vit):
        _, calls, sec = counted(cli_main, ["__show_fridge__", str(exp),
                                           "--device", "cuda"])
        check(not calls, "__show_fridge__ launched a kernel")
    print(f"[demos] __show_fridge__ printed the freeze tables of "
          f"{bert.name} and {vit.name}", flush=True)

    _, calls, sec = counted(cli_main, ["estimate_train_time", str(vit),
                                       "--device", "cuda"])
    lines = [ln.split("] ", 1)[-1] for ln in
             (vit / ".log.txt").read_text().splitlines()
             if "> surrogate:" in ln or "> explainer:" in ln][-2:]
    print(f"[demos] estimate_train_time (the cached train resources "
          f"report): {lines} | {card}", flush=True)
    check(len(lines) == 2 and not calls,
          "estimate_train_time did not estimate from the cached report")

    store = tmp / "zoo"
    ft = write_tower_experiment(tmp, "vit", "vanilla_vit", "ft_vit_smoke",
                                layers=2)
    with mock.patch.object(zoo, "_STORE", store):
        _, calls, sec = counted(cli_main, ["pretrain_classifier", str(ft),
                                           "--device", "cuda"])
        exported = load_params_file(store / "ft_vit_smoke" / "params.npz")
        check((store / "ft_vit_smoke" / "model.json").exists(),
              "pretrain_classifier wrote no model.json")
        user = write_tower_experiment(tmp, "vit", "vanilla_vit",
                                      "vit_from_ft", layers=2)
        hp = json.loads((user / ".hparams.json").read_text())
        hp["net"]["base_model"] = "ft_vit_smoke"
        (user / ".hparams.json").write_text(json.dumps(hp, indent=2))
        cli_main(["conv_pretrained_classifier", str(user), "--device",
                  "cuda"])
    got = load_params_file(user / "classifier-epoch-0.ckpt")
    same = sorted(got) == sorted(exported) and all(
        np.array_equal(got[k], exported[k]) for k in exported)
    print(f"[demos] pretrain_classifier (vanilla ViT-B/16@224 at 2 layers, "
          f"every parameter trained, 1 epoch): {len(exported)} tensors "
          f"into the zoo store in {sec:.1f} s, kernel calls {calls}; a "
          f"second experiment's conv_pretrained_classifier loaded them "
          f"{'bit for bit' if same else 'WITH DIFFERENCES'} | {card}",
          flush=True)
    check(same, "the ft_ base did not load bit for bit")
    check(calls.get("attention_block") and calls.get("mlp_block"),
          "pretrain_classifier's training launched no K6 or K7")
    total = _scaled((1, total), (1, calls))

    try:
        cli_main(["preload_all"])
        missing = None
    except FileNotFoundError as err:
        missing = str(err)
    print(f"[demos] preload_all (downloads nothing): "
          f"{(missing or 'every set and base is cached').splitlines()[0]}"
          f" ...", flush=True)
    torch.cuda.empty_cache()
    return total


# the `--kernels` artifacts of phase 15: (label, model, W8A8), each served
# from its file and held against phase 3's live serving of the same final
EXPORT_PATHS = (("vit fp32", "vit", False), ("vit int8", "vit", True),
                ("bert int8", "bert", True))
EXPORT_TOL = 1e-5  # the default (plain) artifact against the live plain path
EXPORT_PLAIN_LAYERS = 4  # the default artifacts' depth (a cut for time)


def shallow_final(exp: pathlib.Path, layers: int, tmp: pathlib.Path, dev):
    """The experiment's LTT ViT final cut to its first `layers` trunk
    layers and ladder steps, as an experiment of its own -> (its dir, its
    config, the cut model on `dev`)."""
    import re

    from autognothi_tpu_torch.models.ltt_vit import LttViTConfig
    from autognothi_tpu_torch.params import (from_jax_params,
                                             load_params_file, save_params)

    hp = json.loads((exp / ".hparams.json").read_text())
    hp["net"]["params"]["num_hidden_layers"] = layers
    out = tmp / f"{exp.name}_{layers}_layers"
    out.mkdir()
    (out / ".hparams.json").write_text(json.dumps(hp, indent=2))
    layer = re.compile(r"\.(?:layers\.|s_attn_layers\.\d+_|s_attn_maps\.\d+_)"
                       r"(\d+)\.")
    flat = {k: v for k, v in load_params_file(
        exp / "final-epoch-0.ckpt").items()
        if not (m := layer.search(k)) or int(m.group(1)) < layers}
    save_params(out / "final-epoch-0.ckpt", flat)
    cfg = LttViTConfig(**hp["net"]["params"])
    return out, cfg, from_jax_params(flat, cfg, dev)


def export_timed(exp: pathlib.Path, into: pathlib.Path, card: str,
                 tag: str, **kw) -> dict:
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.export import export_final

    env = ExpEnv(exp)
    t0 = time.perf_counter()
    meta = export_final(env, into, **kw)
    seconds = time.perf_counter() - t0
    env.close()
    print(f"[export] {tag}: export {seconds:.2f} s, {meta['bytes']} bytes "
          f"({meta['n_params']} tensors, batch {meta['batch_size']}, "
          f"platforms {meta['platforms']}, quant {meta['quant']}) | {card}",
          flush=True)
    return meta


def load_timed(path: pathlib.Path, device: str, card: str, tag: str):
    from autognothi_tpu_torch.pipeline.export import load_exported

    t0 = time.perf_counter()
    fw = load_exported(path, device=device)
    print(f"[export] {tag}: load on {device} "
          f"{time.perf_counter() - t0:.2f} s | {card}", flush=True)
    return fw


def drift(got: dict, want: dict) -> float:
    """The largest |difference| between two sets of served responses."""
    import numpy as np

    return max(float(np.abs(np.asarray(got[label][what], np.float32)
                            - np.asarray(want[label][what], np.float32)
                            ).max())
               for label in want for what in ("logits", "attributions"))


def rates_in_turns(fns: dict, b: int, card: str, tag: str) -> None:
    """expl/s of the two forwards of `fns` (live first) with CUDA events,
    in the order live, artifact, artifact, live."""
    live, art = fns
    rates = {live: [], art: []}
    for which in (live, art, art, live):
        rates[which].append(b / (cuda_time(fns[which], reps=3) / 1e3))
    print(f"[export] {tag} B={b} expl/s: "
          + "; ".join(f"{k} {' '.join(f'{v:.2f}' for v in vals)}"
                      for k, vals in rates.items()) + f" | {card}",
          flush=True)


def phase_export(dev, tmp: pathlib.Path, card: str, exps: dict,
                 services: dict, live_got: dict) -> dict:
    """`export_final` and `serve --artifact` on the card (phase 15).  The
    `--kernels` artifacts of phase 3's LTT ViT-B/16@224 final (fp32 and
    W8A8) and LTT BERT-base@512 final (W8A8) at B = 8, each served from
    its file: the same requests as phase 3, kernel calls a slab equal to
    the live tables, every answer bit-identical to phase 3's live serving
    (the same kernels on the same inputs).  The default artifact (the
    plain math, one file for cuda and cpu) of the ViT final, loaded on the
    card and on the CPU and held against the live plain forward (pallas
    mode "0") there within EXPORT_TOL; a symbolic-batch one at B = 3 and
    8.  Export and load seconds, bytes, and expl/s of each artifact
    against its live path at B = 8 (CUDA events, in turns) -> the kernel
    calls of the three served artifacts."""
    import numpy as np
    import torch

    from autognothi_tpu_torch.models.common import pallas_override

    launches: dict = {}
    inputs = {
        "vit": torch.rand((8, 3, 224, 224),
                          generator=torch.Generator().manual_seed(SEED)
                          ).to(dev),
        "bert": torch.randint(1, services["bert"].m_config.vocab_size,
                              (8, T_BERT), generator=torch.Generator(
                              ).manual_seed(SEED)).to(dev)}
    for label, model, int8 in EXPORT_PATHS:
        art = tmp / f"{label.replace(' ', '_')}.agx"
        with int8_mode(int8):
            meta = export_timed(exps[model], art, card, f"{label} --kernels",
                                batch_size=8, platforms=["cuda"],
                                kernels=True)
        check(meta["quant"] == ("int8" if int8 else "none") and
              meta["kernels"], f"{label}: exported {meta}")
        path = "int8" if int8 else "fp32"
        per_slab = (BERT_COUNTS[path] if model == "bert" else
                    INT8_COUNTS if int8 else FP32_COUNTS)
        requests = bert_requests() if model == "bert" else vit_requests()
        calls, service, got = serve_requests(
            exps[model], requests, per_slab, f"artifact {label}",
            artifact=art)
        launches = _scaled((1, launches), (1, calls))
        err = drift(got, live_got[label])
        print(f"[export] {label} served from the artifact vs phase 3's "
              f"live serving: max|diff| = {err:.3e} (bit-identical: "
              f"{err == 0.0}) | {card}", flush=True)
        check(err == 0.0, f"{label}: the artifact's answers differ from "
                          f"live serving by {err:.3e}")
        live = services[model]
        xs = inputs[model]

        def fw_live(live=live, xs=xs, int8=int8):
            with int8_mode(int8), torch.inference_mode():
                return live.recipe.fw_final(live.m_config, live.model, xs)

        rates_in_turns({"live": fw_live,
                        "artifact": lambda f=service.artifact, xs=xs: f(xs)},
                       8, card, f"{label} --kernels")
        del service
        art.unlink()
        torch.cuda.empty_cache()

    # the default artifact, fixed B = 8 and symbolic, of the final's first
    # EXPORT_PLAIN_LAYERS layers: its traces were phase 15's largest part
    live = services["vit"]
    xs = inputs["vit"]
    shallow, cfg_s, model_s = shallow_final(exps["vit"], EXPORT_PLAIN_LAYERS,
                                            tmp, dev)

    def fw_plain(m=model_s, x=xs):
        with pallas_override("0"), torch.inference_mode():
            return live.recipe.fw_final(cfg_s, m, x)

    for batch in (8, 0):
        art = tmp / f"default_{batch}.agx"
        tag = (f"vit default {EXPORT_PLAIN_LAYERS} layers "
               f"B={batch or 'symbolic'}")
        meta = export_timed(shallow, art, card, tag, batch_size=batch)
        check(meta["platforms"] == ["cuda", "cpu"] and not meta["kernels"],
              f"{tag}: exported {meta}")
        fw = load_timed(art, "cuda", card, tag)
        for b in ((8,) if batch else (3, 8)):
            got, want = fw(xs[:b]), fw_plain(x=xs[:b])
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            print(f"[export] {tag} on the card at B={b} vs the live plain "
                  f"forward: max|diff| = {err:.3e} (gate {EXPORT_TOL}) | "
                  f"{card}", flush=True)
            check(err <= EXPORT_TOL, f"{tag} B={b}: {err:.3e} from plain")
        if batch:
            rates_in_turns({"live plain": fw_plain,
                            "artifact": lambda f=fw: f(xs)}, 8, card, tag)
            fw_cpu = load_timed(art, "cpu", card, tag)
            model_cpu = copy.deepcopy(model_s).cpu()
            got = fw_cpu(xs.cpu())
            want = fw_plain(m=model_cpu, x=xs.cpu())
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            print(f"[export] {tag} on the CPU at B=8 vs the live plain "
                  f"forward there: max|diff| = {err:.3e} (gate "
                  f"{EXPORT_TOL})", flush=True)
            check(err <= EXPORT_TOL, f"{tag} on the CPU: {err:.3e}")
            check(np.isfinite(got[1].numpy()).all(), f"{tag}: not finite")
            del fw_cpu, model_cpu
        del fw
        art.unlink()
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------- phase 16: multi-device (M10a)

DIST_TIMEOUT = 300  # seconds a child of phase 16 may take
TP_B, TP_M = 2, 4  # the tensor-parallel step's images x coalitions


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def settled_diff(got: dict, want: dict, grads: dict, lr: float):
    """-> (largest |got - want| where the reference gradient is settled,
    |g| > 1e-4 max|g|, largest elsewhere): AdamW's first update is about
    lr sign(g), so where g is float noise the update may move by 2 lr."""
    import torch

    g_max = max(float(g.abs().max()) for g in grads.values())
    sure, loose = 0.0, 0.0
    for k, w in want.items():
        d = (got[k].float() - w.float()).abs()
        g = grads.get(k)
        mask = (g.abs() > 1e-4 * g_max) if g is not None \
            else torch.ones_like(d, dtype=torch.bool)
        if mask.any():
            sure = max(sure, float(d[mask].max()))
        if (~mask).any():
            loose = max(loose, float(d[~mask].max()))
    check(loose <= 2.02 * lr, f"an unsettled parameter moved {loose:.3e}")
    return sure, loose


def trainable_copy(case, model=None):
    """-> (model, AdamW, the gradients the update saw) on a fresh copy of
    the phase-4 explainer."""
    from autognothi_tpu_torch.pipeline.training import AdamW

    model = copy.deepcopy(case.explainer if model is None else model)
    for name, p in model.named_parameters():
        p.requires_grad_(case.trainable(name))
    params = dict(model.named_parameters())
    opt = AdamW(params, case.trainable)
    grads, update = {}, opt.update

    def spy(p, g, lr, mask):
        grads.update({k: v.detach().clone() for k, v in g.items()
                      if v is not None})
        return update(p, g, lr, mask)

    opt.update = spy
    return model, opt, grads


def step_on(case, step, model, opt, xs, masks, srg=None):
    """One explainer step of `step` (lr 5e-5, every parameter's mask 1)."""
    ones = {k: 1.0 for k, _ in model.named_parameters()}
    return step(model, opt, case.srg if srg is None else srg, case.null, xs,
                None, 5e-5, ones, case.cfg.num_hidden_layers, masks=masks)


def warm_step_ms(run, reps: int = 3) -> float:
    """Host ms a step, over `reps` steps after the first (warm) ones."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def dist_child(spec_path: str) -> int:
    """One rank of phase 16 (`python3 chip_smoke.py --dist-child spec`):
    "a", a world of one through the CLI's own initialisation (NCCL), or
    "b", a rank of a world of two gloo ranks on the one card, or of one
    NCCL rank per card (`--dist-cards`, the CLI's initialisation)."""
    import torch.distributed as dist

    from autognothi_tpu_torch.parallel.distributed import \
        maybe_initialize_distributed
    from autognothi_tpu_torch.utils.devices import resolve_device

    spec = json.loads(pathlib.Path(spec_path).read_text())
    out = {}
    if spec["check"] == "b" and spec["backend"] == "gloo":
        # the port picks NCCL for cuda; two ranks on one card take gloo
        dist.init_process_group("gloo", init_method=spec["init"],
                                world_size=spec["world"], rank=spec["rank"])
    elif spec["check"] == "b":
        check(maybe_initialize_distributed(device="cuda"), "no world")
    dev = resolve_device("cuda")
    case = TrainCase(dev, pathlib.Path(spec["train_exp"]))
    live_int8 = json.loads(pathlib.Path(spec["live_int8"]).read_text())
    if spec["check"] == "a":
        dist_child_a(case, spec, out, live_int8)
    else:
        dist_child_b(case, spec, out, live_int8)
    if dist.is_initialized():
        dist.destroy_process_group()
    pathlib.Path(spec["out"]).write_text(json.dumps(out))
    return 0


def dist_child_a(case, spec: dict, out: dict, live_int8: dict) -> None:
    """A world of one: the explainer step bit-identical to the same step
    without the environment, and a W8A8 serve of phase 3's requests
    bit-identical to phase 3's answers, with its kernel calls a slab."""
    import torch

    from autognothi_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed, process_info)
    from autognothi_tpu_torch.parallel.mesh import setup_data_parallel
    from autognothi_tpu_torch.parallel.train_step import \
        make_explainer_train_step

    start = copy.deepcopy(case.explainer)
    model, opt, _ = trainable_copy(case, start)
    loss0 = step_on(case, case.step, model, opt, case.xs, case.masks).item()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    check(maybe_initialize_distributed(device="cuda"), "no world engaged")
    out["info"] = process_info()
    import torch.distributed as dist

    out["backend"] = dist.get_backend()
    mesh, place_params, _ = setup_data_parallel(case.xs.device)
    check(mesh is None, "a world of one built a mesh")
    step = make_explainer_train_step(case.recipe, case.cfg, case.n_players,
                                     TRAIN_M, mesh=mesh)
    model, opt, _ = trainable_copy(case, place_params(start))
    loss1 = step_on(case, step, model, opt, case.xs, case.masks).item()
    got = model.state_dict()
    out["step_loss"] = [loss0, loss1]
    out["step_bit_identical"] = loss0 == loss1 and all(
        torch.equal(got[k], want[k]) for k in want)
    with int8_mode(True):
        calls, service, answers = serve_requests(
            pathlib.Path(spec["exp"]), vit_requests(), INT8_COUNTS,
            "dist a serve W8A8")
    del service
    out["serve_calls"] = calls
    out["serve_drift"] = drift(answers, live_int8)


def dist_child_b(case, spec: dict, out: dict, live_int8: dict) -> None:
    """Two gloo ranks on the one card: the data-parallel explainer step
    (4 images a rank) against the one-process step in the same arithmetic
    (the teacher's kernels, the differentiated forward in mode "0"), the
    ranks' parameters bit for bit; the tensor-parallel (model 2) step in
    mode "0" against the one-process plain step; a served W8A8 slab split
    over the ranks; a `--data-parallel 2 --kernels` artifact served."""
    import torch
    import torch.distributed as dist

    from autognothi_tpu_torch.models.common import pallas_override
    from autognothi_tpu_torch.parallel import train_step as ts
    from autognothi_tpu_torch.parallel.distributed import process_info
    from autognothi_tpu_torch.parallel.mesh import (make_mesh,
                                                    setup_data_parallel,
                                                    shard_params)
    from autognothi_tpu_torch.params import to_flat

    rank = dist.get_rank()
    out["info"] = process_info()
    out["backend"] = dist.get_backend()
    start = copy.deepcopy(case.explainer)
    # data parallel, B = 8 x M = 32: 4 images a rank
    mesh, place_params, _ = setup_data_parallel(case.xs.device)
    step = ts.make_explainer_train_step(case.recipe, case.cfg,
                                        case.n_players, TRAIN_M, mesh=mesh)
    model, opt, _ = trainable_copy(case, place_params(start))
    reset_counts()
    loss = step_on(case, step, model, opt, case.xs, case.masks).item()
    out["dp_calls"] = {k: v for k, v in read_counts().items() if v}
    trained = {k: p.detach() for k, p in model.named_parameters()
               if p.requires_grad}
    same = True
    for k, p in trained.items():  # rank 0's parameters against each rank's
        theirs = p.clone()
        dist.broadcast(theirs, src=0)
        same &= bool(torch.equal(theirs, p))
    flag = torch.tensor([0.0 if same else 1.0], device=case.xs.device)
    dist.all_reduce(flag)
    out["dp_ranks_bit_identical"] = flag.item() == 0.0
    out["dp_loss"] = loss
    if rank == 0:
        # the same arithmetic in one process: the teacher's kernels on all
        # 8 images, the forward in mode "0" (world > 1 pins it)
        ref, ref_opt, grads = trainable_copy(case, start)
        with mock.patch.object(ts, "_teacher_on",
                               lambda *a: contextlib.nullcontext()):
            ref_loss = step_on(case, case.step, ref, ref_opt, case.xs,
                               case.masks).item()
        sure, loose = settled_diff(
            {k: p.detach() for k, p in model.named_parameters()},
            {k: p.detach() for k, p in ref.named_parameters()}, grads, 5e-5)
        out["dp_ref_loss"] = ref_loss
        out["dp_param_diff"] = [sure, loose]
        with mock.patch.object(ts, "_teacher_on",
                               lambda *a: contextlib.nullcontext()):
            out["ref_ms"] = warm_step_ms(
                lambda: step_on(case, case.step, ref, ref_opt, case.xs,
                                case.masks))
        del ref, ref_opt, grads
    dist.barrier()
    out["dp_ms"] = warm_step_ms(
        lambda: step_on(case, step, model, opt, case.xs, case.masks))
    del model, opt
    # tensor parallel (model 2), mode "0", B = 2 x M = 4
    xs, masks = case.xs[:TP_B], case.masks[:TP_B, :TP_M]
    tp_mesh = make_mesh(dist.get_world_size(), model_parallel=2)
    srg = shard_params(copy.deepcopy(case.srg), tp_mesh)
    model, opt, _ = trainable_copy(case, start)
    shard_params(model, tp_mesh)
    params = dict(model.named_parameters())
    opt = type(opt)(params, case.trainable)
    tp_step = ts.make_explainer_train_step(case.recipe, case.cfg,
                                           case.n_players, TP_M,
                                           mesh=tp_mesh)
    with pallas_override("0"):
        reset_counts()
        tp_loss = step_on(case, tp_step, model, opt, xs, masks,
                          srg=srg).item()
        out["tp_calls"] = {k: v for k, v in read_counts().items() if v}
        tp_params = to_flat(model)  # gathered whole on every rank
        if rank == 0:
            ref, ref_opt, grads = trainable_copy(case, start)
            ref_step = ts.make_explainer_train_step(
                case.recipe, case.cfg, case.n_players, TP_M)
            ref_loss = step_on(case, ref_step, ref, ref_opt, xs,
                               masks).item()
            sure, loose = settled_diff(
                {k: torch.from_numpy(tp_params[k]) for k in grads},
                {k: p.detach().cpu() for k, p in ref.named_parameters()
                 if k in grads}, {k: g.cpu() for k, g in grads.items()},
                5e-5)
            out["tp_loss"], out["tp_ref_loss"] = tp_loss, ref_loss
            out["tp_param_diff"] = [sure, loose]
            del ref, ref_opt, grads
    del model, opt, srg, tp_params
    torch.cuda.empty_cache()
    dist.barrier()
    # pipeline parallelism (M10b): the vanilla towers' PP trainers
    dist_child_pp(spec, out, case.xs.device)
    torch.cuda.empty_cache()
    dist.barrier()
    # serving: the live W8A8 final, then the --data-parallel 2 artifact
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import ExplainService

    deadline = time.time() + DIST_TIMEOUT  # the parent exports it meanwhile
    while not pathlib.Path(spec["artifact"]).exists():
        check(time.time() < deadline, "(b): no --data-parallel 2 artifact")
        time.sleep(0.2)
    for tag, artifact in (("live", None), ("artifact", spec["artifact"])):
        with int8_mode(True):
            if rank == 0:
                calls, service, answers = serve_requests(
                    pathlib.Path(spec["exp"]), vit_requests(), INT8_COUNTS,
                    f"dist b serve W8A8 {tag}",
                    artifact=None if artifact is None
                    else pathlib.Path(artifact))
                out[f"serve_{tag}_calls"] = calls
                out[f"serve_{tag}_drift"] = drift(answers, live_int8)
                del service
            else:
                with ExpEnv(pathlib.Path(spec["exp"])) as env:
                    service = ExplainService(env, 8, device="cuda",
                                             artifact=artifact)
                    reset_counts()
                    slabs = service.follow()
                    out[f"serve_{tag}_slabs"] = slabs
                    out[f"serve_{tag}_calls"] = {
                        k: v for k, v in read_counts().items() if v}
                    del service
        torch.cuda.empty_cache()


PP_LR = 5e-5  # the PP steps' learning rate


def _spied_opt(model, trainable):
    """-> (AdamW over `model`'s parameters, the gradients its update
    sees); the parameters' requires_grad set by `trainable`."""
    from autognothi_tpu_torch.pipeline.training import AdamW

    for name, p in model.named_parameters():
        p.requires_grad_(trainable(name))
    opt = AdamW(dict(model.named_parameters()), trainable)
    grads, update = {}, opt.update

    def spy(params, g, lr, mask):
        grads.update({k: v.detach().clone() for k, v in g.items()
                      if v is not None})
        return update(params, g, lr, mask)

    opt.update = spy
    return opt, grads


def _state_bytes(model, opt) -> list:
    """-> [parameter bytes, AdamW moment bytes, the encoder stack's
    parameter bytes] of a rank."""
    return [sum(p.numel() * p.element_size() for p in model.parameters()),
            sum(t.numel() * t.element_size()
                for store in (opt.mu, opt.nu) for t in store.values()),
            sum(p.numel() * p.element_size()
                for k, p in model.named_parameters()
                if ".encoder.layers." in k)]


def pp_case(out: dict, key: str, ctx, pp_call, ref_make) -> None:
    """One pipeline-parallel step `pp_call()` -> its loss, against the
    same step in one process (rank 0): `ref_make()` -> (model, AdamW,
    gradients, call).  Records the losses, the settled parameter
    difference (the stages gathered to rank 0), each rank's state bytes
    and the one process's, the kernel calls of each, the hops and their
    path, and warm ms a step of both (over 2 steps after the first)."""
    import torch
    import torch.distributed as dist

    from autognothi_tpu_torch.parallel.pipeline import HOPS

    t0 = time.perf_counter()
    reset_counts()
    HOPS.clear()
    loss = float(pp_call())
    res = {"loss": loss, "calls": {k: v for k, v in read_counts().items()
                                   if v},
           "hops": dict(HOPS), "bytes": _state_bytes(ctx.model, ctx.opt)}
    flat = ctx.to_flat(ctx.model)
    res["ms"] = warm_step_ms(pp_call, reps=2)
    if dist.get_rank() == 0:
        model, opt, grads, call = ref_make()
        reset_counts()
        res["ref_loss"] = float(call())
        res["ref_calls"] = {k: v for k, v in read_counts().items() if v}
        res["ref_bytes"] = _state_bytes(model, opt)
        res["param_diff"] = settled_diff(
            {k: torch.from_numpy(flat[k]) for k in grads},
            {k: p.detach().cpu() for k, p in model.named_parameters()
             if k in grads}, {k: g.cpu() for k, g in grads.items()}, PP_LR)
        res["ref_ms"] = warm_step_ms(call, reps=2)
        del model, opt, grads
    dist.barrier()
    torch.cuda.empty_cache()
    res["s"] = time.perf_counter() - t0
    out[key] = res


def pp_explainer_case(out: dict, key: str, model_of: tuple, exp_flat: dict,
                      mb: int, tp: int, dev, gen, log) -> None:
    """`pp_case` of the explainer step (`setup_pp_explainer`) at the
    experiment's batch and M, the teacher with its kernels per rank on a
    mesh without a "model" axis (the one process patches its teacher
    scope to the same), in mode "0" when tp > 1 (both sides)."""
    import torch

    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.parallel import train_step as ts
    from autognothi_tpu_torch.pipeline import pp_trainer as ppt

    _, config, recipe, cfg, srg_flat = model_of
    t_cfg = config.train_explainer
    b, m, n_players = t_cfg.batch_size, t_cfg.n_mask_samples, \
        recipe.n_players(cfg)
    if recipe.id == "vanilla_vit":
        xs = torch.randn((b, 3, cfg.img_px_size, cfg.img_px_size),
                         generator=gen, device=dev)
    else:
        xs = torch.randint(5, cfg.vocab_size, (b, n_players + 1),
                           generator=gen, device=dev)
    masks = (torch.rand((b, m, n_players), generator=gen, device=dev)
             > 0.5).to(torch.int32)
    null = torch.softmax(torch.randn((1, cfg.num_labels), generator=gen,
                                     device=dev), dim=-1)
    srg = from_jax_params(srg_flat, cfg, dev, section="surrogate")
    srg.requires_grad_(False)
    ctx, srg, step, _ = ppt.setup_pp_explainer(
        log, config, cfg, exp_flat, srg, recipe, 2, mb, tp, device=dev)
    every = lambda model: {k: 1.0 for k, _ in model.named_parameters()}  # noqa

    def ref_make():
        model = from_jax_params(exp_flat, cfg, dev, section="explainer")
        opt, grads = _spied_opt(model, lambda k: True)
        full = from_jax_params(srg_flat, cfg, dev, section="surrogate")
        full.requires_grad_(False)
        ref = ts.make_explainer_train_step(recipe, cfg, n_players, m)
        teacher_on = ((lambda *a: contextlib.nullcontext()) if tp == 1
                      else ts._teacher_on)

        def call():
            with mock.patch.object(ts, "_teacher_on", teacher_on):
                return ref(model, opt, full, null, xs, None, PP_LR,
                           every(model), cfg.num_hidden_layers, masks=masks)
        return model, opt, grads, call

    pp_case(out, key, ctx, lambda: step(
        ctx.model, ctx.opt, srg, null, xs, None, PP_LR, every(ctx.model),
        cfg.num_hidden_layers, masks=masks), ref_make)


def dist_child_pp(spec: dict, out: dict, dev) -> None:
    """Pipeline parallelism (M10b) on the ranks of phase 16 (b): over two
    gloo ranks on the one card a (data 1 x pipe 2) mesh, over four NCCL
    cards (data 2 x pipe 2) and (data 1 x pipe 2 x model 2).  On each,
    the random vanilla ViT-B/16@224 (12 layers, 6 a stage) classifier
    step (every parameter trainable, as `pretrain_classifier`), surrogate
    step and explainer step at B = 8 x M = 32 (microbatches 2, and 4 on
    the one card), and the random BERT-base@512 classifier step at B = 8,
    each against the same step in one process in the same arithmetic
    (`pp_case`); then the `train_explainer` CLI for one epoch under
    AUTOGNOTHI_PP=2, whose flat checkpoint rank 0 loads."""
    from types import SimpleNamespace

    import numpy as np
    import torch
    import torch.distributed as dist

    from autognothi_tpu_torch.cli import main as cli_main
    from autognothi_tpu_torch.params import from_jax_params, save_params
    from autognothi_tpu_torch.parallel.pipeline import HOPS
    from autognothi_tpu_torch.pipeline import pp_trainer as ppt
    from autognothi_tpu_torch.pipeline.config import parse_config
    from autognothi_tpu_torch.pipeline.resources import get_recipe
    from autognothi_tpu_torch.pipeline.train_classifier import \
        classifier_loss
    from autognothi_tpu_torch.pipeline.train_surrogate import surrogate_loss
    from autognothi_tpu_torch.pipeline.training import make_train_step

    t_all = time.perf_counter()
    rank, world = dist.get_rank(), dist.get_world_size()
    layouts = ([("pp2", 1, (2, 4))] if world == 2 else
               [("dp2xpp2", 1, (2,)), ("pp2xtp2", 2, (2,))])
    log = SimpleNamespace(log=lambda *_: None)
    t0 = time.perf_counter()
    models = {}
    for family in ("vit", "bert"):
        exp = pathlib.Path(spec[f"pp_{family}"])
        config = parse_config(json.loads(
            (exp / ".hparams.json").read_text()))
        recipe, cfg = get_recipe(config)
        cls = recipe.init_classifier(cfg, torch.Generator().manual_seed(SEED))
        models[family] = (exp, config, recipe, cfg, cls)
    exp, config, recipe, cfg, srg_flat = models["vit"]
    exp_flats = {family: m[2].init_explainer(
        m[3], torch.Generator().manual_seed(SEED + 1))
        for family, m in models.items() if family == "vit" or world == 2}
    exp_flat = exp_flats["vit"]
    if rank == 0:  # the CLI's checkpoints
        save_params(exp / "surrogate-epoch-1.ckpt", srg_flat)
        save_params(exp / "explainer-epoch-0.ckpt", exp_flat)
    out["pp_init_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, n_players = TRAIN_B, recipe.n_players(cfg)
    xs = torch.randn((b, 3, 224, 224), generator=gen, device=dev)
    labels = torch.randint(0, cfg.num_labels, (b,), generator=gen,
                           device=dev)
    mask_1 = torch.ones((b, n_players), dtype=torch.int32, device=dev)
    mask_rand = (torch.rand((b, n_players), generator=gen, device=dev)
                 > 0.5).to(torch.int32)
    orig = torch.softmax(torch.randn((b, cfg.num_labels), generator=gen,
                                     device=dev), dim=-1)
    w = torch.ones((b,), device=dev)
    _, bconfig, _, bcfg, bflat = models["bert"]
    ids = torch.randint(5, bcfg.vocab_size, (b, 512), generator=gen,
                        device=dev)
    bmask = torch.ones((b, 511), dtype=torch.int32, device=dev)
    blabels = labels % bcfg.num_labels
    inputs = {"vit": (xs, mask_1, labels), "bert": (ids, bmask, blabels)}
    every = lambda model: {k: 1.0 for k, _ in model.named_parameters()}  # noqa

    def ref_cls(family):
        _, _, rec, c, flat = models[family]
        model = from_jax_params(flat, c, dev, section="classifier")
        opt, grads = _spied_opt(model, lambda k: True)
        ref = make_train_step(classifier_loss(rec, c, False))
        return model, opt, grads, lambda: ref(
            model, opt, PP_LR, every(model), *inputs[family], None, None,
            w)[0]

    for name, tp, mbs in layouts:
        # the classifier, every parameter trainable
        ctx, step, _ = ppt.setup_pp_classifier(
            log, config, cfg, srg_flat, lambda k: True, 2, 2, tp, device=dev)
        pp_case(out, f"pp {name} vit classifier", ctx, lambda: step(
            ctx.model, ctx.opt, PP_LR, every(ctx.model), xs, mask_1, labels,
            None, None, w)[0], lambda: ref_cls("vit"))
        del ctx, step
        # the surrogate, its teacher rows given
        teacher = from_jax_params(srg_flat, cfg, dev, section="classifier")
        ctx, _, step, _ = ppt.setup_pp_surrogate(
            log, config, cfg, srg_flat, teacher, lambda k: True, 2, 2, tp,
            device=dev)

        def ref_srg():
            model = from_jax_params(srg_flat, cfg, dev, section="surrogate")
            opt, grads = _spied_opt(model, lambda k: True)
            ref = make_train_step(surrogate_loss(recipe, cfg, False))
            return model, opt, grads, lambda: ref(
                model, opt, PP_LR, every(model), xs, mask_rand, orig,
                labels, None, None, w)[0]

        pp_case(out, f"pp {name} vit surrogate", ctx, lambda: step(
            ctx.model, ctx.opt, PP_LR, every(ctx.model), xs, mask_rand, orig,
            labels, None, None, w)[0], ref_srg)
        del ctx, step, teacher
        # the explainer at B = 8 x M = 32: the teacher's kernels per rank
        # unless tensor parallelism shards it (mode "0" then, both sides)
        # on the one card also the fp32 teacher (K6 + K7) and the BERT
        # explainer at the shipped B = 4 x M = 2 (its W8A8 teacher: K6 +
        # two K8q tiles, by the JAX gates)
        explainers = [("vit", mb, {}) for mb in mbs]
        if world == 2:
            explainers += [("vit", 2, {"AUTOGNOTHI_INT8_TEACHER": "0"}),
                           ("bert", 2, {})]
        for family, mb, env in explainers:
            with mock.patch.dict(os.environ, env):
                pp_explainer_case(out, f"pp {name} {family} explainer mb{mb}"
                                  + (" fp32 teacher" if env else ""),
                                  models[family], exp_flats[family], mb, tp,
                                  dev, gen, log)
        # BERT-base@512, the classifier step at B = 8
        ctx, step, _ = ppt.setup_pp_classifier(
            log, bconfig, bcfg, bflat, lambda k: True, 2, 2, tp, device=dev)
        pp_case(out, f"pp {name} bert classifier", ctx, lambda: step(
            ctx.model, ctx.opt, PP_LR, every(ctx.model), ids, bmask,
            blabels, None, None, w)[0], lambda: ref_cls("bert"))
        del ctx, step
    # directory checkpoints of the classifier, TP and PP
    t0 = time.perf_counter()
    dist_child_ckpt(spec, out, dev, config, cfg, srg_flat)
    out["ckpt"]["s"] = time.perf_counter() - t0
    # the CLI: one epoch of train_explainer under AUTOGNOTHI_PP=2
    dist.barrier()
    reset_counts()
    HOPS.clear()
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, {"AUTOGNOTHI_PP": "2"}):
        cli_main(["train_explainer", str(exp), "--device", "cuda"])
    out["pp_cli"] = {"s": time.perf_counter() - t0,
                     "calls": {k: v for k, v in read_counts().items() if v},
                     "hops": dict(HOPS)}
    if rank == 0:
        from autognothi_tpu_torch.params import load_params_file

        got = load_params_file(exp / "explainer-epoch-1.ckpt")
        flat_ok = set(got) == set(exp_flat) and all(
            got[k].shape == exp_flat[k].shape for k in got)
        from_jax_params(got, cfg, dev, section="explainer")  # strict
        out["pp_cli"]["flat"] = flat_ok
        out["pp_cli"]["moved"] = max(
            float(np.abs(got[k] - exp_flat[k]).max()) for k in got)
    out["pp_s"] = time.perf_counter() - t_all


def dist_child_ckpt(spec: dict, out: dict, dev, config, cfg, flat) -> None:
    """`[ckpt-dir]` on the ranks of phase 16 (b): directory checkpoints
    (AUTOGNOTHI_CKPT_BACKEND=orbax) of the random vanilla ViT-B/16@224
    classifier, tensor-parallel (model 2) and as the pipe-2 stages of
    `setup_pp_classifier`, each rank writing its own share; each rank
    loads both and holds them bit for bit against `flat`; rank 0 reads
    which rank file holds each chunk (`out["ckpt"]`).  The optimizer
    moments' directory is the CPU tests' (tests/test_torch_port_ckpt_dir.py)."""
    from types import SimpleNamespace

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    from autognothi_tpu_torch.params import from_jax_params, load_params_file
    from autognothi_tpu_torch.parallel.mesh import make_mesh, shard_params
    from autognothi_tpu_torch.pipeline import pp_trainer as ppt
    from autognothi_tpu_torch.pipeline.resources import save_epoch_ckpt
    from autognothi_tpu_torch.pipeline.training import ckpt_of

    rank, world = dist.get_rank(), dist.get_world_size()
    root = pathlib.Path(spec["train_exp"]).parent / "ckpt_dir"
    train = SimpleNamespace(epochs=1, ckpt_when="_:%1==0")
    log = SimpleNamespace(log=lambda *_: None)
    res = {}

    def held(path) -> bool:
        got = load_params_file(path)
        return set(got) == set(flat) and all(
            np.array_equal(got[k], flat[k]) for k in flat)

    with mock.patch.dict(os.environ, {"AUTOGNOTHI_CKPT_BACKEND": "orbax"}):
        model = from_jax_params(flat, cfg, dev, section="classifier")
        shard_params(model, make_mesh(world, model_parallel=2))
        dist.barrier()
        t0 = time.perf_counter()
        save_epoch_ckpt(root / "tp", "classifier", train, 1,
                        *ckpt_of(None, model, None))
        res["tp_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["tp_equal"] = held(root / "tp" / "classifier-epoch-1.ckpt")
        res["tp_load_s"] = time.perf_counter() - t0
        del model
        ctx, _, _ = ppt.setup_pp_classifier(
            log, config, cfg, flat, lambda k: True, 2, 2, 1, device=dev)
        dist.barrier()
        t0 = time.perf_counter()
        save_epoch_ckpt(root / "pp", "classifier", train, 1,
                        *ckpt_of(None, ctx.model, None))
        res["pp_write_s"] = time.perf_counter() - t0
        res["pp_equal"] = held(root / "pp" / "classifier-epoch-1.ckpt")
        res["pp_keys"] = sorted(k for k, _ in ctx.model.named_parameters())
        del ctx
    torch.cuda.empty_cache()
    if rank == 0:
        for what in ("tp", "pp"):
            path = root / what / "classifier-epoch-1.ckpt"
            meta = dcp.FileSystemReader(str(path)).read_metadata()
            files: dict = {}
            for index, info in meta.storage_data.items():
                files.setdefault(index.fqn, []).append(
                    [int(info.relative_path.split("_")[2]),
                     list(index.offset)])
            res[f"{what}_files"] = files
            res[f"{what}_bytes"] = sum(f.stat().st_size
                                       for f in path.iterdir())
    out["ckpt"] = res


def check_dist_ckpt(b: list, card: str) -> None:
    """`[ckpt-dir]` lines and checks: every rank loads the TP and PP
    directories bit for bit; in the TP directory
    each sharded weight's two halves come from ranks of its own "model"
    coordinate (rank % 2, "model" innermost) and a replicated tensor is
    written once; in the PP one each stage's encoder layers come from
    ranks of its stage (rank % 2, "pipe" innermost) only."""
    world = f"{b[0]['backend']}, {len(b)} ranks"
    res = [r["ckpt"] for r in b]
    x = res[0]
    check(all(r["tp_equal"] and r["pp_equal"] for r in res),
          f"(b) [ckpt-dir]: a rank's load differs: "
          f"{[(r['tp_equal'], r['pp_equal']) for r in res]}")
    q = "vit.encoder.layers.0.attention.self.query.weight"
    owners = sorted(x["tp_files"][q])
    check([r % 2 for r, _ in owners] == [0, 1] and owners[0][1][0] == 0
          and owners[1][1][0] > 0, f"(b) [ckpt-dir] TP {q}: {owners}")
    for k, chunks in x["tp_files"].items():
        offsets = [tuple(off) for _, off in chunks]
        check(len(offsets) == len(set(offsets)),
              f"(b) [ckpt-dir] TP {k} written twice: {chunks}")
        if len(chunks) == 2:
            for r, off in chunks:
                check((r % 2 == 0) == (max(off) == 0),
                      f"(b) [ckpt-dir] TP {k}: rank {r} wrote {off}")
    layer = lambda k: int(k.split(".")[3])  # noqa: E731
    layers = 1 + max(layer(k) for k in x["pp_files"]
                     if k.startswith("vit.encoder.layers."))
    for k, chunks in x["pp_files"].items():
        check(len(chunks) == 1, f"(b) [ckpt-dir] PP {k}: {chunks}")
        if k.startswith("vit.encoder.layers."):
            stage = int(layer(k) >= layers // 2)
            check(chunks[0][0] % 2 == stage,
                  f"(b) [ckpt-dir] PP {k} from rank {chunks[0][0]}")
    sharded = sum(len(c) == 2 for c in x["tp_files"].values())
    print(f"[ckpt-dir] {world}: AUTOGNOTHI_CKPT_BACKEND=orbax, random "
          f"vanilla ViT-B/16@224 classifier: TP (model 2) directory "
          f"{x['tp_bytes']} bytes, {sharded} weights written as two "
          f"halves by their model ranks, the rest once; written in "
          f"{x['tp_write_s']:.2f} s, loaded whole by "
          f"every rank in {x['tp_load_s']:.2f} s, bit for bit; PP (pipe 2) "
          f"directory {x['pp_bytes']} bytes, each stage's layers from its "
          f"own ranks, written in {x['pp_write_s']:.2f} s, loaded bit for "
          f"bit | {card}", flush=True)


def run_dist_children(tmp: pathlib.Path, spec: dict, world: int) -> list:
    """Start `world` ranks of `spec` -> (process, log, result file) of
    each, in rank order (`wait_dist_children` waits for them)."""
    port = _free_port()
    procs = []
    for rank in range(world):
        child = dict(spec, world=world, rank=rank,
                     init=f"tcp://127.0.0.1:{port}",
                     out=str(tmp / f"dist_{spec['check']}_{rank}.json"))
        path = tmp / f"dist_{spec['check']}_{rank}_spec.json"
        path.write_text(json.dumps(child))
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("AUTOGNOTHI_DIST_")}
        if spec["check"] == "a" or spec.get("backend") == "nccl":
            # the CLI's own variables
            env.update({"AUTOGNOTHI_DIST_COORD": f"127.0.0.1:{port}",
                        "AUTOGNOTHI_DIST_NPROCS": str(world),
                        "AUTOGNOTHI_DIST_PROC_ID": str(rank)})
        log = open(tmp / f"dist_{spec['check']}_{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--dist-child",
             str(path)], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT), log, child["out"]))
    return procs


def wait_dist_children(procs: list, tag: str) -> list:
    """Each rank's result; a rank that fails, or outlives DIST_TIMEOUT, is
    a failure, and every rank still running is killed."""
    outs = []
    try:
        for proc, log, out in procs:
            try:
                proc.wait(timeout=DIST_TIMEOUT)
            finally:
                log.close()
            text = pathlib.Path(log.name).read_text()
            (OUT / pathlib.Path(log.name).name).write_text(text)
            for line in text.splitlines():
                if line.startswith("[dist"):
                    print(line, flush=True)
            check(proc.returncode == 0,
                  f"{tag}: a rank exited {proc.returncode}:\n"
                  f"{text[-3000:]}")
            outs.append(json.loads(pathlib.Path(out).read_text()))
    finally:
        for proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def phase_distributed(dev, tmp: pathlib.Path, card: str, exp: pathlib.Path,
                      train_exp: pathlib.Path, live_int8: dict,
                      cards: int = 1) -> dict:
    """Phase 16, the multi-device slice (M10a), in child processes started
    together: (a) a world of one through the CLI's own initialisation
    (AUTOGNOTHI_DIST_*, NCCL) and (b) two gloo ranks on the one card (NCCL
    takes one rank per card); with `cards` past 1 (`--dist-cards`) only
    (b), as one NCCL rank per card.  -> the kernel calls of their served
    slabs."""
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.export import export_final

    tmp = tmp / "dist"
    tmp.mkdir()
    live = tmp / "live_int8.json"
    live.write_text(json.dumps(live_int8))
    art = tmp / "vit_int8_dp2.agx"
    # the pipeline-parallel experiments: random vanilla ViT-B/16@224 and
    # BERT-base@512, written by the ranks (dist_child_pp)
    pp = {f"pp_{family}": str(write_tower_experiment(
        tmp, family, f"vanilla_{family}", f"pp_{family}"))
        for family in ("vit", "bert")}
    spec = dict(exp=str(exp), train_exp=str(train_exp), live_int8=str(live),
                artifact=str(art), **pp)
    children_a = ([] if cards > 1 else
                  run_dist_children(tmp, dict(spec, check="a"), 1))
    # (b) waits for the artifact only before its last check
    children_b = run_dist_children(
        tmp, dict(spec, check="b", backend="nccl" if cards > 1 else "gloo"),
        max(cards, 2))
    try:
        with int8_mode(True), ExpEnv(exp) as env:
            t0 = time.perf_counter()
            meta = export_final(env, art, 8, platforms=["cuda"],
                                kernels=True, data_parallel=2,
                                device="cuda")
        check(meta["nr_devices"] == 2 and meta["quant"] == "int8",
              f"the --data-parallel 2 artifact: {meta}")
        print(f"[dist] --data-parallel 2 --kernels W8A8 artifact: export "
              f"{time.perf_counter() - t0:.2f} s, {meta['bytes']} bytes, "
              f"traced at 4 rows a rank | {card}", flush=True)
        a = wait_dist_children(children_a, "phase 16 (a)")
        b = wait_dist_children(children_b, "phase 16 (b)")
    finally:
        for proc, log, _ in children_a + children_b:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    launches: dict = {}
    if a:
        launches = check_dist_a(a[0], card)
    return _scaled((1, launches), (1, check_dist_b(b, card)))


def check_dist_a(a: dict, card: str) -> dict:
    """Phase 16 (a)'s lines and checks -> the kernel calls it served."""
    print(f"[dist] (a) world of one: {a['info']}, backend {a['backend']}; "
          f"step losses {a['step_loss'][0]!r} {a['step_loss'][1]!r}, "
          f"bit-identical {a['step_bit_identical']} | {card}", flush=True)
    check(a["backend"] == "nccl" and a["info"]["process_count"] == 1,
          f"(a): {a['info']} on {a['backend']}")
    check(a["step_bit_identical"], "(a): the step in a world of one differs "
                                   "from the step without one")
    print(f"[dist] (a) W8A8 serve, 3 slabs of 8: kernel calls "
          f"{a['serve_calls']}; max|diff| from phase 3's answers "
          f"{a['serve_drift']:.3e} | {card}", flush=True)
    check(a["serve_drift"] == 0.0, "(a): served answers differ from phase 3")
    return a["serve_calls"]


def check_dist_b(b: list, card: str) -> dict:
    """Phase 16 (b)'s lines and checks over its ranks -> the kernel calls
    they served."""
    r0, r1 = b[:2]
    world = f"{r0['backend']}, {len(b)} ranks"
    check(all(r["info"]["process_count"] == len(b) for r in b),
          f"(b): not a world of {len(b)}")
    launches: dict = {}
    rel = abs(r0["dp_loss"] - r0["dp_ref_loss"]) / abs(r0["dp_ref_loss"])
    print(f"[dist] (b) {world}: data-parallel step, {TRAIN_B // len(b)} "
          f"images a rank x M = {TRAIN_M}: loss {r0['dp_loss']!r} vs one "
          f"process {r0['dp_ref_loss']!r} (rel {rel:.3e}, limit 1e-6); "
          f"parameters max|diff| {r0['dp_param_diff'][0]:.3e} where the "
          f"gradient is settled (limit 1e-6), {r0['dp_param_diff'][1]:.3e} "
          f"elsewhere (limit 2 lr); ranks bit-identical "
          f"{all(r['dp_ranks_bit_identical'] for r in b)}; kernel calls "
          f"rank 0 {r0['dp_calls']}, rank 1 {r1['dp_calls']}; warm ms a "
          f"step {r0['dp_ms']:.1f}, the one-process step in the same "
          f"arithmetic {r0['ref_ms']:.1f} | {card}", flush=True)
    check(rel <= 1e-6 and r0["dp_param_diff"][0] <= 1e-6,
          "(b): the data-parallel step differs from the one-process step")
    check(all(r["dp_ranks_bit_identical"] and r["dp_loss"] == r0["dp_loss"]
              for r in b), "(b): the ranks' parameters or losses differ")
    check(all(r["dp_calls"] == r0["dp_calls"] for r in b) and r0["dp_calls"],
          "(b): the ranks' teachers launched different kernels")
    rel = abs(r0["tp_loss"] - r0["tp_ref_loss"]) / abs(r0["tp_ref_loss"])
    print(f"[dist] (b) {world}: tensor-parallel step (model 2), mode "
          f"\"0\", B = {TP_B} x M = {TP_M}: loss {r0['tp_loss']!r} vs the "
          f"one-process plain step {r0['tp_ref_loss']!r} (rel {rel:.3e}, "
          f"limit 1e-6); "
          f"parameters max|diff| {r0['tp_param_diff'][0]:.3e} settled "
          f"(limit 1e-6), {r0['tp_param_diff'][1]:.3e} elsewhere; kernel "
          f"calls {r0['tp_calls']} | {card}", flush=True)
    check(rel <= 1e-6 and r0["tp_param_diff"][0] <= 1e-6,
          "(b): the tensor-parallel step differs from the plain step")
    check(not any(r["tp_calls"] for r in b),
          "(b): a kernel ran under tensor parallelism")
    for tag in ("live", "artifact"):
        slabs = r1[f"serve_{tag}_slabs"]
        per_slab = {k: v / slabs for k, v in r1[f"serve_{tag}_calls"].items()}
        print(f"[dist] (b) {world}: W8A8 serve {tag}, each slab of 8 "
              f"split over the ranks: rank 0 kernel calls "
              f"{r0[f'serve_{tag}_calls']} over 3 slabs; rank 1 "
              f"{r1[f'serve_{tag}_calls']} over {slabs} slabs ({per_slab} "
              f"a slab); max|diff| from phase 3's answers "
              f"{r0[f'serve_{tag}_drift']:.3e} (limit "
              f"{TOL_INT8['float32']}) | {card}", flush=True)
        check(per_slab == {k: float(v) for k, v in INT8_COUNTS.items()},
              f"(b) {tag}: rank 1's kernel calls a slab")
        check(r0[f"serve_{tag}_drift"] <= TOL_INT8["float32"],
              f"(b) {tag}: the sharded answers differ from phase 3's")
        launches = _scaled((1, launches),
                           *((1, r[f"serve_{tag}_calls"]) for r in b))
    check_dist_ckpt(b, card)
    return _scaled((1, launches), (1, check_dist_pp(b, card)))


def check_dist_pp(b: list, card: str) -> dict:
    """Phase 16's `[pp]` lines and checks over the ranks of (b) -> the
    kernel calls of the CLI's epoch (its teachers')."""
    world = f"{b[0]['backend']}, {len(b)} ranks"
    keys = [k for k in b[0] if k.startswith("pp ")]
    check(len(keys) >= 4, f"(b): the pipeline-parallel cases ran: {keys}")
    for key in keys:
        res = [r[key] for r in b]
        x = res[0]
        diff = abs(x["loss"] - x["ref_loss"])
        ranks_same = all(r["loss"] == x["loss"] for r in res)
        paths = sorted({h.split()[0] for r in res for h in r["hops"]})
        share = [round(r["bytes"][0] / x["ref_bytes"][0], 4) for r in res]
        stack = [r["bytes"][2] / x["ref_bytes"][2] for r in res]
        print(f"[pp] {world}: {key[3:]}: loss {x['loss']!r} vs one process "
              f"{x['ref_loss']!r} (|diff| {diff:.3e}, limit 1e-6 x "
              f"max(1, |loss|)); parameters max|diff| "
              f"{x['param_diff'][0]:.3e} where settled (limit 1e-6), "
              f"{x['param_diff'][1]:.3e} elsewhere (limit 2 lr); ranks' "
              f"losses equal {ranks_same}; parameter, moment and stack "
              f"bytes a rank {[r['bytes'] for r in res]} vs one process "
              f"{x['ref_bytes']} (parameter share a rank {share}, stack "
              f"share {[round(v, 4) for v in stack]}); hops a "
              f"rank {[r['hops'] for r in res]} over {paths}; kernel calls "
              f"a rank {[r['calls'] for r in res]} vs one process on the "
              f"same rows {x['ref_calls']}; warm ms a step {x['ms']:.1f} "
              f"vs one process {x['ref_ms']:.1f}; the check {x['s']:.1f} s "
              f"| {card}", flush=True)
        check(diff <= 1e-6 * max(1.0, abs(x["ref_loss"]))
              and x["param_diff"][0] <= 1e-6,
              f"(b) {key}: the pipelined step differs from one process")
        check(ranks_same, f"(b) {key}: the ranks' losses differ")
        # a data rank of two sweeps half the rows (the one process all),
        # so its calls are only printed
        check("dp2" in key or all(r["calls"] == x["ref_calls"] for r in res),
              f"(b) {key}: a rank's kernel calls are not the one-process "
              "step's on the same rows")
        check(all(r["hops"] and sum(r["hops"].values()) > 0 for r in res)
              and len(paths) == 1, f"(b) {key}: hops {paths}")
        # 1/P of the stack (pipe 2), less with tensor parallelism; the
        # moments twice the parameters: nothing of another stage is held
        check(all(v == 0.5 if "tp" not in key else v <= 0.5
                  for v in stack)
              and all(r["bytes"][1] == 2 * r["bytes"][0] for r in res),
              f"(b) {key}: a rank's stack share is {stack}")
    cli = [r["pp_cli"] for r in b]
    print(f"[pp] {world}: the random towers initialized in "
          f"{b[0]['pp_init_s']:.1f} s; the PP checks took "
          f"{b[0]['pp_s']:.1f} s | {card}", flush=True)
    print(f"[pp] {world}: train_explainer CLI, AUTOGNOTHI_PP=2, one epoch "
          f"(2 steps + 1 eval batch of {TRAIN_B} x M = {TRAIN_M}): "
          f"{cli[0]['s']:.1f} s; flat checkpoint {cli[0]['flat']} (loads "
          f"strictly; parameters moved up to {cli[0]['moved']:.3e}); kernel "
          f"calls a rank {[c['calls'] for c in cli]}; hops a rank "
          f"{[c['hops'] for c in cli]} | {card}", flush=True)
    check(cli[0]["flat"] and cli[0]["moved"] > 0,
          "(b): the PP train_explainer checkpoint is not the flat one")
    check(all(c["calls"] for c in cli),
          "(b): a rank's PP teacher launched no kernel")
    return _scaled(*((1, c["calls"]) for c in cli))


# ------------------------------------------- per-layer rematerialisation

REMAT_LOSS_TOL = 1e-6  # relative: the loss comes from the first forward


def remat_pair(tag: str, make_run, card: str, lower_peak: bool) -> None:
    """One train step without and with AUTOGNOTHI_REMAT=1, each on a fresh
    copy of the same parameters and dropout seed (`make_run()` -> run()
    -> loss): the allocator's peak over the first step, its loss, its
    kernel calls and the plain recomputes its backward ran, then ms a step
    (two warm steps).  Checked: the loss within REMAT_LOSS_TOL relative;
    with `lower_peak`, a lower peak with remat; the same plain recomputes
    (a kernel op's backward runs once either way); no fewer kernel calls,
    and more where the differentiated forward runs kernel ops (the
    checkpoint runs each layer again in the backward)."""
    import torch

    got = {}
    for flag in ("0", "1"):
        with mock.patch.dict(os.environ, {"AUTOGNOTHI_REMAT": flag}):
            run = make_run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts()
            before = recomputes()
            loss = float(run())
            torch.cuda.synchronize()
            calls = {k: v for k, v in read_counts().items() if v}
            peak = torch.cuda.max_memory_allocated()
            got[flag] = dict(loss=loss, calls=calls, peak=peak, base=base,
                             recomputes=recomputes() - before,
                             ms=warm_step_ms(run, reps=2))
            del run
            torch.cuda.empty_cache()
    off, on = got["0"], got["1"]
    rel = abs(on["loss"] - off["loss"]) / max(abs(off["loss"]), 1e-30)
    for flag, r in (("off", off), ("on", on)):
        print(f"[remat] {tag} AUTOGNOTHI_REMAT {flag}: peak "
              f"{r['peak'] / 2**20:.1f} MiB (above the "
              f"{r['base'] / 2**20:.1f} MiB held before the step: "
              f"{(r['peak'] - r['base']) / 2**20:.1f}), {r['ms']:.2f} ms a "
              f"step, loss {r['loss']!r}, kernel calls {r['calls']}, plain "
              f"recomputes {r['recomputes']} | {card}", flush=True)
    print(f"[remat] {tag}: loss |on - off| / |off| = {rel:.3e} (limit "
          f"{REMAT_LOSS_TOL:g}); peak on / off "
          f"{(on['peak'] - on['base']) / max(off['peak'] - off['base'], 1):.3f}"
          f" of the step's own; ms on / off {on['ms'] / off['ms']:.3f} | "
          f"{card}", flush=True)
    check(rel <= REMAT_LOSS_TOL, f"[remat] {tag}: loss moved by {rel:.3e}")
    if lower_peak:
        check(on["peak"] < off["peak"], f"[remat] {tag}: no lower peak")
    check(on["recomputes"] == off["recomputes"],
          f"[remat] {tag}: plain recomputes {off['recomputes']} -> "
          f"{on['recomputes']}")
    check(all(on["calls"].get(k, 0) >= v for k, v in off["calls"].items())
          and (off["recomputes"] == 0
               or sum(on["calls"].values()) > sum(off["calls"].values())),
          f"[remat] {tag}: the recompute launched no kernel: "
          f"{off['calls']} -> {on['calls']}")


def phase_remat(dev, card: str, case) -> None:
    """`[remat]`: per-layer rematerialisation (AUTOGNOTHI_REMAT=1) on the
    card.  A random vanilla ViT-L/16@224 surrogate step (its shipped
    `net.params`, dropout 0.1 included, all 24 layers, B = 8, every
    parameter trainable, random teacher rows: the differentiated forward
    is the plain math, whose activations autograd keeps, and the peak
    must fall) and phase 4's LTT ViT-B/16@224 explainer step at B = 8 x M
    = 32 (dropout 0: the W8A8 teacher, then the differentiated forward on
    K6, K7 and K5, whose ops keep only their inputs), each without and
    with the variable (`remat_pair`)."""
    import torch

    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.pipeline.config import parse_config
    from autognothi_tpu_torch.pipeline.resources import get_recipe
    from autognothi_tpu_torch.pipeline.train_surrogate import surrogate_loss
    from autognothi_tpu_torch.pipeline.training import AdamW, make_train_step

    hp = json.loads(TOWER_EXP["vit_large"].read_text())
    recipe, cfg = get_recipe(parse_config(hp))
    t0 = time.perf_counter()
    flat = recipe.init_classifier(cfg, torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = recipe.n_players(cfg)
    xs = torch.randn((TRAIN_B, 3, 224, 224), generator=gen, device=dev)
    mask = (torch.rand((TRAIN_B, n), generator=gen, device=dev)
            > 0.5).to(torch.int32)
    orig = torch.softmax(torch.randn((TRAIN_B, cfg.num_labels),
                                     generator=gen, device=dev), dim=-1)
    labels = torch.randint(0, cfg.num_labels, (TRAIN_B,), generator=gen,
                           device=dev)
    w = torch.ones((TRAIN_B,), device=dev)
    step = make_train_step(surrogate_loss(recipe, cfg, False))
    print(f"[remat] ViT-L/16@224 surrogate: "
          f"{sum(v.size for v in flat.values())} parameters, "
          f"{cfg.num_hidden_layers} layers, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def vit_large():
        model = from_jax_params(flat, cfg, dev, section="surrogate")
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        opt = AdamW(params, lambda k: True)
        ones = {k: 1.0 for k in params}
        drop = torch.Generator(device=dev).manual_seed(SEED)
        return lambda: step(model, opt, 5e-5, ones, xs, mask, orig, labels,
                            drop, None, w)[0]

    remat_pair(f"vanilla ViT-L/16@224 surrogate step B={TRAIN_B}, dropout "
               f"{cfg.hidden_dropout_prob}", vit_large, card, lower_peak=True)
    del flat, step
    torch.cuda.empty_cache()
    remat_pair(f"LTT ViT-B/16@224 explainer step B={TRAIN_B} x "
               f"M={TRAIN_M}", case.fresh, card, lower_peak=False)


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
    "ladder_attention": ("autognothi_tpu_torch/csrc/ladder_attention.cu",
                         "autognothi_tpu/ops/ladder_block.py:183"),
}
# no model calls the ladder attention op (as in the JAX package): it has no
# launches on a main path
NOT_ON_A_PATH = ("ladder_attention",)


def main_cards(cards: int) -> int:
    """`python3 chip_smoke.py --dist-cards N` on a host of N cards: phase
    1, phase 3's W8A8 serve, phase 4's experiment and phase 16 (b) with
    one NCCL rank per card (the CLI's initialisation), the world the JAX
    package's mesh tests model on one host."""
    import torch

    from autognothi_tpu_torch.utils.devices import resolve_device

    check(torch.cuda.device_count() >= cards,
          f"--dist-cards {cards}: {torch.cuda.device_count()} card(s)")
    dev = resolve_device("cuda:0")
    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name} x {torch.cuda.device_count()} | nvidia-smi: "
          f"{card} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        exp = write_experiment(tmp)
        _, _, got_int8 = phase_serve(dev, exp, int8=True)
        train_exp = write_train_experiment(tmp)
        t0 = time.perf_counter()
        phase_distributed(dev, tmp, card, exp, train_exp, got_int8,
                          cards=cards)
        print(f"[phase] 16 multi-device over {cards} cards: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dist-child"]:  # a rank of phase 16
        return dist_child(sys.argv[2])
    if sys.argv[1:2] == ["--dist-cards"]:  # phase 16 (b) over N cards
        return main_cards(int(sys.argv[2]))
    from autognothi_tpu_torch.utils.devices import resolve_device

    dev = resolve_device("cuda:0")
    name = torch.cuda.get_device_name(0)
    card = nvidia_smi_line()
    print(f"[device] {name} | nvidia-smi: {card} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | python {sys.version.split()[0]}",
          flush=True)
    phase_seconds = {}

    def timed(label, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        phase_seconds[label] = time.perf_counter() - t0
        print(f"[phase] {label}: {phase_seconds[label]:.1f} s", flush=True)
        return out

    timed("1 device and build", phase_device)
    worst = timed("2 kernels vs plain, ViT shapes", phase_kernels, dev)
    worst = timed("2 kernels vs plain, BERT shapes", phase_kernels, dev,
                  bert_op_cases, B_BERT_CHECK, worst, BERT_CALLS_PER_OP)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
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
        print(f"[phase] 3 serve LTT: {time.perf_counter() - t0:.1f} s",
              flush=True)
        # phase 15: the `--kernels` artifacts of these finals served from
        # their files, and the default artifact on the card and the CPU
        launches_export = timed(
            "15 export and serve --artifact", phase_export, dev,
            pathlib.Path(tmp), card, {"vit": exp, "bert": bert_exp},
            {"vit": service, "bert": bert_service},
            {"vit fp32": got_fp32, "vit int8": got_int8,
             "bert int8": got_bert_int8})
        train_exp = write_train_experiment(pathlib.Path(tmp))
        case = TrainCase(dev, train_exp)
        per_step = timed("4 train steps", phase_train_steps, case)
        launches_train = timed("4 train_explainer CLI", phase_train_cli,
                               train_exp, per_step)
        # phase 16: a world of one (NCCL) and two gloo ranks on the card
        launches_dist = timed("16 multi-device", phase_distributed, dev,
                              pathlib.Path(tmp), card, exp, train_exp,
                              got_int8)
        launches_all = timed("6 LTT ViT train_all", phase_train_all, dev,
                             pathlib.Path(tmp), per_step, card)
        launches_reports = timed("7 LTT ViT run_all", phase_run_all, dev,
                                 pathlib.Path(tmp), card)
        launches_bert_run_all = timed("8 LTT BERT run_all",
                                      phase_bert_run_all, dev,
                                      pathlib.Path(tmp), card)
        # phases 9 (ViT-B/16@224) and 10 (BERT-base@512): the vanilla and
        # froyo towers
        launches_towers: dict = {}
        for n, family in ((9, "vit"), (10, "bert")):
            for what, fn in (("serve vanilla", phase_tower_serve),
                             ("run_all vanilla", phase_tower_run_all),
                             ("train_all + serve froyo", phase_froyo)):
                launches_towers = _scaled(
                    (1, launches_towers),
                    (1, timed(f"{n} {what} {family}", fn, dev,
                              pathlib.Path(tmp), card, family)))
        # phases 11 (the duo towers of both families) and 12 (KernelSHAP
        # BERT-base@512)
        for family in ("vit", "bert"):
            launches_towers = _scaled(
                (1, launches_towers),
                (1, timed(f"11 duo {family}", phase_duo, dev,
                          pathlib.Path(tmp), card, family)))
        launches_towers = _scaled(
            (1, launches_towers),
            (1, timed("12 KernelSHAP BERT", phase_kernel_shap, dev,
                      pathlib.Path(tmp), card)))
        # phases 13 (the vanilla ViT-L/16@224) and 14 (the demos and the
        # other verbs, on phases 8's and 9's checkpoints)
        for label, fn in (("13 ViT-L vanilla", phase_vit_large),
                          ("14 demos and verbs", phase_demos)):
            launches_towers = _scaled(
                (1, launches_towers),
                (1, timed(label, fn, dev, pathlib.Path(tmp), card)))
        # per-layer rematerialisation: ViT-L's surrogate step and phase
        # 4's explainer step, with and without AUTOGNOTHI_REMAT=1
        timed("13 remat", phase_remat, dev, card, case)
        # every main path was driven from counts of 0: serve fp32 and int8
        # (ViT and BERT), train_explainer in pallas modes "2" and "1",
        # train_all's seven stages and its served final, run_all's stages
        # and six reports, faithfulness in W8A8 and in mode "1", for the
        # LTT ViT (phases 6, 7) and the LTT BERT (phase 8), the vanilla
        # and froyo towers' serves, run_all and train_all (phases 9, 10),
        # the duo towers' serves and run_all (11), KernelSHAP's serves and
        # faithfulness (12), the ViT-L final's serves, paths and image demo
        # (13), the text demo, the Shapley preview and pretrain_classifier
        # (14), and the served slabs of phase 16's ranks
        for k in launches:
            launches[k] += (launches_int8[k] + launches_bert[k]
                            + launches_bert_int8[k]
                            + launches_train.get(k, 0)
                            + launches_all.get(k, 0)
                            + launches_reports.get(k, 0)
                            + launches_bert_run_all.get(k, 0)
                            + launches_towers.get(k, 0)
                            + launches_export.get(k, 0)
                            + launches_dist.get(k, 0))
        per_op = timed("5 timing, ViT", phase_timing, dev, card, service)
        # the ViT shapes keep their rows; K8q and the bf16 float chain run
        # only at BERT's.  The four BERT forwards counted there are main
        # paths too (bf16 parameters drive the float chain)
        bert_rows, bert_calls = timed("5 timing, BERT", phase_bert_timing,
                                      dev, card, bert_service)
        for k, row in bert_rows.items():
            per_op.setdefault(k, row)
        for k, v in bert_calls.items():
            launches[k] += v
        for label, fn, args in (
                ("5 yardsticks", phase_yardsticks, (dev, card)),
                ("5 float GEMM", phase_float_gemm, (dev, card)),
                ("5 block launches", phase_block_launches, (dev, card)),
                ("6 ladder route", phase_ladder_route, (dev, card)),
                ("7 long and narrow", phase_long_and_narrow, (dev, card)),
                ("5 split chains", phase_split_chains, (dev, card)),
                ("5 K4 teacher", phase_k4_teacher, (dev, card)),
                ("2 K3 wide", phase_k3_wide, (dev, card)),
                ("5 int8 GEMM", phase_int8_gemm, (dev, card)),
                ("5 train timing", phase_train_timing, (case, card))):
            timed(label, fn, *args)
    phase_native()
    print(f"[phase] all phases: {sum(phase_seconds.values()):.1f} s of "
          f"timed phases", flush=True)
    print(f"[profile] {PROFILE_LOSSES['windows']} profiled sessions lost "
          f"device events and were profiled again; the most calls a kept "
          f"window needed ahead of it: {PROFILE_LOSSES['lead']}", flush=True)

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
