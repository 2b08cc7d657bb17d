"""The explainer train step, back to back: the program's
`make_explainer_train_step` with its `AdamW`, B images x M coalitions a
step, each step on images and coalitions of its own drawn from the seed
on the device (masks handed in through `masks=`).

Set-up builds one step with its models and optimizer state, and drives
it through its first `checked_steps` steps (they warm every shape); the
window takes the same object on.  End to end: `train_samples_per_s`,
the images of the steps run in the window over the window, ended by a
synchronisation after its last step.  Once the window has closed, the
reference follows the first steps from the same weights, images and
masks, and the comparison reads: each step's loss, the first step's
gradients as the optimizer received them (from its first moments after
one step), and the trained parameters' change over those steps (read
before the next step moves them).

The int8 teacher's rounding flips codes, and that moves the whole step
about as much as an explainer computed one precision lower would.  So
the explainer's stage is also checked alone: the program's teacher
(`make_teacher`, the call the step makes) gives the values of the
checked steps, the teacher's values are held to the reference teacher's
by themselves, and the reference explainer follows the steps on the
program's teacher values (the `expl_*` numbers)."""

from __future__ import annotations

import time

import torch

from .. import core, weights
from ..reference import train as ref_train
from ..reference.common import float32_matmuls

BETA1 = ref_train.BETAS[0]
# images a block of the reference teacher (B * M rows in float64 products)
REFERENCE_CHUNK = 4


class Feed:
    """Images and coalitions of step k, drawn from (seed, k) on the
    device."""

    def __init__(self, r: core.Run, b: int, m: int):
        self.r, self.b, self.m = r, b, m
        model = r.cell.model
        self.shape = (b, model["img_channels"], model["img_px_size"],
                      model["img_px_size"])
        self.players = (model["img_px_size"] // model["img_patch_size"]) ** 2

    def __call__(self, k: int):
        gen = torch.Generator(device=self.r.device).manual_seed(
            self.r.seed * 1000003 + k)
        pixels = torch.rand(self.shape, generator=gen, device=self.r.device)
        masks = ref_train.shapley_masks(gen, self.b, self.m, self.players,
                                        self.r.device)
        return pixels, masks


def teacher_bits(cell: core.Cell):
    """The teacher's arithmetic, read from the key the program reads: W8A8
    (8) unless the cell sets AUTOGNOTHI_INT8_TEACHER=0; the reference
    works its codes out again."""
    return None if cell.env().get("AUTOGNOTHI_INT8_TEACHER") == "0" else 8


def build(r: core.Run):
    """-> (srg params, explainer params, null, trainable names): the
    surrogate drawn from the seed, the explainer its trunk and branch-0
    ladder with a fresh explainer layer and head (as the pipeline's
    conversion builds it)."""
    ref = core.module("reference", r.cell.family)
    model = r.cell.model
    srg = weights.make(ref.param_specs(model, "surrogate"), r.seed, r.device)
    extra = [(n, s) for n, s in ref.param_specs(model, "explainer")
             if n not in srg] + [("surrogate_null", (1, model["num_labels"]))]
    fresh = weights.make(extra, r.seed + 1, r.device)
    null = fresh.pop("surrogate_null")
    exp = {n: srg[n] if n in srg else fresh[n]
           for n, _ in ref.param_specs(model, "explainer")}
    trainable = [n for n in exp if not n.startswith(ref.FROZEN)]
    return ref, srg, exp, null, trainable


def run(r: core.Run) -> dict:
    from torch.profiler import record_function

    from autognothi_tpu_torch.models.ltt_vit import LttViT, LttViTConfig
    from autognothi_tpu_torch.parallel.train_step import (
        make_explainer_train_step, make_teacher)
    from autognothi_tpu_torch.pipeline.training import AdamW
    from autognothi_tpu_torch.recipes.ltt_vit import ltt_vit_recipe

    if r.cell.family != "ltt_vit":
        raise ValueError("train_steps drives the LTT ViT explainer step")
    mix = r.cell.mix
    b, m, lr, checked = mix["batch"], mix["coalitions"], mix["lr"], \
        mix["checked_steps"]
    ref, srg_p, exp_p, null, trainable = build(r)
    cfg = LttViTConfig(**r.cell.model)
    recipe = ltt_vit_recipe()
    srg = LttViT(cfg, "surrogate").to(r.device)
    srg.load_state_dict(srg_p, strict=True)
    srg.requires_grad_(False)
    model = LttViT(cfg, "explainer").to(r.device)
    model.load_state_dict(exp_p, strict=True)
    keep = recipe.trainable(cfg, "explainer")
    for name, p in model.named_parameters():
        p.requires_grad_(keep(name))
    params = dict(model.named_parameters())
    if sorted(k for k in params if keep(k)) != sorted(trainable):
        raise RuntimeError("the program trains other parameters than the "
                           "benchmark's frozen-trunk rule names")
    opt = AdamW(params, keep)
    ones = {k: 1.0 for k in params}
    feed = Feed(r, b, m)
    step = make_explainer_train_step(recipe, cfg, feed.players, m)
    null_prog = null.clone()

    def one(k: int):
        pixels, masks = feed(k)
        return step(model, opt, srg, null_prog, pixels, None, lr, ones,
                    cfg.num_hidden_layers, masks=masks)

    # the checked steps: the window's own call and feed
    p0 = {k: params[k].detach().clone() for k in trainable}
    losses, grads = [], None
    for k in range(checked):
        losses.append(float(one(k)))
        if k == 0:
            grads = {n: opt.mu[n].detach() / (1 - BETA1) for n in trainable}
            grads = {n: g.clone() for n, g in grads.items()}
    p3 = {k: params[k].detach().clone() for k in trainable}
    r.sync()
    r.log(f"{checked} checked steps, losses {losses}; set-up "
          f"{r.setup_done():.2f} s")

    steps = 0
    with core.window(r) as w:
        while time.perf_counter() - w.t0 < r.seconds:
            with record_function("bench.step"):
                one(checked + steps)
            steps += 1
        r.sync()
    elapsed = w.seconds
    memory = core.memory_peak(r)
    # the program's teacher values of the checked steps: the step's own
    # teacher call on the same frozen surrogate, images and masks
    teach = make_teacher(recipe, cfg)
    with torch.no_grad():
        taught = [tuple(v.detach().clone() for v in teach(srg, *feed(k)))
                  for k in range(checked)]
    del one, step, opt, model, srg, params, teach
    if r.device.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    batches = [feed(k) for k in range(checked)]
    with float32_matmuls(False):
        want = ref_train.steps(ref, r.cell.model, srg_p, exp_p, trainable,
                               null, batches, lr, teacher_bits(r.cell),
                               REFERENCE_CHUNK)
        follow = ref_train.steps(ref, r.cell.model, srg_p, exp_p, trainable,
                                 null, batches, lr, None, REFERENCE_CHUNK,
                                 teacher=taught)
    got = {"losses": losses, "grads": grads, "p0": p0, "p3": p3,
           "teacher": taught}
    checks, worst = compare(got, want, follow, trainable,
                            r.cell.spec["limits"])
    r.log(f"reference over {checked} steps in "
          f"{time.perf_counter() - t0:.2f} s; losses {want['losses']}, "
          f"on the program's teacher values {follow['losses']}")
    return {
        "end_to_end": {"train_samples_per_s": steps * b / elapsed},
        "checks": checks, "attempted": steps + checked, "failed": 0,
        "memory_peak_bytes": memory,
        "layer": {"cell": r.cell, "window_s": elapsed, "trace": w.trace,
                  "steps": steps, "b": b, "m": m},
        "notes": [f"{steps} steps of {b} x {m} in {elapsed:.3f} s",
                  f"losses {losses}, reference {want['losses']}",
                  f"diagnostics: {worst}"],
    }


def compare(got: dict, want: dict, follow: dict, trainable,
            limits: dict) -> tuple:
    """-> (the checks, diagnostics).  `got`: the program's losses, first
    gradients, parameters before (p0) and after (p3) the checked steps and
    teacher values; `want`: the reference's steps; `follow`: the reference
    explainer's steps on the program's teacher values.

    Leaves count whose reference gradient is at least a thousandth of the
    median leaf's (the others move by round-off alone).  Against `want`:
    the worst step's loss gap (relative), the worst leaf's gap of
    first-gradient norms, and the median leaf's gap of parameter-change
    norms (AdamW moves every element by about lr whatever its gradient's
    size, so the worst leaf's change follows the signs of its near-zero
    gradient elements, which the int8 teacher's rounding flips).  The
    teacher alone: the widest gap of a teacher value (a probability).
    Against `follow`, where the teacher's rounding is the same on both
    sides: the same three numbers, `expl_*`, each by its worst leaf."""
    g_ref = want["grads"]
    norms = sorted(float(g_ref[k].norm()) for k in trainable)
    floor = 1e-3 * norms[len(norms) // 2]
    keep = [k for k in trainable if float(g_ref[k].norm()) >= floor]
    p0 = got["p0"]
    d_got = {k: got["p3"][k] - p0[k] for k in keep}
    values, worst = {}, {"leaves": f"{len(keep)} of {len(trainable)}"}
    for tag, ref in (("", want), ("expl_", follow)):
        d_ref = {k: ref["params"][k] - p0[k] for k in keep}
        values[tag + "loss_gap"] = max(
            abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
        values[tag + "grad_gap"], worst[tag + "grad"] = ref_train.leaf_gap(
            got["grads"], ref["grads"], keep)
        delta_worst, worst[tag + "delta"] = ref_train.leaf_gap(
            d_got, d_ref, keep)
        delta_median = ref_train.median_leaf_gap(d_got, d_ref, keep)
        worst[tag + "delta_worst_gap"] = delta_worst
        worst[tag + "delta_median_gap"] = delta_median
        values[tag + "delta_gap"] = delta_worst if tag else delta_median
        worst[tag + "grad_diff"] = ref_train.leaf_diff(
            got["grads"], ref["grads"], keep)
        worst[tag + "delta_diff"] = ref_train.leaf_diff(d_got, d_ref, keep)
    values["teacher_gap"] = max(
        float((a - b).abs().max())
        for pair_got, pair_ref in zip(got["teacher"], want["teacher"])
        for a, b in zip(pair_got, pair_ref))
    worst["readings"] = values
    return [{"name": k, "value": values[k], "limit": limits[k]}
            for k in sorted(limits)], worst
