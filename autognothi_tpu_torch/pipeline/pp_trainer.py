"""Opt-in pipeline-parallel trainers, AUTOGNOTHI_PP=P (port of
`autognothi_tpu/pipeline/pp_trainer.py`).

The three full-tower training stages of the vanilla tracks, the
classifier (with `unfreeze_all`, as `pretrain_classifier` runs it), the
surrogate and the explainer, run with the encoder stage-sharded over a
("data", "pipe") mesh (`parallel/pipeline.py`): each rank holds 1/P of the
depth and the AdamW moments of its own tensors only.  With
AUTOGNOTHI_PP_TP=T the mesh gains a "model" axis and each stage's layers
run Megatron tensor parallelism T ways.  The LTT, froyo, duo and
KernelSHAP recipes train heads against a frozen trunk and are refused.

Each `setup_pp_*` returns the stage's module and step and eval callables
with the sequential trainer's signatures, so the epoch loops stay the
same:
- the classifier and surrogate steps are `training.make_train_step` and
  `make_eval_step` over the pipe mesh (each data rank its rows, the
  gradients summed over "data"), on a loss that the last stage computes;
  the explainer step is `parallel/train_step.make_explainer_train_step`
  with the pipelined forward (`PPContext.fw_explainer`);
- every rank draws the masks from the same generator state, and the
  no-grad teachers run on every rank on its "data" rows, as the JAX
  package's do: the explainer's with its kernels on a mesh without a
  "model" axis past 1, the surrogate's in pallas mode "0";
- the loss and the rows the epoch loop logs come from the last stage
  (`from_last_stage`: one broadcast a step), so every rank logs the same.

Checkpoints stay flat dicts (`PPContext.to_flat` gathers the stages to
the writer), so resume, conversions, export and the JAX package read them
as they read a sequential run's; the optimizer state of
AUTOGNOTHI_CKPT_OPT=1 is gathered and restored the same way.  Dropout
draws per (layer, microbatch, data rank) generators, so a dropout > 0 run
is statistically equivalent to the sequential trainer, not bit-identical.
"""

from __future__ import annotations

import types
from typing import Callable, Dict

import numpy as np
import torch

from ..models.common import quant_override
from ..parallel.distributed import is_writer
from ..parallel.mesh import axis_size, shard_params
from ..parallel.pipeline import (dropout_base, from_last_stage,
                                 gather_to_writer, make_pipe_mesh,
                                 merge_encoder_params, pp_bert_classifier_fwd,
                                 pp_bert_explainer_fwd, pp_vit_classifier_fwd,
                                 pp_vit_explainer_fwd, split_encoder_params,
                                 stage_of)
from ..parallel.tp import gather_shard, tp_shard
from ..parallel.train_step import (make_explainer_eval_step,
                                   make_explainer_train_step,
                                   mesh_safe_pallas)
from .resources import maybe_restore_opt_state, opt_ckpt_enabled
from .training import (AdamW, cross_entropy_on_probs, make_eval_step,
                       make_train_step)


class PPContext:
    """The rank's share of a pipeline-parallel trainer: the mesh, its
    stage's module (`model`) and AdamW (`opt`), the pipelined forward
    (`fwd`), and the gathers and broadcasts around them."""

    def __init__(self, mesh, model, layout, trainable, fwd):
        self.mesh, self.model, self.layout = mesh, model, layout
        self.trainable, self.fwd = trainable, fwd
        stage, n_pipe = stage_of(mesh)
        self.last = stage == n_pipe - 1
        self.device = next(model.parameters()).device
        params = dict(model.named_parameters())
        self.opt = AdamW(params, trainable)

    def fw_explainer(self, model, xs, mask, grand, null, **kw):
        """`recipe.fw_explainer`'s call: -> (attributions on the last
        stage, the token elsewhere; None)."""
        return self.fwd(model, xs, mask, grand, null, **kw), None

    def finish(self, value):
        return from_last_stage(self.mesh, value, self.device)

    def finishing(self, fn: Callable) -> Callable:
        """`fn` whose result every stage takes from the last one."""
        return lambda *args: self.finish(fn(*args))

    def to_flat(self, model) -> Dict[str, np.ndarray]:
        """The whole flat dict on the writer, {} elsewhere."""
        return merge_encoder_params(model, self.layout, self.mesh)

    def opt_for_ckpt(self, opt: AdamW):
        """With AUTOGNOTHI_CKPT_OPT=1, the whole optimizer state (named
        moments gathered to the writer, as `save_opt_state` writes it) on
        the writer; None elsewhere or when off.  Every rank calls it."""
        if not opt_ckpt_enabled():
            return None
        params = dict(self.model.named_parameters())
        moments = {}
        for m, store in (("mu", opt.mu), ("nu", opt.nu)):
            local = {k: gather_shard(store[k], of=params[k])
                     for k in opt.names}
            moments[m] = gather_to_writer(self.mesh, self.layout, local,
                                          self.device, keep=self.trainable)
        if not is_writer():
            return None
        return types.SimpleNamespace(
            names=sorted(moments["mu"]), count=opt.count,
            **{m: {k: torch.from_numpy(v) for k, v in d.items()}
               for m, d in moments.items()})

    def restore_opt(self, path, section: str, epoch: int,
                    opt: AdamW) -> AdamW:
        """`maybe_restore_opt_state` of the whole file into the stage's
        moments (a tensor-parallel moment takes its shard)."""
        params = dict(self.model.named_parameters())

        def take(k: str, arr: np.ndarray) -> np.ndarray:
            shard = tp_shard(params[k])
            if shard is None:
                return arr
            size = shard.full // shard.size
            return np.take(arr, range(shard.index * size,
                                      (shard.index + 1) * size),
                           axis=shard.dim)

        names = [k for k in self.layout.shapes if self.trainable(k)]
        return maybe_restore_opt_state(path, section, epoch, opt,
                                       names=names, take=take)


def _pp_context(env, config, m_config, params, trainable, pipe: int,
                microbatches: int, batch_size: int, *, section: str,
                device: torch.device, fwd_kind: str = "classifier",
                tp: int = 1) -> PPContext:
    kind = config.net.kind
    if kind not in ("vanilla_vit", "vanilla_bert"):
        raise ValueError(
            f"AUTOGNOTHI_PP: unsupported net kind {kind!r} — pipeline "
            "parallelism covers the vanilla tracks; the other recipes train "
            "heads against a frozen trunk and have no depth-proportional "
            "optimizer state to stage-shard")
    n_layers = m_config.num_hidden_layers
    if n_layers % pipe != 0:
        raise ValueError(
            f"AUTOGNOTHI_PP={pipe} does not divide "
            f"num_hidden_layers={n_layers}")
    mesh = make_pipe_mesh(pipe=pipe, model=tp)
    n_data = axis_size(mesh, "data")
    if batch_size % (n_data * microbatches) != 0:
        raise ValueError(
            f"AUTOGNOTHI_PP: batch_size={batch_size} does not divide "
            f"data={n_data} x microbatches={microbatches} — pad_batch pads "
            "every batch to batch_size, the one shape the GPipe schedule "
            "sees")
    track = "vit" if kind == "vanilla_vit" else "bert"
    prefix = f"{track}.encoder.layers"
    env.log(f"[[[ pipeline-parallel: {n_data} data x {pipe} pipe"
            + (f" x {tp} model" if tp > 1 else "") + ", "
            f"{microbatches} microbatches, {n_layers // pipe} layers/stage ]]]")
    model, layout = split_encoder_params(params, n_layers, mesh, prefix,
                                         cfg=m_config, section=section,
                                         device=device)
    suffixes = {k.split(".", 4)[4] for k in layout.shapes
                if k.startswith(prefix + ".")}
    for s in sorted(suffixes):
        labels = {trainable(f"{prefix}.{i}.{s}") for i in range(n_layers)}
        if len(labels) != 1:
            raise ValueError(
                f"AUTOGNOTHI_PP: trainability differs across layers for "
                f"{prefix}.*.{s} — a stage-sharded stack carries ONE "
                "optimizer label per weight")
    # every stage must enter the pipeline's backward, or none: a stage
    # waiting for a gradient that the next one never sends would hang
    depth = {trainable(k) for k in layout.shapes if layout.stage(k) == 0
             or k.startswith(prefix + ".")}
    if len(depth) != 1:
        raise ValueError(
            "AUTOGNOTHI_PP: trainability differs between the embeddings and "
            "the encoder layers — the stages must all run the backward or "
            "none")
    for name, p in model.named_parameters():
        p.requires_grad_(trainable(name))

    def base(rng, deterministic):
        return dropout_base(m_config, rng, deterministic)

    if kind == "vanilla_vit":
        from ..recipes.vanilla_vit import fw_xs_preprocess

        def classifier(model, xs, mask, *, deterministic=True, rng=None):
            xs, mask = fw_xs_preprocess(xs, mask)
            return pp_vit_classifier_fwd(
                model, m_config, xs, mask, mesh, microbatches=microbatches,
                deterministic=deterministic, rng=base(rng, deterministic))

        def explainer(model, xs, mask, grand, null, *, deterministic=True,
                      rng=None):
            xs, mask = fw_xs_preprocess(xs, mask)
            return pp_vit_explainer_fwd(
                model, m_config, xs, mask, grand, null, mesh,
                microbatches=microbatches, deterministic=deterministic,
                rng=base(rng, deterministic))
    else:
        from ..recipes.vanilla_bert import fw_xs_preprocess

        def classifier(model, xs, mask, *, deterministic=True, rng=None):
            ids, mask, ttype = fw_xs_preprocess(xs, mask)
            return pp_bert_classifier_fwd(
                model, m_config, ids, mask, ttype, mesh,
                microbatches=microbatches, deterministic=deterministic,
                rng=base(rng, deterministic))

        def explainer(model, xs, mask, grand, null, *, deterministic=True,
                      rng=None):
            ids, mask, ttype = fw_xs_preprocess(xs, mask)
            return pp_bert_explainer_fwd(
                model, m_config, ids, mask, ttype, grand, null, mesh,
                microbatches=microbatches, deterministic=deterministic,
                rng=base(rng, deterministic))

    fwd = classifier if fwd_kind == "classifier" else explainer
    return PPContext(mesh, model, layout, trainable, fwd)


def setup_pp_classifier(env, config, m_config, params, trainable, pipe: int,
                        microbatches: int, tp: int = 1, *,
                        device: torch.device):
    """-> (ctx, step, eval_fwd) with the sequential train_classifier's
    step(model, opt, lr, update_mask, xs, mask, labels, generator,
    ltt_active, weights) and eval(xs, mask, labels, ltt_active, weights)
    -> (loss, probs)."""
    ctx = _pp_context(env, config, m_config, params, trainable, pipe,
                      microbatches, config.train_classifier.batch_size,
                      section="classifier", device=device, tp=tp)

    def probs_loss(probs, labels, weights):
        if not ctx.last:
            return probs, None  # the token; no loss before the last stage
        return cross_entropy_on_probs(probs, labels, weights), probs

    def loss_fn(model, xs, mask, labels, generator, ltt_active, weights):
        # the trainer discipline: quant and pallas pinned off
        with mesh_safe_pallas(), quant_override("none"):
            probs = ctx.fwd(model, xs, mask, deterministic=False,
                            rng=generator)
        return probs_loss(probs, labels, weights)

    def eval_loss(xs, mask, labels, ltt_active, weights):
        with mesh_safe_pallas(), quant_override("none"):
            probs = ctx.fwd(ctx.model, xs, mask)
        return probs_loss(probs, labels, weights)

    step = make_train_step(loss_fn, ctx.mesh,
                           in_axes=(0, 0, 0, None, None, 0))
    evals = make_eval_step(eval_loss, ctx.mesh, in_axes=(0, 0, 0, None, 0))
    return ctx, ctx.finishing(step), ctx.finishing(evals)


def setup_pp_surrogate(env, config, m_config, params, cls_model, trainable,
                       pipe: int, microbatches: int, tp: int = 1, *,
                       device: torch.device):
    """-> (ctx, cls_model, step, eval_fwd) with the sequential
    train_surrogate's signatures.  The frozen teacher stays the trainer's
    own (`surrogate_teacher` over the pipe mesh's "data" rows);
    `cls_model` comes back Megatron-sharded over "model" when tp > 1."""
    from ..ops.shapley import loss_logits_kl_divergence

    ctx = _pp_context(env, config, m_config, params, trainable, pipe,
                      microbatches, config.train_surrogate.batch_size,
                      section="surrogate", device=device, tp=tp)
    if tp > 1:
        shard_params(cls_model, ctx.mesh)

    def losses(adapt_ys, orig_ys, labels, weights):
        if not ctx.last:
            return adapt_ys, (None, None)
        kld = loss_logits_kl_divergence(orig_ys, adapt_ys, weights)
        return kld, (cross_entropy_on_probs(adapt_ys, labels, weights),
                     adapt_ys)

    def loss_fn(model, xs, mask, orig_ys, labels, generator, ltt_active,
                weights):
        with mesh_safe_pallas(), quant_override("none"):
            adapt_ys = ctx.fwd(model, xs, mask, deterministic=False,
                               rng=generator)
        return losses(adapt_ys, orig_ys, labels, weights)

    def eval_loss(xs, mask, orig_ys, labels, ltt_active, weights):
        with mesh_safe_pallas(), quant_override("none"):
            adapt_ys = ctx.fwd(ctx.model, xs, mask)
        kld, (cls, adapt_ys) = losses(adapt_ys, orig_ys, labels, weights)
        return kld, cls, adapt_ys

    step = make_train_step(loss_fn, ctx.mesh,
                           in_axes=(0, 0, 0, 0, None, None, 0))
    evals = make_eval_step(eval_loss, ctx.mesh,
                           in_axes=(0, 0, 0, 0, None, 0))
    return ctx, cls_model, ctx.finishing(step), ctx.finishing(evals)


def setup_pp_explainer(env, config, m_config, params, srg_model, recipe,
                       pipe: int, microbatches: int, tp: int = 1, *,
                       device: torch.device):
    """-> (ctx, srg_model, step, eval_step) with
    `make_explainer_{train,eval}_step`'s signatures: the masks drawn for
    the global batch on every rank, the teacher on the rank's "data" rows
    (its kernels unless tp > 1, when its weights are Megatron-sharded and
    it runs mode "0"), the pipelined forward and backward, the gradients
    summed over "data", AdamW over the stage's tensors, the loss from the
    last stage.  `ltt_active` is accepted and ignored (vanilla recipes
    have no ladder)."""
    ctx = _pp_context(env, config, m_config, params,
                      recipe.trainable(m_config, "explainer"), pipe,
                      microbatches, config.train_explainer.batch_size,
                      section="explainer", device=device,
                      fwd_kind="explainer", tp=tp)
    if tp > 1:
        shard_params(srg_model, ctx.mesh)
    n_players = recipe.n_players(m_config)
    n_mask_samples = config.train_explainer.n_mask_samples
    step = make_explainer_train_step(recipe, m_config, n_players,
                                     n_mask_samples, mesh=ctx.mesh, pp=ctx)
    eval_step = make_explainer_eval_step(recipe, m_config, n_players,
                                         n_mask_samples, mesh=ctx.mesh,
                                         pp=ctx)
    return ctx, srg_model, step, eval_step
