"""GPipe pipeline parallelism over a ("data", "pipe") mesh (port of
`autognothi_tpu/parallel/pipeline.py`) on `torch.distributed`, one process
per device.

- The mesh: `make_pipe_mesh` is `parallel/mesh.py:make_mesh` with a
  "pipe" axis, ("data", "pipe") or ("data", "pipe", "model").  A rank is
  one (data, stage, model) cell; rank 0 is (0, 0, 0).
- The stage: `split_encoder_params` reads the flat parameter dict on the
  host and builds, on the rank's device, the section's module with only
  its stage's L/P encoder layers (under their global names
  `…encoder.layers.{i}.…`) and its part of the rest: the embeddings on
  the first stage, the final LayerNorm and the heads on the last.  So a
  rank holds 1/P of the depth and each tensor of the rest is owned by
  one stage, whose AdamW moves it alone.  With a "model" axis the stage's
  weights take the Megatron specs (`parallel/mesh.py:shard_params`) and
  its plain layers run the f/g pair (`parallel/tp.py`).
- The schedule (`pipelined_scan`): the rank's rows split into M
  microbatches; stage s runs microbatch m after receiving it from stage
  s - 1 and sends its output on, so stage s works on microbatch t - s at
  tick t of M + P - 1 (bubble (P - 1) / (M + P - 1)).  The last stage
  concatenates its outputs in microbatch order, which is the rank's row
  order.  The backward is all-forward-then-all-backward: every
  microbatch's activation is a leaf of its stage's graph, the last stage
  differentiates the loss once, and then for m = M - 1 .. 0 each stage
  takes its output's gradient (from the loss, or from stage s + 1),
  differentiates its layers, sums the weight gradients and sends the
  input's gradient to stage s - 1.  `_Pipe` wraps both halves in one
  autograd function, so the trainers' `torch.autograd.grad(loss, params)`
  runs the pipeline's backward: on a stage before the last the "loss" is
  the pipe's token, a 0-d tensor whose gradient is ignored.
- Hops: `hop_send` / `hop_recv` move an activation or gradient between
  stages, over the path `hop_path` picks by the backend (NCCL device to
  device; gloo on CPU tensors; gloo with CUDA tensors through pinned
  host memory, since gloo has no point-to-point for CUDA tensors).
  `HOPS` counts the calls by path.  A step makes 2 M (P - 1) hops in
  each (data, model) column: M sends forward and M back per stage
  boundary.
- Dropout: the sequential forwards draw from one generator; here a base
  seed is drawn from it once (every rank draws alike) and each use has a
  generator of its own, seeded from the base and the JAX package's fold
  tags: 10 the embeddings, 11 then (global microbatch, layer) the
  encoder, 20 + i the explainer layers, 29 the BERT explainer head's
  dropout, 30 the BERT pooler's.  The global microbatch id is data rank x
  M + m, so no two microbatches or data ranks share a mask.  Drawn only
  where dropout is active, so a dropout-free run leaves the generator as
  the sequential step does.
- Pins: the trainers run these forwards under `mesh_safe_pallas` and
  `quant_override("none")`; a world of several ranks is pallas mode
  "0", so a stage reaches no kernel op.
- Checkpoints stay flat dicts: `merge_encoder_params` gathers every
  stage (and every tensor-parallel shard) to the writer.
"""

from __future__ import annotations

import collections
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.common import (additive_mask_bias, dropout, layer_norm,
                             maybe_remat)
from .mesh import (_tree_map, axis_size, check_shardable, make_mesh,
                   param_pspec, shard_params)
from .tp import gather_shard

#: "<path> send" / "<path> recv" -> calls of `hop_send` / `hop_recv`
HOPS: collections.Counter = collections.Counter()


def pp_config_from_env() -> Optional[Tuple[int, int, int]]:
    """Opt-in trainer pipeline parallelism: AUTOGNOTHI_PP=P (>= 2) ->
    (P, microbatches, tp), AUTOGNOTHI_PP_MICROBATCHES the GPipe
    microbatch count (default P) and AUTOGNOTHI_PP_TP=T Megatron tensor
    parallelism inside each stage over a third "model" axis.  AUTOGNOTHI_PP
    unset, "0" or "1" -> None (the sequential trainer).  AUTOGNOTHI_PP_TP
    unset, "0" or "1" means no tensor parallelism, with or without
    AUTOGNOTHI_PP (the JAX package raises on "0" with AUTOGNOTHI_PP and
    takes it as off without); past 1 it needs AUTOGNOTHI_PP."""
    raw = os.environ.get("AUTOGNOTHI_PP", "").strip()
    tp_raw = os.environ.get("AUTOGNOTHI_PP_TP", "").strip()
    tp_off = tp_raw in ("", "0", "1")
    if raw in ("", "0", "1"):
        if not tp_off:
            # fail closed, don't silently train without the requested TP
            raise ValueError(
                f"AUTOGNOTHI_PP_TP={tp_raw} requires AUTOGNOTHI_PP>=2 — "
                "tensor parallelism composes inside the pipeline stages; "
                "for TP without PP use the trainer's Megatron path "
                "(parallel/mesh.py)")
        return None
    pipe = int(raw)
    mb = int(os.environ.get("AUTOGNOTHI_PP_MICROBATCHES", str(pipe)))
    tp = 1 if tp_off else int(tp_raw)
    if pipe < 2 or mb < 1 or tp < 1:
        raise ValueError(
            f"AUTOGNOTHI_PP={pipe} / AUTOGNOTHI_PP_MICROBATCHES={mb} / "
            f"AUTOGNOTHI_PP_TP={tp}: pipe must be >= 2, microbatches and "
            "tp >= 1")
    return pipe, mb, tp


def make_pipe_mesh(n_devices: Optional[int] = None, pipe: int = 2,
                   model: int = 1):
    """Mesh over ("data", "pipe"), or ("data", "pipe", "model") when
    model > 1, "model" innermost, over the world's ranks.  A world that
    does not divide pipe x model raises: in a world of one, pipe 2 does."""
    return make_mesh(n_devices, model_parallel=model, pipe=pipe)


def _coord(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def stage_of(mesh) -> Tuple[int, int]:
    """-> (this rank's stage, the number of stages)."""
    return _coord(mesh)["pipe"], axis_size(mesh, "pipe")


def peer(mesh, stage: int) -> int:
    """The global rank of this rank's (data, model) cell at `stage`."""
    coord = _coord(mesh)
    coord["pipe"] = stage
    return int(mesh.mesh[tuple(coord[n] for n in mesh.mesh_dim_names)])


# ------------------------------------------------------------------- hops


def hop_path(device: torch.device) -> str:
    """How a tensor on `device` crosses between stages, decided by the
    backend alone: "nccl" device to device; "gloo" for a CPU tensor;
    "gloo-host" for a CUDA tensor under gloo (which has no point-to-point
    for CUDA tensors: a pinned host buffer each way)."""
    if dist.get_backend() == "nccl":
        return "nccl"
    return "gloo-host" if device.type == "cuda" else "gloo"


def hop_send(t: torch.Tensor, dst: int) -> None:
    path = hop_path(t.device)
    HOPS[f"{path} send"] += 1
    if path == "gloo-host":
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        t = buf
    dist.send(t.contiguous(), dst)


def hop_recv(shape, dtype: torch.dtype, device: torch.device,
             src: int) -> torch.Tensor:
    path = hop_path(device)
    HOPS[f"{path} recv"] += 1
    if path == "gloo-host":
        buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        dist.recv(buf, src)
        return buf.to(device)
    out = torch.empty(shape, dtype=dtype, device=device)
    dist.recv(out, src)
    return out


def from_last_stage(mesh, value, device: torch.device):
    """The last stage's `value` (tensors in tuples, or None) on every
    stage of this rank's pipe group, on `device`: one
    `broadcast_object_list` of host copies.  The logged losses and rows,
    which only the last stage computes."""
    stage, n_pipe = stage_of(mesh)
    last = stage == n_pipe - 1
    box = [_tree_map(lambda t: t.detach().cpu()
                     if isinstance(t, torch.Tensor) else t, value)
           if last else None]
    dist.broadcast_object_list(box, src=peer(mesh, n_pipe - 1),
                               group=mesh.get_group("pipe"))
    if last:
        return value
    return _tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                     else t, box[0])


# --------------------------------------------------------------- dropout


def _mix(seed: int, *tags: int) -> int:
    """SplitMix64 of `seed` folded with each tag: a seed per use."""
    x = seed & 0xFFFFFFFFFFFFFFFF
    for tag in tags:
        x = (x + 0x9E3779B97F4A7C15 * (int(tag) + 1)) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 31
    return x & 0x7FFFFFFFFFFFFFFF


def fold(rng: Optional[int], *tags: int) -> Optional[int]:
    return None if rng is None else _mix(rng, *tags)


def generator(rng: Optional[int], device: torch.device
              ) -> Optional[torch.Generator]:
    """A generator on `device` seeded with `rng`, or None."""
    if rng is None:
        return None
    return torch.Generator(device=device).manual_seed(rng)


def dropout_base(cfg, generator_: Optional[torch.Generator],
                 deterministic: bool) -> Optional[int]:
    """The forward's base seed: one draw from the step's generator where
    dropout is active, else None (no draw)."""
    if deterministic or (cfg.attention_probs_dropout_prob == 0.0
                         and cfg.hidden_dropout_prob == 0.0):
        return None
    if generator_ is None:
        raise ValueError("dropout in train mode needs a generator")
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator_,
                             device=generator_.device).item())


# ---------------------------------------------------------- the schedule


class _Schedule:
    """One pipelined call on one rank: the forward's microbatch leaves
    and outputs, kept for the backward."""

    def __init__(self, body, params, side, mesh, microbatches, act_shape,
                 dtype, device, build):
        self.body, self.params, self.side = body, params, side
        self.mesh, self.m = mesh, microbatches
        self.act_shape, self.dtype, self.device = act_shape, dtype, device
        self.build = build
        self.stage, self.n_pipe = stage_of(mesh)
        self.data_rank = _coord(mesh).get("data", 0)
        self.xs: List[torch.Tensor] = []
        self.ys: List[torch.Tensor] = []

    def _rows(self, t: torch.Tensor, m: int, mb: int) -> torch.Tensor:
        return t[m * mb:(m + 1) * mb]

    def forward(self, h0: torch.Tensor, rows: int) -> torch.Tensor:
        first, last = self.stage == 0, self.stage == self.n_pipe - 1
        mb = rows // self.m
        shape = (mb, *self.act_shape)
        for m in range(self.m):
            if first:
                x = self._rows(h0, m, mb).detach()
                x.requires_grad_(self.build and h0.requires_grad)
            else:
                x = hop_recv(shape, self.dtype, self.device,
                             peer(self.mesh, self.stage - 1))
                x.requires_grad_(self.build)
            side = (None if self.side is None
                    else self._rows(self.side, m, mb))
            with torch.set_grad_enabled(self.build):
                y = self.body(x, side, self.data_rank * self.m + m)
            if not last:
                hop_send(y.detach(), peer(self.mesh, self.stage + 1))
            self.xs.append(x)
            self.ys.append(y)
        if last:
            return torch.cat([y.detach() for y in self.ys])
        return torch.zeros((), dtype=self.dtype, device=self.device)

    def backward(self, grad: torch.Tensor):
        first, last = self.stage == 0, self.stage == self.n_pipe - 1
        mb = self.xs[0].shape[0]
        sums: List[Optional[torch.Tensor]] = [None] * len(self.params)
        gx: List[Optional[torch.Tensor]] = [None] * self.m
        for m in reversed(range(self.m)):
            x, y = self.xs[m], self.ys[m]
            g = (self._rows(grad, m, mb) if last else
                 hop_recv(y.shape, y.dtype, self.device,
                          peer(self.mesh, self.stage + 1)))
            wants = list(self.params) + ([x] if x.requires_grad else [])
            got = torch.autograd.grad(y, wants, g, allow_unused=True)
            for i, gp in enumerate(got[:len(self.params)]):
                if gp is not None:
                    sums[i] = gp if sums[i] is None else sums[i] + gp
            if x.requires_grad:
                if first:
                    gx[m] = got[-1]
                else:
                    hop_send(got[-1], peer(self.mesh, self.stage - 1))
            self.xs[m] = self.ys[m] = None
        g_h0 = torch.cat(gx) if first and gx[0] is not None else None
        return g_h0, sums


class _Pipe(torch.autograd.Function):
    """The schedule as one autograd node of the rank's graph: inputs the
    first stage's activations and the stage's parameters that require
    grad; output the last stage's rows, or the token."""

    @staticmethod
    def forward(ctx, run: _Schedule, rows: int, h0: torch.Tensor, *params):
        ctx.run = run
        return run.forward(h0, rows)

    @staticmethod
    def backward(ctx, grad):
        g_h0, sums = ctx.run.backward(grad)
        ctx.run = None
        return (None, None, g_h0, *sums)


def pipelined_scan(stage_body: Callable, params: Sequence[torch.Tensor],
                   h0: Optional[torch.Tensor], side: Optional[torch.Tensor],
                   mesh, *, microbatches: int, n_layers: int, rows: int,
                   act_shape: Tuple[int, ...], dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """Run `y = stage_body(x, side_mb, global_mb)` (the stage's layers on
    one microbatch) through the GPipe schedule over the mesh's "pipe"
    axis.

    params: the tensors the body differentiates (the stage's parameters
    that require grad); h0: <rows, *act_shape> on the first stage (None
    elsewhere); side: per-row side inputs (a mask), sliced with the
    microbatch; rows: this rank's rows (its data shard); dtype and
    device: the activations' (the stage's parameters' device: a gloo mesh
    of CUDA tensors is a CPU mesh).  -> the last
    stage's <rows, *act_shape> outputs, equal to running all L layers in
    order, or a 0-d token on the other stages."""
    n_pipe = axis_size(mesh, "pipe")
    n_data = axis_size(mesh, "data")
    if n_layers % n_pipe != 0:
        raise ValueError(
            f"pipelined_scan: {n_layers} layers do not divide pipe={n_pipe} "
            "— pick a pipe that divides num_hidden_layers")
    if microbatches < 1 or rows % microbatches != 0:
        raise ValueError(
            f"pipelined_scan: batch {rows * n_data} does not divide "
            f"data={n_data} x microbatches={microbatches}")
    stage, _ = stage_of(mesh)
    if stage == 0:
        if h0 is None or h0.shape[0] != rows:
            raise ValueError("pipelined_scan: the first stage needs h0 "
                             f"<{rows}, ...>")
    else:
        h0 = torch.zeros((), dtype=dtype, device=device)
    build = torch.is_grad_enabled() and (
        h0.requires_grad or any(p.requires_grad for p in params))
    run = _Schedule(stage_body, list(params), side, mesh, microbatches,
                    tuple(act_shape), dtype, device, build)
    return _Pipe.apply(run, rows, h0, *params)


# ------------------------------------------------------- model adapters


def _stage_layers(layers, mesh, n_layers: int) -> List[Tuple[int, object]]:
    stage, n_pipe = stage_of(mesh)
    per = n_layers // n_pipe
    return [(i, layers[i]) for i in range(stage * per, (stage + 1) * per)]


def _stage_scanner(layers, cfg, deterministic: bool, rng: Optional[int],
                   device: torch.device) -> Callable:
    """The stage body: the stage's layers in order on one microbatch, each
    under `maybe_remat` with its dropout from the generator of (rng,
    global microbatch, layer)."""

    def body(x, side, global_mb):
        for i, layer in layers:
            gen = generator(fold(rng, global_mb, i), device)
            x = maybe_remat(layer, x, side, cfg, deterministic, gen,
                            generator=gen)
        return x

    return body


def _encoder(model_layers, cfg, h, side, mesh, *, microbatches: int,
             rows: int, t: int, dtype, deterministic: bool, rng):
    layers = _stage_layers(model_layers, mesh, cfg.num_hidden_layers)
    params = [p for _, layer in layers for p in layer.parameters()
              if p.requires_grad]
    device = next(layers[0][1].parameters()).device
    body = _stage_scanner(layers, cfg, deterministic, rng, device)
    return pipelined_scan(body, params, h, side, mesh,
                          microbatches=microbatches,
                          n_layers=cfg.num_hidden_layers, rows=rows,
                          act_shape=(t, cfg.hidden_size), dtype=dtype,
                          device=device)


def pipelined_vit_encoder(model, cfg, h, mask, mesh, *, microbatches: int,
                          rows: int, dtype, deterministic: bool = True,
                          rng: Optional[int] = None) -> torch.Tensor:
    """models/vit.vit_encoder over the stage's layers of `model` (a
    section with `vit.encoder.layers`); h on the first stage only; mask
    <rows, T> or None."""
    return _encoder(model.vit.encoder.layers, cfg, h, mask, mesh,
                    microbatches=microbatches, rows=rows,
                    t=cfg.n_patches + 1, dtype=dtype,
                    deterministic=deterministic, rng=rng)


def pipelined_bert_encoder(model, cfg, h, mask_bias, mesh, *,
                           microbatches: int, rows: int, t: int, dtype,
                           deterministic: bool = True,
                           rng: Optional[int] = None) -> torch.Tensor:
    """models/bert.bert_encoder over the stage's layers; mask_bias
    <rows, 1, 1, T>."""
    return _encoder(model.bert.encoder.layers, cfg, h, mask_bias, mesh,
                    microbatches=microbatches, rows=rows, t=t, dtype=dtype,
                    deterministic=deterministic, rng=rng)


def _is_first(mesh) -> bool:
    return stage_of(mesh)[0] == 0


def _is_last(mesh) -> bool:
    stage, n_pipe = stage_of(mesh)
    return stage == n_pipe - 1


def _vit_trunk(model, cfg, pixels, mask, mesh, microbatches,
               deterministic, rng):
    from ..models.vit import vit_embeddings

    h = None
    if _is_first(mesh):
        h = vit_embeddings(model.vit.embeddings, cfg, pixels,
                           deterministic=deterministic,
                           rng=generator(fold(rng, 10), pixels.device))
    out = pipelined_vit_encoder(
        model, cfg, h, mask, mesh, microbatches=microbatches,
        rows=pixels.shape[0], dtype=pixels.dtype,
        deterministic=deterministic, rng=fold(rng, 11))
    if not _is_last(mesh):
        return out
    ln = model.vit.layernorm
    return layer_norm(out, ln.weight, ln.bias, cfg.layer_norm_eps)


def pp_vit_classifier_fwd(model, cfg, pixels, mask, mesh, *,
                          microbatches: int, deterministic: bool = True,
                          rng: Optional[int] = None) -> torch.Tensor:
    """models/vit.vit_classifier_fwd with the encoder pipelined: the
    embeddings on the first stage, the final LayerNorm and the classifier
    on the last.  -> <rows, n_classes> softmax probabilities on the last
    stage, the token elsewhere.  `rng` is the base seed
    (`dropout_base`)."""
    from ..models.vit import _cls_probs

    h = _vit_trunk(model, cfg, pixels, mask, mesh, microbatches,
                   deterministic, rng)
    return _cls_probs(model.classifier, h) if _is_last(mesh) else h


def pp_vit_explainer_fwd(model, cfg, pixels, mask, grand, null, mesh, *,
                         microbatches: int, deterministic: bool = True,
                         rng: Optional[int] = None) -> torch.Tensor:
    """models/vit.vit_explainer_fwd with the backbone pipelined; the
    explainer layers (fold 20 + i) and MLP head on the last stage.
    -> <rows, n_classes, n_players> there, the token elsewhere."""
    from ..models.vit import explainer_mlp_head
    from ..ops.shapley import normalize_shapley_explanation

    h = _vit_trunk(model, cfg, pixels, mask, mesh, microbatches,
                   deterministic, rng)
    if not _is_last(mesh):
        return h
    device = pixels.device
    for i, layer in enumerate(model.explainer_attn):
        h = layer(h, mask, cfg, deterministic,
                  generator(fold(rng, 20 + i), device))
    out = explainer_mlp_head(model.explainer_mlp, h)
    if cfg.explainer_normalize:
        out = normalize_shapley_explanation(out, grand, null)
    return out[:, 1:, :].transpose(1, 2)


def _bert_trunk(model, cfg, input_ids, attention_mask, token_type_ids,
                mesh, microbatches, deterministic, rng, dtype):
    from ..models.bert import bert_embeddings

    h = None
    if _is_first(mesh):
        h = bert_embeddings(model.bert.embeddings, cfg, input_ids,
                            token_type_ids, deterministic=deterministic,
                            rng=generator(fold(rng, 10), input_ids.device))
    bias = additive_mask_bias(attention_mask, dtype)
    return pipelined_bert_encoder(
        model, cfg, h, bias, mesh, microbatches=microbatches,
        rows=input_ids.shape[0], t=input_ids.shape[1], dtype=dtype,
        deterministic=deterministic, rng=fold(rng, 11))


def _bert_dtype(model) -> torch.dtype:
    """The embeddings' dtype (the word table's, `bert_embeddings`): every
    stage holds parameters of the same dtype."""
    return next(model.parameters()).dtype


def pp_bert_classifier_fwd(model, cfg, input_ids, attention_mask,
                           token_type_ids, mesh, *, microbatches: int,
                           deterministic: bool = True,
                           rng: Optional[int] = None) -> torch.Tensor:
    """models/bert.bert_classifier_fwd with the encoder pipelined; the
    pooler (its dropout fold 30) and classifier on the last stage."""
    from ..models.bert import pooled_probs

    h = _bert_trunk(model, cfg, input_ids, attention_mask, token_type_ids,
                    mesh, microbatches, deterministic, rng,
                    _bert_dtype(model))
    if not _is_last(mesh):
        return h
    return pooled_probs(model.bert_pooler.dense, model.classifier, h, cfg,
                        deterministic, generator(fold(rng, 30),
                                                 input_ids.device))


def pp_bert_explainer_fwd(model, cfg, input_ids, attention_mask,
                          token_type_ids, grand, null, mesh, *,
                          microbatches: int, deterministic: bool = True,
                          rng: Optional[int] = None) -> torch.Tensor:
    """models/bert.bert_explainer_fwd with the encoder pipelined; the
    explainer layers (fold 20 + i), the head's dropout (29) and MLP on
    the last stage (no final LN: the BERT backbone ends at the
    encoder)."""
    from ..models.bert import bert_explainer_mlp
    from ..ops.shapley import normalize_shapley_explanation

    dtype = _bert_dtype(model)
    h = _bert_trunk(model, cfg, input_ids, attention_mask, token_type_ids,
                    mesh, microbatches, deterministic, rng, dtype)
    if not _is_last(mesh):
        return h
    device = input_ids.device
    bias = additive_mask_bias(attention_mask, h.dtype)
    for i, layer in enumerate(model.explainer_attn):
        h = layer(h, bias, cfg, deterministic,
                  generator(fold(rng, 20 + i), device))
    h = dropout(generator(fold(rng, 29), device), h,
                cfg.hidden_dropout_prob, deterministic)
    out = bert_explainer_mlp(model.explainer_mlp, h)
    if cfg.explainer_normalize:
        out = normalize_shapley_explanation(out, grand, null)
    return out[:, 1:, :].transpose(1, 2)


# ------------------------------------------------ stage-sharded parameters


class StageLayout:
    """Which stage owns each parameter of a section's flat dict: layer i
    of `prefix` stage i // (L / P), the embeddings the first stage, every
    other tensor (final LayerNorm, pooler, heads, explainer layers) the
    last.  Every rank holds the whole layout (names and shapes)."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]], prefix: str,
                 n_layers: int, n_pipe: int):
        self.shapes, self.prefix = shapes, prefix
        self.n_layers, self.n_pipe = n_layers, n_pipe
        self.embeddings = prefix.split(".")[0] + ".embeddings."

    def stage(self, name: str) -> int:
        if name.startswith(self.prefix + "."):
            layer = int(name[len(self.prefix) + 1:].split(".")[0])
            return layer // (self.n_layers // self.n_pipe)
        if name.startswith(self.embeddings):
            return 0
        return self.n_pipe - 1

    def names(self, stage: int) -> List[str]:
        return [k for k in self.shapes if self.stage(k) == stage]


def _check_stack(params, n_layers: int, prefix: str) -> List[str]:
    """Fail closed on a ragged layer stack -> layer 0's suffixes."""
    head = f"{prefix}.0."
    suffixes = [k[len(head):] for k in params if k.startswith(head)]
    if not suffixes:
        raise ValueError(f"split_encoder_params: no params under {prefix!r}")
    # every {prefix}.* key must be one of layer 0's suffixes at a layer
    # index < n_layers — anything else would vanish from the checkpoint
    expected = {f"{prefix}.{i}.{s}"
                for i in range(n_layers) for s in suffixes}
    stray = [k for k in params
             if k.startswith(f"{prefix}.") and k not in expected]
    if stray:
        raise ValueError(
            "split_encoder_params: keys under "
            f"{prefix!r} do not form a dense {n_layers}-layer stack of "
            f"layer 0's suffixes — refusing to silently drop: "
            + ", ".join(sorted(stray)[:8])
            + ("..." if len(stray) > 8 else ""))
    missing = [k for k in expected if k not in params]
    if missing:
        raise ValueError(
            "split_encoder_params: layer stack is missing "
            + ", ".join(sorted(missing)[:8])
            + ("..." if len(missing) > 8 else ""))
    return suffixes


def _prune(module: torch.nn.Module, keep: Callable[[str], bool],
           path: str = "") -> None:
    """Drop, in place, every submodule none of whose parameters `keep`
    takes; recurse into the mixed ones."""
    for name, child in list(module.named_children()):
        full = f"{path}{name}."
        names = [full + k for k, _ in child.named_parameters()]
        if not any(keep(k) for k in names):
            setattr(module, name, None)
        elif not all(keep(k) for k in names):
            _prune(child, keep, full)


def split_encoder_params(params: Dict[str, np.ndarray], n_layers: int, mesh,
                         prefix: str = "vit.encoder.layers", *, cfg,
                         section: str, device: torch.device
                         ) -> Tuple[torch.nn.Module, StageLayout]:
    """-> (this rank's stage module, the layout): the section's module
    built empty on the meta device, cut to the tensors its stage owns
    (`StageLayout`), then materialized on `device` from the host dict, so
    a rank's device holds 1/P of the depth.  Fails closed on a ragged or
    missing stack, on a dict that is not the section's, and, with a
    "model" axis past 1, on a dim that does not divide it (every
    offending weight at once, from the shapes, before anything is
    materialized); then the stage's weights take the Megatron specs."""
    from ..params import MODELS, _host_array

    _check_stack(params, n_layers, prefix)
    with torch.device("meta"):
        model = MODELS[type(cfg)](cfg, section)
    want = set(model.state_dict())
    if set(params) != want:
        raise ValueError(
            f"split_encoder_params: the dict is not a {section} of this "
            f"config (missing {sorted(want - set(params))[:8]}, extra "
            f"{sorted(set(params) - want)[:8]})")
    if axis_size(mesh, "model") > 1:
        check_shardable(((k, np.shape(v), param_pspec(k, np.ndim(v)))
                         for k, v in params.items()), mesh)
    layout = StageLayout({k: tuple(np.shape(v)) for k, v in params.items()},
                         prefix, n_layers, axis_size(mesh, "pipe"))
    stage, _ = stage_of(mesh)
    _prune(model, lambda k: layout.stage(k) == stage)
    model = model.to_empty(device=device)
    with torch.no_grad():
        for k, t in model.state_dict().items():
            t.copy_(torch.from_numpy(_host_array(params[k])))
    if axis_size(mesh, "model") > 1:
        shard_params(model, mesh)
    return model.eval(), layout


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().float().reshape(-1) for t in tensors])


def gather_to_writer(mesh, layout: StageLayout,
                     local: Dict[str, torch.Tensor], device: torch.device,
                     keep: Callable[[str], bool] = lambda k: True
                     ) -> Dict[str, np.ndarray]:
    """Every stage's tensors of the names `keep` takes (`local`: this
    rank's, by name, whole, on `device`) on the writer as a flat dict of
    fp32 numpy arrays; {} on the other ranks.  The stages of data rank 0 and model
    rank 0 each send one packed buffer (`hop_send`) to the writer, rank
    0.  Every rank calls it."""
    coord = _coord(mesh)
    if coord.get("data", 0) != 0 or coord.get("model", 0) != 0:
        return {}
    stage = coord["pipe"]
    if stage != 0:
        names = [k for k in layout.names(stage) if keep(k)]
        if names:
            hop_send(_pack([local[k] for k in names]), peer(mesh, 0))
        return {}
    out = {k: v.detach().float().cpu().numpy().copy()
           for k, v in local.items()}
    for s in range(1, layout.n_pipe):
        names = [k for k in layout.names(s) if keep(k)]
        if not names:
            continue
        sizes = [int(np.prod(layout.shapes[k])) for k in names]
        buf = hop_recv((sum(sizes),), torch.float32, device,
                       peer(mesh, s)).cpu()
        for k, part in zip(names, buf.split(sizes)):
            out[k] = part.reshape(layout.shapes[k]).numpy().copy()
    return out


def merge_encoder_params(model: torch.nn.Module, layout: StageLayout,
                         mesh) -> Dict[str, np.ndarray]:
    """Inverse of `split_encoder_params`: the flat dict of every stage on
    the writer (tensor-parallel shards gathered whole first), {} on the
    other ranks; the checkpoint format every consumer reads, so pipeline
    parallelism is invisible on disk.  Every rank calls it."""
    local = {k: gather_shard(p) for k, p in model.named_parameters()}
    device = next(model.parameters()).device
    return gather_to_writer(mesh, layout, local, device)


def make_pp_classifier_train_step(cfg, mesh, *, microbatches: int,
                                  lr: float = 1e-3) -> Callable:
    """-> step(model, opt, pixels, mask, labels) -> loss: the cross-entropy
    step of the pipelined ViT classifier (`model` the rank's stage, `opt`
    its `pipeline.training.AdamW`), each data rank on its rows, the
    gradients summed over "data", the loss from the last stage.  The
    differentiated forward pins pallas mode "0" and no quantization, as
    every trainer's does."""
    from ..models.common import quant_override
    from ..pipeline.training import make_train_step
    from .train_step import mesh_safe_pallas

    def loss_fn(model, pixels, mask, labels, weights):
        with mesh_safe_pallas(), quant_override("none"):
            probs = pp_vit_classifier_fwd(model, cfg, pixels, mask, mesh,
                                          microbatches=microbatches)
        if not _is_last(mesh):
            return probs, None
        logp = torch.log(torch.clamp(probs, min=1e-9))
        return -logp.gather(1, labels.long()[:, None]).mean(), None

    train = make_train_step(loss_fn, mesh, in_axes=(0, 0, 0, 0))

    def step(model, opt, pixels, mask, labels):
        ones = {k: 1.0 for k, _ in model.named_parameters()}
        loss, _ = train(model, opt, lr, ones, pixels, mask, labels, None)
        return from_last_stage(mesh, loss, pixels.device)

    return step
