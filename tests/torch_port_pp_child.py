"""One rank of the port's pipeline-parallel CPU tests (gloo), started by
tests/test_torch_port_pipeline.py and tests/test_torch_port_pp_train.py
through `tests.test_torch_port_scaleout.run_world` as
`python -m tests.torch_port_pp_child <spec.json>`.  It imports torch and
the port, never JAX.

Jobs:
- "modules": in a world of 4, the pipelined encoders, forwards, gradients,
  dropout, memory, hops, pins and fail-closed refusals of
  `parallel/pipeline.py` over (data 2 x pipe 2), (data 1 x pipe 4) and
  (data 1 x pipe 2 x model 2) meshes, on the parent's numpy inputs;
- "steps": in a world of 4, one explainer step of `pp_trainer.
  setup_pp_explainer` (tp 1 over data 2 x pipe 2; tp 2 over pipe 2 x
  model 2) on the parent's parameters and masks, with the teacher's
  arithmetic spied;
- "surrogate_step": in a world of 4, one step of `pp_trainer.
  setup_pp_surrogate` over (data 2 x pipe 2) on the parent's inputs;
- "teacher": on a (data 1 x pipe = the world) mesh, the explainer step's
  teacher calls of the kernel ops (`dispatch` spied) and its pallas mode;
- "remat": in a world of 2, a pipeline (data 1 x pipe 2) surrogate step
  and a tensor-parallel (model 2) explainer step of the mini vanilla ViT,
  each without and with AUTOGNOTHI_REMAT=1 from the same parameters and
  dropout seed;
- "ckpt_dir": in a world of 2, directory checkpoints
  (AUTOGNOTHI_CKPT_BACKEND=orbax) of a tensor-parallel (model 2) module
  with its optimizer moments, and of a pipeline (pipe 2) stage, each rank
  writing its share, beside the npz of the same parameters, and the
  retention of an earlier epoch's directory;
- "trainers": in a world of 2, the port's classifier, surrogate and
  explainer trainers under AUTOGNOTHI_PP on the parent's experiments (a
  run's "hparams" written first), an epoch interrupted where the spec
  says (SIGTERM on one rank only).
Each rank writes `<out>/rank<r>.npz` and `<out>/rank<r>.json`.
"""

import contextlib
import json
import os
import pathlib
import sys
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from tests.torch_port_dist_child import counting

CPU = torch.device("cpu")


def _load(inputs, prefix: str) -> dict:
    return {k[len(prefix):]: inputs[k] for k in inputs.files
            if k.startswith(prefix)}


def _cfg(spec, name):
    from autognothi_tpu_torch.models.bert import VanillaBertConfig
    from autognothi_tpu_torch.models.vit import VanillaViTConfig

    cls = VanillaViTConfig if name.startswith("vit") else VanillaBertConfig
    return cls(**spec["cfgs"][name])


def _coord(mesh):
    from autognothi_tpu_torch.parallel.pipeline import _coord

    return _coord(mesh)


def _rows(mesh, b):
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    d = _coord(mesh)["data"]
    return slice(d * (b // n), (d + 1) * (b // n))


def _stage(flat, cfg, mesh, section, prefix="vit.encoder.layers"):
    from autognothi_tpu_torch.parallel.pipeline import split_encoder_params

    model, layout = split_encoder_params(flat, cfg.num_hidden_layers, mesh,
                                         prefix, cfg=cfg, section=section,
                                         device=CPU)
    return model, layout


def _key(mesh, name):
    c = _coord(mesh)
    return f"{name}/d{c['data']}m{c.get('model', 0)}"


def _last(mesh):
    from autognothi_tpu_torch.parallel.pipeline import _is_last

    return _is_last(mesh)


def run_modules(spec, inputs, out) -> None:
    from autognothi_tpu_torch.models.common import pallas_override
    from autognothi_tpu_torch.parallel.pipeline import (
        HOPS, make_pipe_mesh, make_pp_classifier_train_step,
        pipelined_bert_encoder, pipelined_vit_encoder,
        pp_bert_classifier_fwd, pp_bert_explainer_fwd, pp_vit_classifier_fwd,
        pp_vit_explainer_fwd, stage_of)
    from autognothi_tpu_torch.pipeline.training import AdamW

    js, npz = out["json"], out["npz"]
    meshes = {"p2": make_pipe_mesh(pipe=2), "p4": make_pipe_mesh(pipe=4),
              "tp": make_pipe_mesh(pipe=2, model=2)}
    vit, bert = _cfg(spec, "vit"), _cfg(spec, "bert")
    cls_flat = _load(inputs, "vit/cls/")
    exp_flat = _load(inputs, "vit/exp/")
    pixels = torch.from_numpy(inputs["pixels"])
    mask = torch.from_numpy(inputs["mask"])
    ones = torch.ones((8, vit.n_patches + 1))
    h0 = torch.from_numpy(inputs["h0"])
    probe = torch.from_numpy(inputs["probe"])
    grand = torch.from_numpy(inputs["grand"])
    null = torch.from_numpy(inputs["null"])

    def put(mesh, name, t):
        if _last(mesh) and isinstance(t, torch.Tensor) and t.dim():
            npz[_key(mesh, name)] = t.detach().numpy()

    with pallas_override("0"):
        # the encoder with and without its mask, two layouts
        for tag in ("p2", "p4"):
            mesh = meshes[tag]
            model, _ = _stage(cls_flat, vit, mesh, "classifier")
            rows = _rows(mesh, 8)
            first = stage_of(mesh)[0] == 0
            for what, m in (("mask", mask), ("nomask", None)):
                with torch.no_grad():
                    y = pipelined_vit_encoder(
                        model, vit, h0[rows] if first else None,
                        None if m is None else m[rows], mesh,
                        microbatches=2, rows=8 // _n(mesh, "data"),
                        dtype=torch.float32)
                put(mesh, f"enc_{what}/{tag}", y)
            # gradients of a probe through the pipe: h0 and the layers
            x = h0[rows].clone().requires_grad_(first)
            for p in model.parameters():
                p.requires_grad_(True)
            y = pipelined_vit_encoder(model, vit, x if first else None,
                                      mask[rows], mesh, microbatches=2,
                                      rows=8 // _n(mesh, "data"),
                                      dtype=torch.float32)
            loss = (y * probe[rows]).sum() if _last(mesh) else y
            names = [k for k, _ in model.vit.named_parameters(
                prefix="vit") if ".encoder.layers." in k]
            params = dict(model.named_parameters())
            wants = [params[k] for k in names] + ([x] if first else [])
            got = torch.autograd.grad(loss, wants, allow_unused=True)
            for k, g in zip(names, got):
                dist.all_reduce(g, group=mesh.get_group("data"))
                if _coord(mesh)["data"] == 0:
                    npz[f"grad/{tag}/{k}"] = g.numpy()
            if first:
                npz[_key(mesh, f"grad_h0/{tag}")] = got[-1].numpy()
            # the classifier and explainer forwards
            with torch.no_grad():
                put(mesh, f"cls/{tag}", pp_vit_classifier_fwd(
                    model, vit, pixels[rows], ones[rows], mesh,
                    microbatches=2))
                emodel, _ = _stage(exp_flat, vit, mesh, "explainer")
                put(mesh, f"exp/{tag}", pp_vit_explainer_fwd(
                    emodel, vit, pixels[rows], ones[rows], grand[rows], null,
                    mesh, microbatches=2))
        # the text track: encoder, classifier and explainer forwards
        bert_cls = _load(inputs, "bert/cls/")
        bert_exp = _load(inputs, "bert/exp/")
        ids = torch.from_numpy(inputs["ids"])
        attn = torch.ones_like(ids)
        ttype = torch.zeros_like(ids)
        bias = torch.from_numpy(inputs["bert_bias"])
        bh0 = torch.from_numpy(inputs["bert_h0"])
        for tag in ("p2", "p4", "tp"):
            mesh = meshes[tag]
            rows = _rows(mesh, 8)
            first = stage_of(mesh)[0] == 0
            model, _ = _stage(bert_cls, bert, mesh, "classifier",
                              "bert.encoder.layers")
            with torch.no_grad():
                put(mesh, f"bert_enc/{tag}", pipelined_bert_encoder(
                    model, bert, bh0[rows] if first else None, bias[rows],
                    mesh, microbatches=2, rows=8 // _n(mesh, "data"),
                    t=ids.shape[1], dtype=torch.float32))
                put(mesh, f"bert_cls/{tag}", pp_bert_classifier_fwd(
                    model, bert, ids[rows], attn[rows], ttype[rows], mesh,
                    microbatches=2))
                emodel, _ = _stage(bert_exp, bert, mesh, "explainer",
                                   "bert.encoder.layers")
                put(mesh, f"bert_exp/{tag}", pp_bert_explainer_fwd(
                    emodel, bert, ids[rows], attn[rows], ttype[rows],
                    grand[rows, :bert.num_labels],
                    null[:, :bert.num_labels], mesh, microbatches=2))
        # tensor parallelism inside the stages: the ViT forwards
        mesh = meshes["tp"]
        model, _ = _stage(cls_flat, vit, mesh, "classifier")
        js["tp/query_shape"] = list(
            dict(model.named_parameters())[_first_query(mesh, vit)].shape)
        with torch.no_grad(), counting() as counts:
            put(mesh, "cls/tp", pp_vit_classifier_fwd(
                model, vit, pixels, ones, mesh, microbatches=2))
        js["tp/fwd_counts"] = dict(counts)
        emodel, _ = _stage(exp_flat, vit, mesh, "explainer")
        with torch.no_grad():
            put(mesh, "exp/tp", pp_vit_explainer_fwd(
                emodel, vit, pixels, ones, grand, null, mesh,
                microbatches=2))

    # dropout: iid across microbatches and data ranks, keyed, not stateful
    drop = _cfg(spec, "vit_dropout")
    mesh = meshes["p2"]
    model, _ = _stage(_load(inputs, "vit/cls/"), drop, mesh, "classifier")
    rows = _rows(mesh, 8)
    same = torch.from_numpy(np.repeat(inputs["h0"][:1], 8, axis=0))
    for i in range(2):
        with torch.no_grad(), pallas_override("0"):
            y = pipelined_vit_encoder(
                model, drop, same[rows] if stage_of(mesh)[0] == 0 else None,
                ones[rows], mesh, microbatches=2, rows=4,
                dtype=torch.float32, deterministic=False, rng=11)
        put(mesh, f"dropout/{i}", y)

    # the classifier train step: hops, pins, memory, one-process parity
    labels = torch.from_numpy(inputs["labels"])
    for tag in ("p2", "p4", "tp"):  # the step takes its rows itself
        mesh = meshes[tag]
        model, _ = _stage(cls_flat, vit, mesh, "classifier")
        for p in model.parameters():
            p.requires_grad_(True)
        opt = AdamW(dict(model.named_parameters()), lambda k: True)
        step = make_pp_classifier_train_step(vit, mesh, microbatches=2)
        HOPS.clear()
        with counting() as counts:
            losses = [step(model, opt, pixels, ones, labels).item()]
        js[f"step/{tag}/hops"] = dict(HOPS)
        js[f"step/{tag}/counts"] = dict(counts)
        for k, v in _merge(model, mesh, vit).items():
            npz[f"step/{tag}/{k}"] = v
        for _ in range(3):
            losses.append(step(model, opt, pixels, ones, labels).item())
        js[f"step/{tag}/losses"] = losses
    # the pins: AUTOGNOTHI_PALLAS=2 and AUTOGNOTHI_INT8=1 change nothing
    mesh = meshes["p2"]
    pinned = []
    for env in ({"AUTOGNOTHI_PALLAS": "0"},
                {"AUTOGNOTHI_PALLAS": "2", "AUTOGNOTHI_INT8": "1"}):
        model, _ = _stage(cls_flat, vit, mesh, "classifier")
        for p in model.parameters():
            p.requires_grad_(True)
        opt = AdamW(dict(model.named_parameters()), lambda k: True)
        step = make_pp_classifier_train_step(vit, mesh, microbatches=2)
        with mock.patch.dict(os.environ, env):
            pinned.append(step(model, opt, pixels, ones, labels).item())
    js["pins"] = pinned

    # memory: the 12-layer stack at pipe 2 and 4, weights and moments
    deep = _cfg(spec, "vit12")
    deep_flat = _load(inputs, "vit12/cls/")
    for tag in ("p2", "p4"):
        mesh = meshes[tag]
        model, _ = _stage(deep_flat, deep, mesh, "classifier")
        for p in model.parameters():
            p.requires_grad_(True)
        opt = AdamW(dict(model.named_parameters()), lambda k: True)
        step = make_pp_classifier_train_step(deep, mesh, microbatches=2)
        step(model, opt, pixels[:4], torch.ones((4, 5)), labels[:4])
        stack = sum(p.numel() * p.element_size()
                    for k, p in model.named_parameters()
                    if ".encoder.layers." in k)
        moments = sum(t.numel() * t.element_size()
                      for store in (opt.mu, opt.nu) for t in store.values())
        total = sum(p.numel() * p.element_size() for p in model.parameters())
        js[f"memory/{tag}/r{dist.get_rank()}"] = [stack, total, moments]

    # fail closed
    errors = {}
    model, _ = _stage(cls_flat, vit, meshes["p4"], "classifier")
    for name, call in (
            ("layers", lambda: _three_layers(meshes["p4"])),
            ("microbatches", lambda: pipelined_vit_encoder(
                model, vit, h0 if stage_of(meshes["p4"])[0] == 0 else None,
                mask, meshes["p4"], microbatches=3, rows=8,
                dtype=torch.float32)),
            ("mesh", lambda: make_pipe_mesh(pipe=3)),
            ("mesh_tp", lambda: make_pipe_mesh(pipe=2, model=3)),
            ("batch", lambda: _pp_batch(spec, cls_flat))):
        try:
            call()
            errors[name] = None
        except ValueError as err:
            errors[name] = str(err)
    js["errors"] = errors


def _n(mesh, axis):
    from autognothi_tpu_torch.parallel.mesh import axis_size

    return axis_size(mesh, axis)


def _first_query(mesh, cfg):
    from autognothi_tpu_torch.parallel.pipeline import stage_of

    stage, n_pipe = stage_of(mesh)
    i = stage * cfg.num_hidden_layers // n_pipe
    return f"vit.encoder.layers.{i}.attention.self.query.weight"


def _merge(model, mesh, cfg):
    from autognothi_tpu_torch.parallel.pipeline import (StageLayout,
                                                        merge_encoder_params)
    from autognothi_tpu_torch.params import MODELS

    with torch.device("meta"):
        full = MODELS[type(cfg)](cfg, "classifier")
    layout = StageLayout({k: tuple(v.shape)
                          for k, v in full.state_dict().items()},
                         "vit.encoder.layers", cfg.num_hidden_layers,
                         _n(mesh, "pipe"))
    return merge_encoder_params(model, layout, mesh)


def _three_layers(mesh):
    from autognothi_tpu_torch.parallel.pipeline import pipelined_scan

    return pipelined_scan(lambda x, s, g: x, [], None, None, mesh,
                          microbatches=2, n_layers=3, rows=8,
                          act_shape=(5, 32), dtype=torch.float32,
                          device=CPU)


def _pp_batch(spec, flat):
    from types import SimpleNamespace

    from autognothi_tpu_torch.pipeline.pp_trainer import _pp_context

    env = SimpleNamespace(log=lambda *_: None)
    config = SimpleNamespace(net=SimpleNamespace(kind="vanilla_vit"))
    # 4 ranks / pipe 2 -> data 2; 6 % (2 x 2) != 0
    return _pp_context(env, config, _cfg(spec, "vit"), flat, lambda k: True,
                       2, 2, 6, section="classifier", device=CPU)


def run_steps(spec, inputs, out) -> None:
    """One explainer step through `setup_pp_explainer` per case."""
    from types import SimpleNamespace

    from autognothi_tpu_torch.models.common import pallas_override
    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.parallel.pipeline import HOPS
    from autognothi_tpu_torch.parallel.tp import gather_shard
    from autognothi_tpu_torch.pipeline.pp_trainer import setup_pp_explainer
    from autognothi_tpu_torch.recipes.vanilla_vit import vanilla_vit_recipe

    recipe = vanilla_vit_recipe()
    cfg = _cfg(spec, "vit")
    env = SimpleNamespace(log=lambda *_: None)
    config = SimpleNamespace(
        net=SimpleNamespace(kind="vanilla_vit"),
        train_explainer=SimpleNamespace(batch_size=8,
                                        n_mask_samples=spec["m"]))
    xs = torch.from_numpy(inputs["xs"])
    masks = torch.from_numpy(inputs["masks"])
    null = torch.from_numpy(inputs["step_null"])
    for case in spec["cases"]:
        srg = from_jax_params(_load(inputs, "vit/srg/"), cfg, CPU,
                              section="surrogate")
        srg.requires_grad_(False)
        ctx, srg, step, eval_step = setup_pp_explainer(
            env, config, cfg, _load(inputs, "step/exp/"), srg, recipe, 2,
            case["mb"], case["tp"], device=CPU)
        ones = {k: 1.0 for k, _ in ctx.model.named_parameters()}
        HOPS.clear()
        with pallas_override("0"), counting() as counts:
            loss = step(ctx.model, ctx.opt, srg, null, xs, None, spec["lr"],
                        ones, cfg.num_hidden_layers, masks=masks)
        name = case["name"]
        out["json"][f"{name}/loss"] = loss.item()
        out["json"][f"{name}/hops"] = dict(HOPS)
        out["json"][f"{name}/counts"] = dict(counts)
        for k, v in ctx.to_flat(ctx.model).items():
            out["npz"][f"{name}/{k}"] = v
        for k, p in ctx.model.named_parameters():
            out["npz"][f"{name}/rank/{k}"] = gather_shard(p).detach().numpy()
        with pallas_override("0"):
            out["json"][f"{name}/eval"] = eval_step(
                ctx.model, srg, null, xs, None, cfg.num_hidden_layers,
                masks=masks).item()


def run_surrogate_step(spec, inputs, out) -> None:
    """One `setup_pp_surrogate` step over (data 2 x pipe 2) on the
    parent's mask, teacher rows and labels: the loss, the cls metric, the
    rows every rank logs and the merged parameters."""
    from types import SimpleNamespace

    from autognothi_tpu_torch.models.common import pallas_override
    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.pipeline.pp_trainer import setup_pp_surrogate

    cfg = _cfg(spec, "vit")
    env = SimpleNamespace(log=lambda *_: None)
    config = SimpleNamespace(net=SimpleNamespace(kind="vanilla_vit"),
                             train_surrogate=SimpleNamespace(batch_size=8))
    cls = from_jax_params(_load(inputs, "vit/cls/"), cfg, CPU,
                          section="classifier")
    ctx, _, step, _ = setup_pp_surrogate(
        env, config, cfg, _load(inputs, "vit/srg/"), cls, lambda k: True,
        2, 2, 1, device=CPU)
    batch = [torch.from_numpy(inputs[k]) for k in (
        "xs", "srg_mask", "srg_orig", "srg_labels")]
    with pallas_override("0"):
        kld, (cls_loss, adapt) = step(
            ctx.model, ctx.opt, spec["lr"],
            {k: 1.0 for k, _ in ctx.model.named_parameters()}, *batch, None,
            None, torch.ones(8))
    out["json"]["srg/loss"] = kld.item()
    out["json"]["srg/cls"] = cls_loss.item()
    out["npz"]["srg/adapt"] = adapt.numpy()
    for k, v in ctx.to_flat(ctx.model).items():
        out["npz"][f"srg/p/{k}"] = v


def run_teacher(spec, inputs, out) -> None:
    """The explainer step's teacher on a mesh of one data rank (data 1 x
    pipe 4): the kernel
    ops it dispatches (each ops module's `dispatch` spied) and the modes
    it runs in; then the same count for the differentiated forward."""
    from types import SimpleNamespace

    from autognothi_tpu_torch.models.common import pallas_mode
    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.parallel import train_step as ts
    from autognothi_tpu_torch.pipeline.pp_trainer import setup_pp_explainer
    from autognothi_tpu_torch.recipes.vanilla_vit import vanilla_vit_recipe

    recipe = vanilla_vit_recipe()
    cfg = _cfg(spec, "vit")
    env = SimpleNamespace(log=lambda *_: None)
    config = SimpleNamespace(
        net=SimpleNamespace(kind="vanilla_vit"),
        train_explainer=SimpleNamespace(batch_size=8,
                                        n_mask_samples=spec["m"]))
    srg = from_jax_params(_load(inputs, "vit/srg/"), cfg, CPU,
                          section="surrogate")
    srg.requires_grad_(False)
    ctx, srg, step, _ = setup_pp_explainer(
        env, config, cfg, _load(inputs, "step/exp/"), srg, recipe,
        dist.get_world_size(), 2, 1, device=CPU)
    calls = {"teacher": {}, "other": {}, "modes": []}
    where = {"now": "other"}
    teacher = ts._teacher

    def spied_teacher(*args, **kw):
        where["now"] = "teacher"
        calls["modes"].append(pallas_mode())
        try:
            return teacher(*args, **kw)
        finally:
            where["now"] = "other"

    with _spy_dispatch(calls, where), \
            mock.patch.object(ts, "_teacher", spied_teacher), \
            mock.patch.dict(os.environ, {"AUTOGNOTHI_PALLAS": "2"}):
        step(ctx.model, ctx.opt, srg, torch.from_numpy(inputs["step_null"]),
             torch.from_numpy(inputs["xs"]), None, spec["lr"],
             {k: 1.0 for k, _ in ctx.model.named_parameters()},
             cfg.num_hidden_layers,
             masks=torch.from_numpy(inputs["masks"]))
    out["json"]["teacher"] = calls


@contextlib.contextmanager
def _spy_dispatch(calls, where):
    """Count each kernel op's `dispatch` by its counter's name, under the
    key `where["now"]`."""
    from autognothi_tpu_torch.kernels import primitives

    real = primitives.dispatch

    def spy(launch, plain, counter, *args, **kw):
        bucket = calls[where["now"]]
        bucket[counter.name] = bucket.get(counter.name, 0) + 1
        return real(launch, plain, counter, *args, **kw)

    mods = [m for m in list(sys.modules.values())
            if getattr(m, "__name__", "").startswith("autognothi_tpu_torch.")
            and getattr(m, "dispatch", None) is real]
    with contextlib.ExitStack() as stack:
        for m in mods:
            stack.enter_context(mock.patch.object(m, "dispatch", spy))
        yield


def run_trainers(spec, inputs, out) -> None:
    """The port's trainers, each run under its environment; a run with a
    "trip" requests SIGTERM on one rank at the start of that epoch and
    must stop every rank with TrainingInterrupted."""
    import importlib

    from autognothi_tpu_torch.pipeline import training
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.training import TrainingInterrupted

    for run in spec["runs"]:
        mod = importlib.import_module(
            f"autognothi_tpu_torch.pipeline.train_{run['stage']}")
        fn = getattr(mod, f"train_{run['stage']}")
        kw = {"unfreeze_all": True} if run.get("unfreeze_all") else {}
        if run.get("hparams") is not None and dist.get_rank() == 0:
            (pathlib.Path(run["exp"]) / ".hparams.json").write_text(
                json.dumps(run["hparams"]))
        dist.barrier()
        patches = contextlib.ExitStack()
        trip = run.get("trip")
        if trip is not None:
            real = mod.cosine_lr

            def tripping(base_lr, epoch, total, real=real, trip=trip):
                if epoch == trip["epoch"] and dist.get_rank() == trip["rank"]:
                    training._SHUTDOWN["requested"] = True
                return real(base_lr, epoch, total)

            patches.enter_context(mock.patch.object(mod, "cosine_lr",
                                                    tripping))
        with patches, mock.patch.dict(os.environ, run["env"]):
            try:
                with ExpEnv(pathlib.Path(run["exp"])) as env:
                    fn(env, device="cpu", **kw)
                out["json"][f"{run['name']}/interrupted"] = False
            except TrainingInterrupted:
                out["json"][f"{run['name']}/interrupted"] = True
            finally:
                training._SHUTDOWN["requested"] = False


def run_remat(spec, inputs, out) -> None:
    """`<pp|tp>/<0|1>/...`: the step's loss and the rank's parameters after
    it, without (0) and with (1) AUTOGNOTHI_REMAT=1; `<pp|tp>/recomputed`:
    whether the second run checkpointed any layer."""
    from types import SimpleNamespace

    import torch.utils.checkpoint as ckpt

    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.parallel.mesh import make_mesh, shard_params
    from autognothi_tpu_torch.parallel.tp import gather_shard
    from autognothi_tpu_torch.parallel.train_step import \
        make_explainer_train_step
    from autognothi_tpu_torch.pipeline.pp_trainer import setup_pp_surrogate
    from autognothi_tpu_torch.pipeline.training import AdamW
    from autognothi_tpu_torch.recipes.vanilla_vit import vanilla_vit_recipe

    recipe, cfg = vanilla_vit_recipe(), _cfg(spec, "vit")
    env = SimpleNamespace(log=lambda *_: None)
    t = torch.from_numpy
    b = inputs["xs"].shape[0]
    checkpointed = {"n": 0}
    wrapped = ckpt.checkpoint

    def counted(*args, **kwargs):
        checkpointed["n"] += 1
        return wrapped(*args, **kwargs)

    for flag in ("0", "1"):
        with mock.patch.dict(os.environ, {"AUTOGNOTHI_REMAT": flag}), \
                mock.patch.object(ckpt, "checkpoint", counted):
            checkpointed["n"] = 0
            config = SimpleNamespace(
                net=SimpleNamespace(kind="vanilla_vit"),
                train_surrogate=SimpleNamespace(batch_size=b))
            cls = from_jax_params(_load(inputs, "cls/"), cfg, CPU,
                                  section="classifier")
            ctx, _, step, _ = setup_pp_surrogate(
                env, config, cfg, _load(inputs, "srg/"), cls,
                lambda k: True, 2, 2, 1, device=CPU)
            orig = torch.softmax(t(inputs["orig"]), -1)
            kld, _ = step(ctx.model, ctx.opt, spec["lr"],
                          {k: 1.0 for k, _ in ctx.model.named_parameters()},
                          t(inputs["xs"]), t(inputs["mask"]), orig,
                          t(inputs["labels"]),
                          torch.Generator().manual_seed(5), None,
                          torch.ones(b))
            out["json"][f"pp/{flag}/loss"] = kld.item()
            for k, p in ctx.model.named_parameters():
                out["npz"][f"pp/{flag}/{k}"] = p.detach().numpy()
            out["json"]["pp/recomputed"] = checkpointed["n"] > 0

            checkpointed["n"] = 0
            mesh = make_mesh(2, model_parallel=2)
            srg = from_jax_params(_load(inputs, "srg/"), cfg, CPU,
                                  section="surrogate")
            model = from_jax_params(_load(inputs, "exp/"), cfg, CPU,
                                    section="explainer")
            srg.requires_grad_(False)
            shard_params(srg, mesh)
            shard_params(model, mesh)
            params = dict(model.named_parameters())
            opt = AdamW(params, lambda k: True)
            xstep = make_explainer_train_step(
                recipe, cfg, recipe.n_players(cfg),
                inputs["masks"].shape[1], mesh=mesh)
            loss = xstep(model, opt, srg, t(inputs["null"]), t(inputs["xs"]),
                         torch.Generator().manual_seed(5), spec["lr"],
                         {k: 1.0 for k in params}, cfg.num_hidden_layers,
                         masks=t(inputs["masks"]))
            out["json"][f"tp/{flag}/loss"] = loss.item()
            for k, p in params.items():
                out["npz"][f"tp/{flag}/{k}"] = gather_shard(p).detach(
                ).numpy()
            out["json"]["tp/recomputed"] = checkpointed["n"] > 0


def run_ckpt_dir(spec, inputs, out) -> None:
    """Writes under spec["ckpt"]: `tp/` (epochs 1 and 2 of a TP-sharded
    explainer with AUTOGNOTHI_CKPT_OPT=1, the moments 0.5 x the
    parameters), `pp/` (a pipe-2 classifier stage), and the npz of each
    under `npz_tp/`, `npz_pp/`; `<tp|pp>/loaded_equal`: whether the rank's
    load of its directory is the one-device dict bit for bit."""
    from types import SimpleNamespace

    from autognothi_tpu_torch.params import (from_jax_params,
                                             load_params_file, save_params,
                                             to_flat)
    from autognothi_tpu_torch.parallel.distributed import is_writer
    from autognothi_tpu_torch.parallel.mesh import make_mesh, shard_params
    from autognothi_tpu_torch.parallel.pipeline import (
        make_pipe_mesh, merge_encoder_params)
    from autognothi_tpu_torch.pipeline.resources import save_epoch_ckpt
    from autognothi_tpu_torch.pipeline.training import AdamW, ckpt_of

    cfg = _cfg(spec, "vit")
    root = pathlib.Path(spec["ckpt"])
    train = SimpleNamespace(epochs=3, ckpt_when="_:%5==0")
    dirs = {"AUTOGNOTHI_CKPT_BACKEND": "orbax", "AUTOGNOTHI_CKPT_OPT": "1"}

    exp = _load(inputs, "exp/")
    mesh = make_mesh(2, model_parallel=2)
    model = from_jax_params(exp, cfg, CPU, section="explainer")
    shard_params(model, mesh)
    params = dict(model.named_parameters())
    opt = AdamW(params, lambda k: True)
    for k in opt.names:
        opt.mu[k].copy_(params[k].detach() * 0.5)
        opt.nu[k].copy_(params[k].detach() * 0.25)
    opt.count = 3
    with mock.patch.dict(os.environ, dirs):
        for epoch in (1, 2):
            save_epoch_ckpt(root / "tp", "explainer", train, epoch,
                            *ckpt_of(None, model, opt))
        out["json"]["tp/loaded_equal"] = all(
            np.array_equal(v, exp[k]) for k, v in load_params_file(
                root / "tp" / "explainer-epoch-2.ckpt").items()) and set(
            load_params_file(root / "tp" / "explainer-epoch-2.ckpt")) == \
            set(exp)
    flat = to_flat(model)  # every rank: the gather is collective
    if is_writer():
        save_params(root / "npz_tp.ckpt", flat)

    cls = _load(inputs, "cls/")
    pmesh = make_pipe_mesh(pipe=2)
    stage, layout = _stage(cls, cfg, pmesh, "classifier")
    with mock.patch.dict(os.environ, {"AUTOGNOTHI_CKPT_BACKEND": "orbax"}):
        save_epoch_ckpt(root / "pp", "classifier", train, 1,
                        *ckpt_of(None, stage, None))
        got = load_params_file(root / "pp" / "classifier-epoch-1.ckpt")
    out["json"]["pp/loaded_equal"] = set(got) == set(cls) and all(
        np.array_equal(v, cls[k]) for k, v in got.items())
    out["json"]["pp/stage_keys"] = sorted(k for k, _ in
                                          stage.named_parameters())
    merged = merge_encoder_params(stage, layout, pmesh)
    if is_writer():
        save_params(root / "npz_pp.ckpt", merged)


JOBS = {"modules": run_modules, "steps": run_steps, "teacher": run_teacher,
        "surrogate_step": run_surrogate_step, "trainers": run_trainers,
        "remat": run_remat, "ckpt_dir": run_ckpt_dir}


def main(spec_path: str) -> None:
    from autognothi_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed, rank)

    spec = json.loads(pathlib.Path(spec_path).read_text())
    assert maybe_initialize_distributed(device="cpu"), "no world"
    inputs = np.load(spec["inputs"]) if spec.get("inputs") else None
    out = {"json": {}, "npz": {}}
    for job in spec["jobs"]:
        JOBS[job](spec, inputs, out)
    dest = pathlib.Path(spec["out"])
    np.savez(dest / f"rank{rank()}.npz", **out["npz"])
    (dest / f"rank{rank()}.json").write_text(json.dumps(out["json"]))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
