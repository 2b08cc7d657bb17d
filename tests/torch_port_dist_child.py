"""One rank of the port's multi-process CPU tests (gloo), started by
tests/test_torch_port_scaleout.py and tests/test_torch_port_distributed.py
as `python -m tests.torch_port_dist_child <spec.json>` with the
AUTOGNOTHI_DIST_* variables.  It imports torch and the port, never JAX.

The spec names the jobs to run, in order, and where the rank writes its
results (`<out>/rank<r>.npz` and `<out>/rank<r>.json`):
- "steps": the explainer train step of each case (a mini vanilla or LTT
  ViT, full or ragged batch) over a (world / model, model) mesh, on the
  parent's numpy parameters and masks: the loss, the whole updated
  parameters (gathered) and the collectives the step made;
- "tp_forward": the surrogate forward of the mini vanilla ViT under
  tensor parallelism: its output and its collectives;
- "serve": `sharded_serving_fn` of the mini vanilla final: this rank's
  rows, the gathered output and the collectives of one slab;
- "reports": `sharded_eval_fn` and `sharded_call` on an even and a ragged
  batch;
- "surrogate_step": `train_surrogate`'s step and eval (the generic
  `make_train_step` / `make_eval_step`) over a ragged batch;
- "basics": `process_info`, an all-reduce, and a checkpoint that rank 0
  alone writes and every rank reads back;
- "artifact": an `export_final --data-parallel` artifact called by every
  rank, then served by rank 0's `ExplainService` while the others
  `follow`.
"""

import collections
import contextlib
import json
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist

CPU = torch.device("cpu")
COLLECTIVES = ("all_reduce", "all_gather", "broadcast", "reduce_scatter",
               "all_to_all", "barrier")


@contextlib.contextmanager
def counting():
    """Count the calls of each torch.distributed collective in the scope."""
    counts = collections.Counter()
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return counted

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _recipe(kind: str):
    if kind == "ltt":
        from autognothi_tpu_torch.recipes.ltt_vit import ltt_vit_recipe

        return ltt_vit_recipe()
    from autognothi_tpu_torch.recipes.vanilla_vit import vanilla_vit_recipe

    return vanilla_vit_recipe()


def _load(inputs: np.lib.npyio.NpzFile, prefix: str) -> dict:
    return {k[len(prefix):]: inputs[k] for k in inputs.files
            if k.startswith(prefix)}


def run_steps(spec: dict, inputs, mesh_for, out: dict) -> None:
    from autognothi_tpu_torch.params import from_jax_params, to_flat
    from autognothi_tpu_torch.parallel.mesh import shard_params
    from autognothi_tpu_torch.parallel.train_step import \
        make_explainer_train_step
    from autognothi_tpu_torch.pipeline.training import AdamW

    for case in spec["cases"]:
        name, kind = case["name"], case["kind"]
        recipe = _recipe(kind)
        cfg = recipe.t_config(**spec["cfgs"][kind])
        mesh = mesh_for(case["model"])
        srg = from_jax_params(_load(inputs, f"{kind}/srg/"), cfg, CPU,
                              section="surrogate")
        model = from_jax_params(_load(inputs, f"{kind}/exp/"), cfg, CPU,
                                section="explainer")
        srg.requires_grad_(False)
        shard_params(srg, mesh)
        shard_params(model, mesh)
        trainable = ((lambda k: True) if kind == "vanilla"
                     else recipe.trainable(cfg, "explainer"))
        for k, p in model.named_parameters():
            p.requires_grad_(trainable(k))
        params = dict(model.named_parameters())
        opt = AdamW(params, trainable)
        step = make_explainer_train_step(recipe, cfg, recipe.n_players(cfg),
                                         spec["n_mask_samples"], mesh=mesh)
        weights = inputs[f"weights/{case['weights']}"]
        null = torch.from_numpy(inputs[f"{kind}/null"])
        with counting() as counts:
            loss = step(model, opt, srg, null,
                        torch.from_numpy(inputs["xs"]), None, spec["lr"],
                        {k: 1.0 for k in params}, cfg.num_hidden_layers,
                        weights=torch.from_numpy(weights),
                        masks=torch.from_numpy(inputs[f"{kind}/masks"]))
        out["json"][f"{name}/loss"] = loss.item()
        out["json"][f"{name}/counts"] = dict(counts)
        for k, v in to_flat(model).items():
            out["npz"][f"{name}/{k}"] = v


def run_tp_forward(spec: dict, inputs, mesh_for, out: dict) -> None:
    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.parallel.mesh import shard_params

    recipe = _recipe("vanilla")
    cfg = recipe.t_config(**spec["cfgs"]["vanilla"])
    srg = from_jax_params(_load(inputs, "vanilla/srg/"), cfg, CPU,
                          section="surrogate")
    shard_params(srg, mesh_for(spec["model"]))
    xs = torch.from_numpy(inputs["xs"])
    mask = torch.ones((xs.shape[0], recipe.n_players(cfg)),
                      dtype=torch.int32)
    with torch.no_grad(), counting() as counts:
        probs, _ = recipe.fw_surrogate(cfg, srg, xs, mask)
    out["npz"]["tp_forward/probs"] = probs.numpy()
    out["json"]["tp_forward/counts"] = dict(counts)
    # a kernel op refuses a sharded weight (mode "2" would reach one)
    from autognothi_tpu_torch.models.common import pallas_override

    try:
        with torch.no_grad(), pallas_override("2"):
            recipe.fw_surrogate(cfg, srg, xs, mask)
        out["json"]["tp_forward/kernel_refused"] = False
    except ValueError as err:
        out["json"]["tp_forward/kernel_refused"] = "partial sum" in str(err)


def run_serve(spec: dict, inputs, mesh_for, out: dict) -> None:
    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.parallel.mesh import sharded_serving_fn

    recipe = _recipe("vanilla")
    cfg = recipe.t_config(**spec["cfgs"]["vanilla"])
    final = from_jax_params(_load(inputs, "vanilla/final/"), cfg, CPU)
    fw = sharded_serving_fn(lambda m, x: recipe.fw_final(cfg, m, x),
                            mesh_for(1))
    xs = torch.from_numpy(inputs["serve_xs"])
    with torch.no_grad(), counting() as counts:
        probs, attr = fw(final, xs)
    out["npz"]["serve/probs"] = probs.numpy()
    out["npz"]["serve/attr"] = attr.numpy()
    out["json"]["serve/counts"] = dict(counts)


def run_reports(spec: dict, inputs, mesh_for, out: dict) -> None:
    from autognothi_tpu_torch.models.common import pallas_mode
    from autognothi_tpu_torch.parallel.mesh import (sharded_call,
                                                    sharded_eval_fn)

    mesh = mesh_for(1)
    modes = []

    def fn(scale, x, y):
        modes.append(pallas_mode())
        return (x * scale + y.sum(dim=1, keepdim=True), x.sum(dim=1))

    for b in (4, 3):  # even over 2 ranks, ragged
        x = torch.arange(b * 3, dtype=torch.float32).reshape(b, 3)
        y = torch.ones((b, 2))
        with counting() as counts:
            got = sharded_eval_fn(fn, mesh, in_axes=(None, 0, 0))(2.0, x, y)
        out["npz"][f"reports/eval{b}/0"] = got[0].numpy()
        out["npz"][f"reports/eval{b}/1"] = got[1].numpy()
        out["json"][f"reports/eval{b}/counts"] = dict(counts)
        out["json"][f"reports/eval{b}/mode"] = modes[-1]
    got = sharded_call(fn, mesh, in_axes=(None, 0, 0))(
        2.0, torch.ones((4, 3)), torch.ones((4, 2)))
    out["npz"]["reports/call"] = got[0].numpy()
    for bad, what in (((2.0, torch.ones((3, 3)), torch.ones((3, 2))),
                       "divide"),):
        try:
            sharded_call(fn, mesh, in_axes=(None, 0, 0))(*bad)
            out["json"]["reports/refused_ragged"] = False
        except ValueError as err:
            out["json"]["reports/refused_ragged"] = what in str(err)
    try:
        sharded_call(lambda x: x.sum(), mesh, in_axes=(0,))(torch.ones(4))
        out["json"]["reports/refused_scalar"] = False
    except ValueError as err:
        out["json"]["reports/refused_scalar"] = "one rank" in str(err)


def run_basics(spec: dict, inputs, mesh_for, out: dict) -> None:
    from autognothi_tpu_torch.parallel.distributed import (process_info,
                                                           rank)
    from autognothi_tpu_torch.pipeline.config import Config_Train
    from autognothi_tpu_torch.pipeline.resources import (load_params_file,
                                                         save_epoch_ckpt)

    out["json"].update(process_info())
    x = torch.full((1, 8), float(rank()))
    dist.all_reduce(x)
    out["json"]["reduced"] = float(x.sum())
    ckpt_dir = pathlib.Path(spec["ckpt_dir"])
    # rank 0 alone writes; the save returns on every rank once it is there
    cfg = Config_Train(**spec["train_cfg"])
    save_epoch_ckpt(ckpt_dir, "dist", cfg, 1,
                    {"w": np.full((2, 3), 7.0 + rank(), np.float32)})
    got = load_params_file(ckpt_dir / "dist-epoch-1.ckpt")["w"]
    out["json"]["ckpt_rank0"] = bool(np.all(got == 7.0))


def run_artifact(spec: dict, inputs, mesh_for, out: dict) -> None:
    """`serve --artifact` of a `--data-parallel` artifact without HTTP:
    rank 0's service answers a payload while the other ranks follow."""
    from autognothi_tpu_torch.parallel.distributed import rank
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.export import load_exported
    from autognothi_tpu_torch.pipeline.serve import ExplainService

    fw = load_exported(spec["artifact"], device="cpu")
    # every rank calls with the whole batch
    got = fw(np.asarray(spec["call"], np.float32))
    if rank() < fw.nr_devices:
        out["npz"]["artifact/probs"] = got[0].numpy()
        out["npz"]["artifact/attr"] = got[1].numpy()
    with ExpEnv(pathlib.Path(spec["exp"])) as env:
        service = ExplainService(env, batch_size=1, device="cpu",
                                 artifact=spec["artifact"])
        out["json"]["artifact/batch_size"] = service.batch_size
        if rank() == 0:
            service.warmup()
            with counting() as counts:
                answer = service.explain({"images": spec["payload"]})
            service.close()
            out["npz"]["served/logits"] = np.asarray(answer["logits"])
            out["npz"]["served/attr"] = np.asarray(answer["attributions"])
            out["json"]["served/counts"] = dict(counts)
        else:
            out["json"]["followed_slabs"] = service.follow()


def surrogate_step(recipe, cfg, srg, inputs, mesh=None):
    """One `train_surrogate` step (`training.make_train_step` over the
    stage's `surrogate_loss`) and one eval (`make_eval_step`) on the
    parent's arrays -> (loss, cls, adapt_ys, eval outputs, the model, the
    gradients the update saw)."""
    from autognothi_tpu_torch.pipeline.train_surrogate import surrogate_loss
    from autognothi_tpu_torch.pipeline.training import (AdamW,
                                                        cross_entropy_on_probs,
                                                        make_eval_step,
                                                        make_train_step)
    from autognothi_tpu_torch.ops.shapley import loss_logits_kl_divergence

    trainable = recipe.trainable(cfg, "surrogate")
    for k, p in srg.named_parameters():
        p.requires_grad_(trainable(k))
    params = dict(srg.named_parameters())
    in_axes = (0, 0, 0, 0, None, None, 0)
    step = make_train_step(surrogate_loss(recipe, cfg, True), mesh, in_axes)
    batch = tuple(torch.from_numpy(inputs[k]) for k in (
        "xs", "srg_mask", "srg_orig", "srg_labels"))
    w = torch.from_numpy(inputs["weights/ragged"])
    opt, grads = AdamW(params, trainable), {}
    update = opt.update

    def spy(p, g, lr, mask):
        grads.update({k: v.detach().clone() for k, v in g.items()})
        return update(p, g, lr, mask)

    opt.update = spy
    kld, (cls, adapt) = step(srg, opt, 1e-3, {k: 1.0 for k in params},
                             *batch, None, cfg.num_hidden_layers, w)

    def eval_loss(xs, mask, orig, labels, active, weights):
        adapt, _ = recipe.fw_surrogate(cfg, srg, xs, mask,
                                       ltt_active_layers=active)
        return (loss_logits_kl_divergence(orig, adapt, weights),
                cross_entropy_on_probs(adapt, labels, weights), adapt)

    evals = make_eval_step(eval_loss, mesh, (0, 0, 0, 0, None, 0))(
        *batch, cfg.num_hidden_layers, w)
    return kld, cls, adapt, evals, srg, grads


def run_surrogate_step(spec: dict, inputs, mesh_for, out: dict) -> None:
    """`train_surrogate`'s data-parallel step and eval over a ragged
    batch: the loss and the 0-d cls loss summed, the rows gathered."""
    from autognothi_tpu_torch.params import from_jax_params, to_flat

    recipe = _recipe("ltt")
    cfg = recipe.t_config(**spec["cfgs"]["ltt"])
    srg = from_jax_params(_load(inputs, "ltt/srg/"), cfg, CPU,
                          section="surrogate")
    with counting() as counts:
        kld, cls, adapt, evals, srg, _ = surrogate_step(
            recipe, cfg, srg, inputs, mesh_for(1))
    out["json"]["surrogate/counts"] = dict(counts)
    for name, v in (("kld", kld), ("cls", cls), ("adapt", adapt),
                    *((f"eval{i}", e) for i, e in enumerate(evals))):
        out["npz"][f"surrogate/{name}"] = v.numpy()
    for k, v in to_flat(srg).items():
        out["npz"][f"surrogate/params/{k}"] = v


JOBS = {"steps": run_steps, "artifact": run_artifact,
        "surrogate_step": run_surrogate_step, "tp_forward": run_tp_forward,
        "serve": run_serve, "reports": run_reports, "basics": run_basics}


def main(spec_path: str) -> None:
    from autognothi_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed, rank, world_size)
    from autognothi_tpu_torch.parallel.mesh import make_mesh

    spec = json.loads(pathlib.Path(spec_path).read_text())
    assert maybe_initialize_distributed(device="cpu"), "no world"
    meshes = {}

    def mesh_for(model: int):
        if model not in meshes:
            meshes[model] = make_mesh(world_size(), model_parallel=model)
        return meshes[model]

    inputs = np.load(spec["inputs"]) if spec.get("inputs") else None
    out = {"json": {}, "npz": {}}
    for job in spec["jobs"]:
        JOBS[job](spec, inputs, mesh_for, out)
    dest = pathlib.Path(spec["out"])
    np.savez(dest / f"rank{rank()}.npz", **out["npz"])
    (dest / f"rank{rank()}.json").write_text(json.dumps(out["json"]))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
