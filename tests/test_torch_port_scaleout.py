"""Port parity, multi-device (M10a): the port's data-parallel, tensor-
parallel and 2 x 2 explainer steps, its tensor-parallel forward and its
sharded serving, each run by gloo processes on the CPU
(tests/torch_port_dist_child.py), against the JAX package's one-device
step on the same numpy parameters and coalition masks, and against the
port's own one-process step.

The mini configs are the JAX mesh tests' (tests/test_parallel.py:19, the
vanilla ViT; tests/test_scaleout.py:58, the LTT ViT; dropout 0), B = 8
images x M = 4 coalitions, pallas mode "0" (the JAX one-device step's XLA
arithmetic), lr 1e-3.  Bounds:
- against the JAX step, the JAX mesh tests' own: loss within 1e-5,
  parameters within 2e-4;
- against the port's one-process step: loss and parameters within 1e-6;
- the parameters are held where the one-process gradient is settled,
  |g| > 1e-4 max|g| (test_torch_port_train.py's rule): AdamW's first
  update is about lr sign(g), and where g is float noise (the gradients
  that are 0 by structure, and elements ~1e-7 of the largest, whose
  partial sums the mesh orders otherwise) the update moves by up to 2 lr,
  which is the bound there;
- the ranks' parameters after the step are bit-identical;
- a ragged final batch (3 real rows of 8: the last data rank holds only
  padding) gives the one-device loss.
`train_surrogate`'s step and eval (the generic `make_train_step` and
`make_eval_step` the classifier, surrogate and duo trainers share) run
over 2 ranks on a ragged batch against one process at 1e-6.
Collectives are counted by wrapping `torch.distributed`'s functions: the
data-parallel step makes one all-reduce (gradients and loss in one flat
buffer) and no all-gather, the tensor-parallel forward two all-reduces per
layer and no all-gather, a served slab one all-gather per output and no
all-reduce.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_parallel import _mini_cfg
from tests.test_scaleout import _mini_ltt_cfg

REPO = pathlib.Path(__file__).resolve().parents[1]
B, M, LR = 8, 4, 1e-3
WEIGHTS = {"full": np.ones(B, np.float32),
           "ragged": np.asarray([1, 1, 1, 0, 0, 0, 0, 0], np.float32)}
CHILD_TIMEOUT = 240
DIST_KEYS = ("AUTOGNOTHI_PALLAS", "AUTOGNOTHI_INT8", "AUTOGNOTHI_INT8_TEACHER",
             "AUTOGNOTHI_DIST_COORD", "AUTOGNOTHI_DIST_NPROCS",
             "AUTOGNOTHI_DIST_PROC_ID")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(spec: dict, nprocs: int, tmp: pathlib.Path,
              extra_env: dict = None,
              module: str = "tests.torch_port_dist_child") -> list:
    """Run `spec` in nprocs gloo processes of `module` -> each rank's
    (json, npz)."""
    out = tmp / f"out_{nprocs}_{spec['tag']}"
    out.mkdir()
    spec = dict(spec, out=str(out))
    spec_path = tmp / f"spec_{nprocs}_{spec['tag']}.json"
    spec_path.write_text(json.dumps(spec))
    port = free_port()
    procs = []
    for rank in range(nprocs):
        env = {k: v for k, v in os.environ.items() if k not in DIST_KEYS}
        env.update({"AUTOGNOTHI_DIST_COORD": f"127.0.0.1:{port}",
                    "AUTOGNOTHI_DIST_NPROCS": str(nprocs),
                    "AUTOGNOTHI_DIST_PROC_ID": str(rank),
                    "AUTOGNOTHI_PALLAS": "0", "OMP_NUM_THREADS": "1",
                    **(extra_env or {})})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, str(spec_path)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        for rank, proc in enumerate(procs):
            _, err = proc.communicate(timeout=CHILD_TIMEOUT)
            assert proc.returncode == 0, f"rank {rank}:\n{err[-3000:]}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return [(json.loads((out / f"rank{r}.json").read_text()),
             dict(np.load(out / f"rank{r}.npz"))) for r in range(nprocs)]


# ------------------------------------------------- the one-device references


def _jax_case(kind: str):
    """JAX mini config, numpy surrogate / explainer params, null."""
    if kind == "vanilla":
        from autognothi_tpu.models.vit import (init_vit_classifier,
                                               init_vit_explainer)
        from autognothi_tpu.recipes.vanilla_vit import vanilla_vit_recipe

        cfg, recipe = _mini_cfg(), vanilla_vit_recipe()
        key = jax.random.PRNGKey(0)
        exp = init_vit_explainer(key, cfg)
        srg = init_vit_classifier(jax.random.fold_in(key, 1), cfg)
    else:
        from autognothi_tpu.models.ltt_vit import (init_ltt_vit_explainer,
                                                   init_ltt_vit_surrogate)
        from autognothi_tpu.recipes.ltt_vit import ltt_vit_recipe

        cfg, recipe = _mini_ltt_cfg(), ltt_vit_recipe()
        key = jax.random.PRNGKey(0)
        exp = init_ltt_vit_explainer(key, cfg)
        srg = init_ltt_vit_surrogate(jax.random.fold_in(key, 1), cfg)
    n_players = recipe.n_players(cfg)
    null, _ = recipe.fw_surrogate(cfg, srg, jnp.zeros((1, 3, 16, 16)),
                                  jnp.ones((1, n_players), jnp.int32))
    to_np = lambda p: {k: np.asarray(v) for k, v in p.items()}  # noqa
    return cfg, recipe, to_np(srg), to_np(exp), np.asarray(null)


def _trainable(kind, recipe, cfg):
    return ((lambda k: True) if kind == "vanilla"
            else recipe.trainable(cfg, "explainer"))


def _jax_step(kind, cfg, recipe, srg, exp, null, xs, weights):
    """-> (loss, updated params, masks) of the JAX one-device step."""
    from autognothi_tpu.ops.shapley import mask_shapley
    from autognothi_tpu.parallel.train_step import make_explainer_train_step
    from autognothi_tpu.pipeline.training import make_optimizer, ones_mask

    n_players = recipe.n_players(cfg)
    params = {k: jnp.asarray(v) for k, v in exp.items()}
    tx, opt = make_optimizer(params, _trainable(kind, recipe, cfg))
    step = make_explainer_train_step(recipe, cfg, n_players, M, tx)
    key = jax.random.PRNGKey(7)
    with mock.patch.dict(os.environ, {"AUTOGNOTHI_PALLAS": "0"}):
        new, _, loss = step(params, opt,
                            {k: jnp.asarray(v) for k, v in srg.items()},
                            jnp.asarray(null), jnp.asarray(xs), key,
                            jnp.asarray(LR), ones_mask(params),
                            jnp.asarray(cfg.num_hidden_layers, jnp.int32),
                            jnp.asarray(weights))
    mask_key, _ = jax.random.split(key)
    masks = mask_shapley(mask_key, B * M, n_players).reshape(B, M, n_players)
    return (float(loss), {k: np.asarray(v) for k, v in new.items()},
            np.asarray(masks))


def _port_step(kind, cfg_dict, srg, exp, null, xs, masks, weights):
    """-> (loss, updated params) of the port's one-process step, mode "0"."""
    from autognothi_tpu_torch.models.common import pallas_override
    from autognothi_tpu_torch.params import from_jax_params, to_flat
    from autognothi_tpu_torch.parallel.train_step import \
        make_explainer_train_step
    from autognothi_tpu_torch.pipeline.training import AdamW
    from tests.torch_port_dist_child import _recipe

    recipe = _recipe(kind)
    cfg = recipe.t_config(**cfg_dict)
    cpu = torch.device("cpu")
    srg_m = from_jax_params(srg, cfg, cpu, section="surrogate")
    srg_m.requires_grad_(False)
    model = from_jax_params(exp, cfg, cpu, section="explainer")
    trainable = _trainable(kind, recipe, cfg)
    for k, p in model.named_parameters():
        p.requires_grad_(trainable(k))
    params = dict(model.named_parameters())
    step = make_explainer_train_step(recipe, cfg, recipe.n_players(cfg), M)
    opt = AdamW(params, trainable)
    grads, update = {}, opt.update

    def spy(p, g, lr, mask):
        grads.update({k: v.detach().numpy().copy() for k, v in g.items()
                      if v is not None})
        return update(p, g, lr, mask)

    opt.update = spy
    with pallas_override("0"):
        loss = step(model, opt, srg_m,
                    torch.from_numpy(null), torch.from_numpy(xs), None, LR,
                    {k: 1.0 for k in params}, cfg.num_hidden_layers,
                    weights=torch.from_numpy(weights),
                    masks=torch.from_numpy(masks))
    return loss.item(), to_flat(model), grads


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The inputs every world loads, and the references per case."""
    tmp = tmp_path_factory.mktemp("scaleout")
    xs = np.random.RandomState(0).randn(B, 3, 16, 16).astype(np.float32)
    arrays = {"xs": xs, **{f"weights/{k}": v for k, v in WEIGHTS.items()}}
    cfgs, want = {}, {}
    for kind in ("vanilla", "ltt"):
        cfg, recipe, srg, exp, null = _jax_case(kind)
        cfgs[kind] = cfg.model_dump()
        arrays[f"{kind}/null"] = null
        arrays.update({f"{kind}/srg/{k}": v for k, v in srg.items()})
        arrays.update({f"{kind}/exp/{k}": v for k, v in exp.items()})
        for w_name, w in WEIGHTS.items():
            loss, params, masks = _jax_step(kind, cfg, recipe, srg, exp,
                                            null, xs, w)
            arrays[f"{kind}/masks"] = masks
            p_loss, p_params, grads = _port_step(kind, cfgs[kind], srg, exp,
                                                 null, xs, masks, w)
            g_max = max(np.abs(g).max() for g in grads.values())
            want[(kind, w_name)] = dict(
                jax=(loss, params), port=(p_loss, p_params),
                settled={k: np.abs(g) > 1e-4 * g_max
                         for k, g in grads.items()})
    from autognothi_tpu.models.vit import init_vit_final
    from autognothi_tpu.recipes.vanilla_vit import fw_final

    final = init_vit_final(jax.random.PRNGKey(2), _mini_cfg())
    arrays.update({f"vanilla/final/{k}": np.asarray(v)
                   for k, v in final.items()})
    rng = np.random.RandomState(2)
    n_players = (16 // 8) ** 2  # patches; the forward adds the CLS column
    arrays["srg_mask"] = (rng.rand(B, n_players) > 0.3).astype(np.int32)
    arrays["srg_orig"] = rng.dirichlet(np.ones(3), B).astype(np.float32)
    arrays["srg_labels"] = rng.randint(0, 3, B).astype(np.int64)
    want["surrogate"] = _port_surrogate_step(cfgs["ltt"], arrays)
    serve_xs = np.random.RandomState(1).randn(4, 3, 16, 16).astype(
        np.float32)
    arrays["serve_xs"] = serve_xs
    want["serve"] = _port_serve(cfgs["vanilla"], final, serve_xs)
    want["serve_jax"] = tuple(np.asarray(o) for o in fw_final(
        _mini_cfg(), final, jnp.asarray(serve_xs)))
    np.savez(tmp / "inputs.npz", **arrays)
    return dict(tmp=tmp, cfgs=cfgs, want=want, inputs=str(tmp / "inputs.npz"))


def _port_surrogate_step(cfg_dict, arrays):
    """The one-process `train_surrogate` step and eval, mode "0"."""
    from autognothi_tpu_torch.models.common import pallas_override
    from autognothi_tpu_torch.params import from_jax_params, to_flat
    from tests.torch_port_dist_child import _load, _recipe, surrogate_step

    recipe = _recipe("ltt")
    cfg = recipe.t_config(**cfg_dict)
    srg = from_jax_params(_load(_Npz(arrays), "ltt/srg/"), cfg,
                          torch.device("cpu"), section="surrogate")
    with pallas_override("0"):
        kld, cls, adapt, evals, srg, grads = surrogate_step(
            recipe, cfg, srg, arrays)
    return dict(kld=kld.numpy(), cls=cls.numpy(), adapt=adapt.numpy(),
                evals=[e.numpy() for e in evals], params=to_flat(srg),
                grads={k: g.numpy() for k, g in grads.items()})


class _Npz(dict):
    """A dict of arrays read as `np.load`'s NpzFile is (`files`)."""

    @property
    def files(self):
        return list(self)


def _port_serve(cfg_dict, final, xs):
    from autognothi_tpu_torch.params import from_jax_params
    from tests.torch_port_dist_child import _recipe

    recipe = _recipe("vanilla")
    cfg = recipe.t_config(**cfg_dict)
    model = from_jax_params({k: np.asarray(v) for k, v in final.items()},
                            cfg, torch.device("cpu"))
    with torch.no_grad():
        return tuple(o.numpy() for o in recipe.fw_final(
            cfg, model, torch.from_numpy(xs)))


CASES = [dict(name=f"{kind}_{w}_{model}", kind=kind, weights=w, model=model)
         for kind in ("vanilla", "ltt") for w in WEIGHTS for model in (1, 2)]


def _spec(refs, tag, jobs, cases=(), **kw):
    return dict(tag=tag, jobs=jobs, cases=list(cases), cfgs=refs["cfgs"],
                inputs=refs["inputs"], n_mask_samples=M, lr=LR, **kw)


def _check_steps(refs, ranks, cases):
    for case in cases:
        name = case["name"]
        jax_loss, jax_p = refs["want"][(case["kind"], case["weights"])]["jax"]
        port_loss, port_p = \
            refs["want"][(case["kind"], case["weights"])]["port"]
        info0, arr0 = ranks[0]
        loss = info0[f"{name}/loss"]
        assert np.isfinite(loss)
        assert abs(loss - jax_loss) < 1e-5, (name, loss, jax_loss)
        assert abs(loss - port_loss) <= 1e-6, (name, loss, port_loss)
        for info, arr in ranks[1:]:  # every rank applied the same update
            assert info[f"{name}/loss"] == loss, name
            for k in jax_p:
                np.testing.assert_array_equal(arr[f"{name}/{k}"],
                                              arr0[f"{name}/{k}"],
                                              err_msg=f"{name} {k}")
        settled = refs["want"][(case["kind"], case["weights"])]["settled"]
        for k in jax_p:
            got = arr0[f"{name}/{k}"]
            sure = settled.get(k, np.ones(got.shape, bool))
            # AdamW's first update is about lr sign(g): where g is within
            # float noise of 0 its sign, so the update, is not settled
            assert np.all(np.abs(got - jax_p[k])[~sure] <= 2.02 * LR), k
            np.testing.assert_allclose(got[sure], jax_p[k][sure], atol=2e-4,
                                       rtol=0, err_msg=f"{name} {k} vs JAX")
            np.testing.assert_allclose(got[sure], port_p[k][sure],
                                       atol=1e-6, rtol=0,
                                       err_msg=f"{name} {k} vs port")


def test_dp2_steps_tp_forward_and_serving(refs):
    """World 2: the data-parallel steps (model 1) and the tensor-parallel
    steps (model 2) of both families, full and ragged; the TP forward;
    the sharded serving of one slab; `train_surrogate`'s step and eval."""
    cases = CASES
    ranks = run_world(_spec(refs, "w2", ["steps", "tp_forward", "serve",
                                         "surrogate_step"], cases, model=2),
                      2, refs["tmp"])
    _check_steps(refs, ranks, cases)
    _check_surrogate_step(refs["want"]["surrogate"], ranks)
    for info, arr in ranks:
        for case in cases:
            counts = info[f"{case['name']}/counts"]
            assert counts.get("all_gather", 0) == 0, (case, counts)
            if case["model"] == 1:  # one flat all-reduce of grads + loss
                assert counts == {"all_reduce": 1}, (case, counts)
            else:  # two per TP'd layer forward and backward, no data one
                assert counts["all_reduce"] > 0, (case, counts)
        # the TP forward: two all-reduces per TP'd layer (2 trunk + 1
        # explainer-side layer of the vanilla surrogate: none; 2 layers)
        cfg = refs["cfgs"]["vanilla"]
        assert info["tp_forward/counts"] == {
            "all_reduce": 2 * cfg["num_hidden_layers"]}, info
        assert info["tp_forward/kernel_refused"] is True
        np.testing.assert_allclose(arr["tp_forward/probs"],
                                   _one_device_probs(refs), atol=1e-6,
                                   rtol=0)
        # serving: one all-gather per output, nothing else; each rank's
        # rows (and the gathered whole) equal the one-device rows
        assert info["serve/counts"] == {"all_gather": 2}, info
        for got, want, jax_want in zip(
                (arr["serve/probs"], arr["serve/attr"]),
                refs["want"]["serve"], refs["want"]["serve_jax"]):
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
            np.testing.assert_allclose(got, jax_want, rtol=2e-5, atol=2e-6)


def _check_surrogate_step(want, ranks):
    """`train_surrogate`'s step and eval over 2 ranks (the generic
    `make_train_step` / `make_eval_step`; ragged: rank 1 holds padding
    only) against one process: the losses within 1e-6 relative, the
    gathered rows within 1e-6, the parameters as `_check_steps` holds
    them; one all-reduce (gradients, loss, cls) and one all-gather (the
    rows) for the step, the same for the eval."""
    g_max = max(np.abs(g).max() for g in want["grads"].values())
    for info, arr in ranks:
        for name in ("kld", "cls"):
            np.testing.assert_allclose(arr[f"surrogate/{name}"], want[name],
                                       rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(arr["surrogate/adapt"], want["adapt"],
                                   atol=1e-6, rtol=0)
        for i, w in enumerate(want["evals"]):
            np.testing.assert_allclose(arr[f"surrogate/eval{i}"], w,
                                       rtol=1e-6, atol=1e-7, err_msg=i)
        for k, w in want["params"].items():
            got = arr[f"surrogate/params/{k}"]
            g = want["grads"].get(k)
            sure = (np.ones(w.shape, bool) if g is None
                    else np.abs(g) > 1e-4 * g_max)
            assert np.all(np.abs(got - w)[~sure] <= 2.02e-3), k
            np.testing.assert_allclose(got[sure], w[sure], atol=1e-6,
                                       rtol=0, err_msg=k)
        assert info["surrogate/counts"] == {"all_reduce": 2,
                                            "all_gather": 2}, info


def _one_device_probs(refs):
    from autognothi_tpu_torch.params import from_jax_params
    from tests.torch_port_dist_child import _recipe

    data = np.load(refs["inputs"])
    recipe = _recipe("vanilla")
    cfg = recipe.t_config(**refs["cfgs"]["vanilla"])
    srg = from_jax_params({k[len("vanilla/srg/"):]: data[k]
                           for k in data.files
                           if k.startswith("vanilla/srg/")},
                          cfg, torch.device("cpu"), section="surrogate")
    xs = torch.from_numpy(data["xs"])
    with torch.no_grad():
        return recipe.fw_surrogate(cfg, srg, xs, torch.ones(
            (B, recipe.n_players(cfg)), dtype=torch.int32))[0].numpy()


def test_dp2_x_tp2_steps(refs):
    """World 4 as a (2 data x 2 model) mesh: both families, full and
    ragged (the second data rank holds only padding)."""
    cases = [c for c in CASES if c["model"] == 2]
    ranks = run_world(_spec(refs, "w4", ["steps"], cases), 4, refs["tmp"])
    _check_steps(refs, ranks, cases)
    for info, _ in ranks:
        for case in cases:
            assert info[f"{case['name']}/counts"].get("all_gather", 0) == 0


def test_check_shardable_fails_closed_at_model_3():
    """The mini width 32 does not divide model = 3: one ValueError naming
    the weights (JAX tests/test_scaleout.py:165)."""
    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.parallel.mesh import (check_shardable,
                                                    param_pspec, shard_params)
    from tests.torch_port_dist_child import _recipe

    cfg, _, _, exp, _ = _jax_case("vanilla")
    recipe = _recipe("vanilla")
    model = from_jax_params(exp, recipe.t_config(**cfg.model_dump()),
                            torch.device("cpu"), section="explainer")
    mesh = {"data": 2, "model": 3}
    with pytest.raises(ValueError, match=r"model_parallel.*divides") as err:
        shard_params(model, mesh)
    assert "query.weight" in str(err.value)
    # nothing was sliced on the way to the refusal
    assert all(p.shape == tuple(exp[k].shape)
               for k, p in model.named_parameters())
    items = [(k, v.shape, param_pspec(k, v.ndim)) for k, v in exp.items()]
    check_shardable(items, {"data": 4, "model": 2})  # 32 / 2 divides


def test_ltt_param_pspec_covers_side_ladders():
    """Every side-ladder attention / MLP weight of the LTT explainer gets a
    "model" spec (JAX tests/test_scaleout.py:81); the trunk -> ladder maps
    and the explainer head stay replicated by design; the port's specs are
    the JAX package's for every parameter."""
    from autognothi_tpu.parallel.mesh import param_pspec as jax_pspec
    from autognothi_tpu_torch.parallel.mesh import param_pspec

    _, _, _, exp, _ = _jax_case("ltt")
    ladder_w = [k for k in exp
                if (".s_attn_layers." in k or "s_explainer_attn." in k)
                and k.endswith((".query.weight", ".key.weight",
                                ".value.weight", "intermediate.dense.weight",
                                "attention.output.dense.weight",
                                ".output.dense.weight"))]
    assert ladder_w
    for k in ladder_w:
        assert "model" in param_pspec(k, exp[k].ndim), k
    for k, v in exp.items():
        assert param_pspec(k, v.ndim) == tuple(jax_pspec(k, v.ndim)), k
        if k.startswith(("vit.encoder.s_attn_maps.", "s_explainer_mlp.")):
            assert "model" not in param_pspec(k, v.ndim), k
