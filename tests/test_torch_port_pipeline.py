"""Port parity, pipeline parallelism (M10b): `parallel/pipeline.py` and the
explainer step of `pipeline/pp_trainer.py`, run by four gloo processes on
the CPU (tests/torch_port_pp_child.py) over (data 2 x pipe 2),
(data 1 x pipe 4) and (data 1 x pipe 2 x model 2) meshes, against the JAX
package's sequential functions on the same numpy inputs, and against the
port's one-process step.  It mirrors the JAX package's
tests/test_pipeline_parallel.py on its mini configs (`_mini_cfg`,
`_mini_bert_cfg`, dropout 0), pallas mode "0".

Bounds:
- forwards and gradients against JAX: that test's own, rtol 1e-5 / atol
  1e-6 (1e-4 / 1e-5 with tensor parallelism, whose all-reduce reorders
  sums; gradients rtol 1e-4);
- the explainer step against the JAX one-device step: loss within 1e-5,
  parameters rtol 5e-3 / atol 5e-4 (tests/test_train_pp.py:79-91);
  against the port's one-process step: loss and settled parameters
  within 1e-6 (tests/test_torch_port_scaleout.py's rule for "settled");
  the same tensors bit-identical across ranks;
- the classifier train step of `make_pp_classifier_train_step` against
  the same step in one process: loss and settled parameters within 1e-6.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_port_scaleout import (LR, M, _jax_step, _port_step,
                                            run_world)

B = 8
ATOL_SETTLED = 1e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX references, the inputs, and one world of 4 ranks running
    the "modules", "steps" and "teacher" jobs."""
    import jax
    import jax.numpy as jnp

    from autognothi_tpu.models.bert import (bert_classifier_fwd,
                                            bert_embeddings, bert_encoder,
                                            bert_explainer_fwd,
                                            init_bert_classifier,
                                            init_bert_explainer)
    from autognothi_tpu.models.common import additive_mask_bias, subdict
    from autognothi_tpu.models.vit import (init_vit_classifier,
                                           init_vit_explainer,
                                           vit_classifier_fwd,
                                           vit_embeddings, vit_encoder,
                                           vit_explainer_fwd)
    from autognothi_tpu.recipes.vanilla_vit import vanilla_vit_recipe
    from tests.test_pipeline_parallel import _mini_bert_cfg, _mini_cfg

    tmp = tmp_path_factory.mktemp("pipeline")
    np_ = lambda t: {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    cfg, bcfg = _mini_cfg(), _mini_bert_cfg()
    p = init_vit_classifier(jax.random.PRNGKey(0), cfg)
    vp = subdict(p, "vit.")
    rs = np.random.RandomState(0)
    pixels = rs.randn(8, 3, 16, 16).astype(np.float32)
    mask = rs.randint(0, 2, (8, cfg.n_patches + 1)).astype(np.float32)
    ones = np.ones((8, cfg.n_patches + 1), np.float32)
    h0 = vit_embeddings(vp, cfg, jnp.asarray(pixels))
    probe = np.random.RandomState(1).randn(
        8, cfg.n_patches + 1, cfg.hidden_size).astype(np.float32)

    def probe_loss(q, h):
        return jnp.sum(vit_encoder(q, cfg, h, mask) * probe)

    g_h0 = jax.grad(lambda h: probe_loss(vp, h))(h0)
    g_w = jax.grad(lambda q: probe_loss(q, h0))(vp)
    pe = init_vit_explainer(jax.random.PRNGKey(8), cfg)
    rs9 = np.random.RandomState(9)
    grand = rs9.randn(8, cfg.num_labels).astype(np.float32)
    null = rs9.randn(1, cfg.num_labels).astype(np.float32)
    bp = init_bert_classifier(jax.random.PRNGKey(4), bcfg)
    bpe = init_bert_explainer(jax.random.PRNGKey(10), bcfg)
    ids = np.random.RandomState(6).randint(0, 64, (8, 12))
    attn, ttype = np.ones((8, 12), np.int32), np.zeros((8, 12), np.int32)
    bh0 = bert_embeddings(subdict(bp, "bert."), bcfg, jnp.asarray(ids),
                          jnp.asarray(ttype))
    bias = additive_mask_bias(jnp.asarray(attn))
    n_lab = bcfg.num_labels
    want = {
        "enc_mask": vit_encoder(vp, cfg, h0, mask),
        "enc_nomask": vit_encoder(vp, cfg, h0, None),
        "grad_h0": g_h0,
        "cls": vit_classifier_fwd(p, cfg, pixels, ones)[0],
        "exp": vit_explainer_fwd(pe, cfg, pixels, ones, grand, null)[0],
        "bert_enc": bert_encoder(subdict(bp, "bert."), bcfg, bh0, bias),
        "bert_cls": bert_classifier_fwd(bp, bcfg, ids, attn, ttype)[0],
        "bert_exp": bert_explainer_fwd(bpe, bcfg, ids, attn, ttype,
                                       grand[:, :n_lab], null[:, :n_lab])[0],
    }
    want = {k: np.asarray(v) for k, v in want.items()}
    want["grads"] = {f"vit.{k}": np.asarray(v) for k, v in g_w.items()
                     if k.startswith("encoder.layers.")}
    cfg12 = _mini_cfg(layers=12)
    arrays = {
        "pixels": pixels, "mask": mask, "h0": np.asarray(h0),
        "probe": probe, "grand": grand, "null": null, "ids": ids,
        "bert_bias": np.asarray(bias), "bert_h0": np.asarray(bh0),
        "labels": np.random.RandomState(2).randint(0, 3, (8,)),
        **{f"vit/cls/{k}": v for k, v in np_(p).items()},
        **{f"vit/exp/{k}": v for k, v in np_(pe).items()},
        **{f"bert/cls/{k}": v for k, v in np_(bp).items()},
        **{f"bert/exp/{k}": v for k, v in np_(bpe).items()},
        **{f"vit12/cls/{k}": v for k, v in np_(init_vit_classifier(
            jax.random.PRNGKey(0), cfg12)).items()},
    }
    # the explainer step (tests/test_train_pp.py:416's setup)
    recipe = vanilla_vit_recipe()
    exp0 = np_(init_vit_explainer(jax.random.PRNGKey(21), cfg))
    srg0 = np_(init_vit_classifier(jax.random.PRNGKey(22), cfg))
    xs = np.random.RandomState(23).randn(
        B, 3, cfg.img_px_size, cfg.img_px_size).astype(np.float32)
    step_null, _ = recipe.fw_surrogate(
        cfg, srg0, jnp.zeros((1, 3, 16, 16)),
        jnp.ones((1, recipe.n_players(cfg)), jnp.int32))
    step_null = np.asarray(step_null)
    weights = np.ones(B, np.float32)
    jax_loss, jax_params, masks = _jax_step("vanilla", cfg, recipe, srg0,
                                            exp0, step_null, xs, weights)
    cfg_dict = cfg.model_dump()
    port_loss, port_params, grads = _port_step(
        "vanilla", cfg_dict, srg0, exp0, step_null, xs, masks, weights)
    g_max = max(np.abs(g).max() for g in grads.values())
    want["step"] = dict(jax=(jax_loss, jax_params),
                        port=(port_loss, port_params),
                        settled={k: np.abs(g) > 1e-4 * g_max
                                 for k, g in grads.items()})
    arrays.update({"xs": xs, "masks": masks, "step_null": step_null,
                   **{f"vit/srg/{k}": v for k, v in srg0.items()}})
    want["srg_step"] = _surrogate_refs(cfg, srg0, xs, arrays)
    # the explainer step's parameters are init_vit_explainer(21)'s: the
    # "vit/exp/" entries above are the forwards' (8); keep both apart
    arrays.update({f"step/exp/{k}": v for k, v in exp0.items()})
    np.savez(tmp / "inputs.npz", **arrays)
    cfgs = {"vit": cfg_dict, "bert": bcfg.model_dump(),
            "vit12": cfg12.model_dump(),
            "vit_dropout": dict(cfg_dict, hidden_dropout_prob=0.3)}
    spec = dict(tag="pp", jobs=["modules", "steps", "surrogate_step",
                                "teacher"], cfgs=cfgs,
                inputs=str(tmp / "inputs.npz"), m=M, lr=LR,
                cases=[dict(name="dp2_pp2", mb=2, tp=1),
                       dict(name="pp2_tp2", mb=2, tp=2)])
    ranks = run_world(spec, 4, tmp, module="tests.torch_port_pp_child")
    return dict(ranks=ranks, want=want, cfg=cfg, arrays=arrays)


def _surrogate_refs(cfg, srg0, xs, arrays):
    """One `train_surrogate` step (the trainer's loss, all trainable) in
    the JAX package and in the port's one process, mode "0", on the same
    coalition mask, teacher rows and labels -> their (loss, cls,
    parameters) and the port's settled mask; the inputs go to
    `arrays`."""
    import jax
    import jax.numpy as jnp

    from autognothi_tpu.ops.shapley import loss_logits_kl_divergence as j_kl
    from autognothi_tpu.pipeline import training as jt
    from autognothi_tpu.recipes.vanilla_vit import vanilla_vit_recipe
    from autognothi_tpu_torch.models.common import pallas_override
    from autognothi_tpu_torch.params import from_jax_params, to_flat
    from autognothi_tpu_torch.pipeline.train_surrogate import surrogate_loss
    from autognothi_tpu_torch.pipeline.training import AdamW, make_train_step
    from autognothi_tpu_torch.recipes.vanilla_vit import \
        vanilla_vit_recipe as port_recipe

    rng = np.random.RandomState(31)
    mask = (rng.rand(B, cfg.n_patches) > 0.4).astype(np.int32)
    orig = rng.dirichlet(np.ones(cfg.num_labels), B).astype(np.float32)
    labels = rng.randint(0, cfg.num_labels, B).astype(np.int64)
    weights = np.ones(B, np.float32)
    arrays.update({"srg_mask": mask, "srg_orig": orig,
                   "srg_labels": labels})
    recipe = vanilla_vit_recipe()

    def loss_fn(p, xs_, mask_, orig_, labels_, rng_, ltt, w):
        adapt, _ = recipe.fw_surrogate(cfg, p, xs_, mask_)
        return j_kl(orig_, adapt, w), (jt.cross_entropy_on_probs(
            adapt, labels_, w), adapt)

    params = {k: jnp.asarray(v) for k, v in srg0.items()}
    tx, opt = jt.make_optimizer(params, lambda k: True)
    new, _, loss, (cls, _) = jt.make_train_step(tx, loss_fn)(
        params, opt, jnp.asarray(LR), jt.ones_mask(params), jnp.asarray(xs),
        jnp.asarray(mask), jnp.asarray(orig), jnp.asarray(labels), None,
        None, jnp.asarray(weights))
    jax_ref = (float(loss), float(cls),
               {k: np.asarray(v) for k, v in new.items()})
    pcfg = port_recipe().t_config(**cfg.model_dump())
    model = from_jax_params(srg0, pcfg, torch.device("cpu"),
                            section="surrogate")
    params_t = dict(model.named_parameters())
    opt_t, grads = AdamW(params_t, lambda k: True), {}
    real = opt_t.update

    def spy(p_, g, lr, m):
        grads.update({k: v.detach().numpy().copy() for k, v in g.items()})
        return real(p_, g, lr, m)

    opt_t.update = spy
    step = make_train_step(surrogate_loss(port_recipe(), pcfg, False))
    with pallas_override("0"):
        kld, (cls_t, _) = step(
            model, opt_t, LR, {k: 1.0 for k in params_t},
            *(torch.from_numpy(a) for a in (xs, mask, orig, labels)), None,
            None, torch.from_numpy(weights))
    g_max = max(np.abs(g).max() for g in grads.values())
    return dict(jax=jax_ref, port=(kld.item(), cls_t.item(), to_flat(model)),
                settled={k: np.abs(g) > 1e-4 * g_max
                         for k, g in grads.items()})


def _rows(ranks, name):
    """The last stage's rows of `name` in data-rank order (every model
    rank's copy identical)."""
    parts = {}
    for _, arr in ranks:
        for k, v in arr.items():
            if k.startswith(name + "/d"):
                d, m = k[len(name) + 2:].split("m")
                if int(d) in parts:
                    np.testing.assert_array_equal(v, parts[int(d)], err_msg=k)
                parts[int(d)] = v
    assert parts, name
    return np.concatenate([parts[d] for d in sorted(parts)])


def _close(world, name, tags=("p2", "p4"), rtol=1e-5, atol=1e-6):
    for tag in tags:
        np.testing.assert_allclose(_rows(world["ranks"], f"{name}/{tag}"),
                                   world["want"][name], rtol=rtol, atol=atol,
                                   err_msg=f"{name} {tag}")


def test_pp_vit_encoder_matches_scan(world):
    _close(world, "enc_mask")


def test_pp_vit_encoder_no_mask(world):
    _close(world, "enc_nomask")


def test_pp_grads_match(world):
    """The probe's gradients through the pipe's backward: h0's (the first
    stage's leaf) and every layer's weights (summed over "data")."""
    for tag in ("p2", "p4"):
        np.testing.assert_allclose(_rows(world["ranks"], f"grad_h0/{tag}"),
                                   world["want"]["grad_h0"], rtol=1e-4,
                                   atol=1e-6)
        seen = set()
        for _, arr in world["ranks"]:
            for k, v in arr.items():
                if k.startswith(f"grad/{tag}/"):
                    name = k[len(f"grad/{tag}/"):]
                    np.testing.assert_allclose(
                        v, world["want"]["grads"][name], rtol=1e-4,
                        atol=1e-6, err_msg=k)
                    seen.add(name)
        assert seen == set(world["want"]["grads"]), tag


def test_pp_fwd_parity_vs_plain_classifier(world):
    _close(world, "cls")


def test_pp_vit_explainer_fwd_parity(world):
    _close(world, "exp")
    assert world["want"]["exp"].shape == (8, 3, 4)


def test_pp_bert_encoder_matches_scan(world):
    _close(world, "bert_enc")


def test_pp_bert_classifier_fwd_parity(world):
    _close(world, "bert_cls")


def test_pp_bert_explainer_fwd_parity(world):
    _close(world, "bert_exp")


def test_pp_dropout_iid_across_microbatches_and_ranks(world):
    """8 identical rows on (data 2 x pipe 2) x 2 microbatches at dropout
    0.3: rows of different microbatches (0 vs 2) and data ranks (0 vs 4)
    differ; the same base seed reproduces exactly."""
    out = _rows(world["ranks"], "dropout/0")
    assert not np.allclose(out[0], out[2]), "microbatches share masks"
    assert not np.allclose(out[0], out[4]), "data ranks share masks"
    np.testing.assert_array_equal(out, _rows(world["ranks"], "dropout/1"))


def _one_process_classifier_step(world):
    """`make_pp_classifier_train_step`'s first step in one process: the
    same loss and AdamW on the whole classifier, mode "0"."""
    from autognothi_tpu_torch.models.common import pallas_override
    from autognothi_tpu_torch.models.vit import VanillaViTConfig, \
        vit_classifier_fwd
    from autognothi_tpu_torch.params import from_jax_params, to_flat
    from autognothi_tpu_torch.pipeline.training import AdamW

    a = world["arrays"]
    cfg = VanillaViTConfig(**world["cfg"].model_dump())
    model = from_jax_params({k[8:]: v for k, v in a.items()
                             if k.startswith("vit/cls/")}, cfg,
                            torch.device("cpu"), section="classifier")
    params = dict(model.named_parameters())
    opt = AdamW(params, lambda k: True)
    with pallas_override("0"):
        probs, _ = vit_classifier_fwd(
            model, cfg, torch.from_numpy(a["pixels"]),
            torch.ones((8, cfg.n_patches + 1)))
    labels = torch.from_numpy(a["labels"])
    loss = -torch.log(torch.clamp(probs, min=1e-9)).gather(
        1, labels[:, None]).mean()
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    opt.update(params, grads, 1e-3, {k: 1.0 for k in params})
    return loss.item(), to_flat(model), {k: g.numpy() for k, g in
                                          grads.items()}


def test_pp_classifier_train_step_stage_sharded(world):
    """Four steps of the pipelined classifier step on each layout: the loss
    decreases, every rank logs the same losses, and the first step's
    merged parameters and loss match the one-process step's (settled
    parameters within 1e-6, the rest within 2 lr)."""
    loss, params, grads = _one_process_classifier_step(world)
    g_max = max(np.abs(g).max() for g in grads.values())
    for tag in ("p2", "p4", "tp"):
        losses = [info[f"step/{tag}/losses"] for info, _ in world["ranks"]]
        assert all(ls == losses[0] for ls in losses), tag
        assert losses[0][-1] < losses[0][0], losses[0]
        assert abs(losses[0][0] - loss) <= 1e-6, (tag, losses[0][0], loss)
        merged = world["ranks"][0][1]
        got = {k[len(f"step/{tag}/"):]: v for k, v in merged.items()
               if k.startswith(f"step/{tag}/")}
        assert set(got) == set(params), tag
        for k, w in params.items():
            sure = np.abs(grads[k]) > 1e-4 * g_max
            assert np.all(np.abs(got[k] - w)[~sure] <= 2.02e-3), k
            np.testing.assert_allclose(got[k][sure], w[sure],
                                       atol=ATOL_SETTLED, rtol=0,
                                       err_msg=f"{tag} {k}")


def test_pp_hop_count_per_step(world):
    """One step moves M activations forward and M gradients back across
    each stage boundary, and no weight: per rank M sends and M receives
    for each neighbour; the data-parallel layout adds one flat all-reduce
    of the gradients, the pipe layouts none."""
    m = 2
    for tag, n_pipe in (("p2", 2), ("p4", 4), ("tp", 2)):
        for r, (info, _) in enumerate(world["ranks"]):
            stage = {"p2": r % 2, "p4": r, "tp": r // 2}[tag]
            neighbours = (stage > 0) + (stage < n_pipe - 1)
            assert info[f"step/{tag}/hops"] == {
                "gloo send": m * neighbours,
                "gloo recv": m * neighbours}, (tag, r, info)
            counts = info[f"step/{tag}/counts"]
            assert counts.get("all_gather", 0) == 0, (tag, counts)
            if tag == "p2":
                assert counts.get("all_reduce") == 1, (tag, counts)
            if tag == "p4":
                assert counts.get("all_reduce", 0) == 0, (tag, counts)


def test_pp_train_step_pins_pallas_and_quant(world):
    """AUTOGNOTHI_PALLAS=2 with AUTOGNOTHI_INT8=1 exported gives the step
    the same loss as mode "0": the differentiated forward pins both."""
    for info, _ in world["ranks"]:
        assert info["pins"][0] == info["pins"][1], info["pins"]


def test_pp_per_rank_memory_scales_1_over_p(world):
    """After a step of the 12-layer mini, each rank's encoder stack is 1/P
    of the whole, and its AdamW moments are twice its own parameters:
    nothing of another stage is held."""
    from tests.test_pipeline_parallel import _mini_cfg

    arrays = world["arrays"]
    full = sum(v.nbytes for k, v in arrays.items()
               if k.startswith("vit12/cls/vit.encoder.layers."))
    whole = sum(v.nbytes for k, v in arrays.items()
                if k.startswith("vit12/cls/"))
    assert _mini_cfg(layers=12).num_hidden_layers == 12
    for tag, n_pipe in (("p2", 2), ("p4", 4)):
        got = [info[f"memory/{tag}/r{r}"]
               for r, (info, _) in enumerate(world["ranks"])]
        assert sum(g[1] for g in got) == whole * 4 // n_pipe, (tag, got)
        for stack, total, moments in got:
            assert stack == full // n_pipe, (tag, stack, full)
            assert moments == 2 * total, (tag, total, moments)


def test_pp_fail_closed(world):
    errors = world["ranks"][0][0]["errors"]
    assert "divide pipe" in errors["layers"], errors
    assert "does not divide" in errors["microbatches"], errors
    assert "not divisible by pipe=3" in errors["mesh"], errors
    assert "not divisible by pipe=2 x model=3" in errors["mesh_tp"], errors
    assert "batch_size=6" in errors["batch"], errors


def test_pp_world_of_one_refuses():
    """AUTOGNOTHI_PP=2 in a world of one raises: it never trains
    sequentially."""
    from autognothi_tpu_torch.parallel.pipeline import make_pipe_mesh

    with pytest.raises(ValueError, match="not divisible by pipe=2"):
        make_pipe_mesh(pipe=2)


def test_pp_tp_mesh_and_shardings(world):
    """(data 1 x pipe 2 x model 2): a stage's query weight is its
    (hidden / 2, hidden) column shard."""
    cfg = world["cfg"]
    for info, _ in world["ranks"]:
        assert info["tp/query_shape"] == [cfg.hidden_size // 2,
                                          cfg.hidden_size]


def test_pp_tp_vit_classifier_fwd_parity(world):
    _close(world, "cls", ("tp",), rtol=1e-4, atol=1e-5)
    for r, (info, _) in enumerate(world["ranks"]):
        # two all-reduces per layer of the stage (2 layers) and microbatch
        # (2); the hops are point-to-point
        assert info["tp/fwd_counts"] == {"all_reduce": 8}, (r, info)


def test_pp_tp_vit_explainer_fwd_parity(world):
    _close(world, "exp", ("tp",), rtol=1e-4, atol=1e-5)


def test_pp_tp_bert_classifier_fwd_parity(world):
    _close(world, "bert_cls", ("tp",), rtol=1e-4, atol=1e-5)
    _close(world, "bert_exp", ("tp",), rtol=1e-4, atol=1e-5)


def test_pp_tp_train_step(world):
    """The classifier step with tensor parallelism inside the stages: more
    all-reduces than the pipe-only layout (the f/g pairs), no all-gather,
    the loss decreases (parity: test_pp_classifier_train_step_...)."""
    for info, _ in world["ranks"]:
        counts = info["step/tp/counts"]
        assert counts.get("all_reduce", 0) > 0, counts
        losses = info["step/tp/losses"]
        assert losses[-1] < losses[0], losses


def test_split_encoder_params_fails_closed_on_ragged_stack(world):
    """A stray or missing layer key raises before anything is built."""
    from autognothi_tpu_torch.models.vit import VanillaViTConfig
    from autognothi_tpu_torch.parallel.pipeline import split_encoder_params

    cfg = VanillaViTConfig(**world["cfg"].model_dump())
    flat = {k[8:]: v for k, v in world["arrays"].items()
            if k.startswith("vit/cls/")}
    mesh = {"data": 1, "pipe": 2}
    stray = dict(flat, **{"vit.encoder.layers.3.extra.weight":
                          np.zeros((2,), np.float32)})
    with pytest.raises(ValueError, match="refusing to silently drop"):
        split_encoder_params(stray, 4, mesh, cfg=cfg, section="classifier",
                             device=torch.device("cpu"))
    gap = {k: v for k, v in flat.items()
           if k != "vit.encoder.layers.2.attention.self.query.weight"}
    with pytest.raises(ValueError, match="missing"):
        split_encoder_params(gap, 4, mesh, cfg=cfg, section="classifier",
                             device=torch.device("cpu"))


def test_pp_tp_fail_closed():
    """Hidden dims that do not divide the model axis raise at split time,
    every offending weight named, before anything is materialized."""
    import jax

    from autognothi_tpu.models.vit import init_vit_classifier
    from autognothi_tpu_torch.models.vit import VanillaViTConfig
    from autognothi_tpu_torch.parallel.pipeline import split_encoder_params
    from tests.test_pipeline_parallel import _mini_cfg

    cfg = _mini_cfg().model_copy(update={"hidden_size": 36,
                                         "intermediate_size": 72})
    flat = {k: np.asarray(v) for k, v in
            init_vit_classifier(jax.random.PRNGKey(0), cfg).items()}
    with pytest.raises(ValueError, match="cannot shard") as err:
        split_encoder_params(flat, 4, {"data": 1, "pipe": 1, "model": 8},
                             cfg=VanillaViTConfig(**cfg.model_dump()),
                             section="classifier",
                             device=torch.device("cpu"))
    assert "query.weight" in str(err.value)


def _check_step(world, name):
    want = world["want"]["step"]
    jax_loss, jax_p = want["jax"]
    port_loss, port_p = want["port"]
    ranks = world["ranks"]
    loss = ranks[0][0][f"{name}/loss"]
    assert all(info[f"{name}/loss"] == loss for info, _ in ranks), name
    assert abs(loss - jax_loss) < 1e-5, (name, loss, jax_loss)
    assert abs(loss - port_loss) <= 1e-6, (name, loss, port_loss)
    got = {k[len(name) + 1:]: v for k, v in ranks[0][1].items()
           if k.startswith(name + "/") and "/rank/" not in k}
    assert set(got) == set(jax_p), name
    for k, w in jax_p.items():
        np.testing.assert_allclose(got[k], w, rtol=5e-3, atol=5e-4,
                                   err_msg=f"{name} {k} vs JAX")
        sure = want["settled"].get(k, np.ones(w.shape, bool))
        assert np.all(np.abs(got[k] - port_p[k])[~sure] <= 2.02 * LR), k
        np.testing.assert_allclose(got[k][sure], port_p[k][sure],
                                   atol=ATOL_SETTLED, rtol=0,
                                   err_msg=f"{name} {k} vs port")
    # the same tensor is bit-identical on every rank that holds it
    held = {}
    for _, arr in ranks:
        for k, v in arr.items():
            if k.startswith(f"{name}/rank/"):
                key = k[len(f"{name}/rank/"):]
                if key in held:
                    np.testing.assert_array_equal(v, held[key], err_msg=key)
                held[key] = v
    assert set(held) == set(jax_p)
    return ranks


def test_pp_explainer_step_dp2_pp2(world):
    """`setup_pp_explainer` over (data 2 x pipe 2), microbatches 2: one
    step against the JAX one-device step and the port's one-process
    step; 2 M hops a boundary, one flat all-reduce over "data"."""
    ranks = _check_step(world, "dp2_pp2")
    for info, _ in ranks:
        assert info["dp2_pp2/hops"] == {"gloo send": 2, "gloo recv": 2}
        assert info["dp2_pp2/counts"].get("all_gather", 0) == 0
        assert np.isfinite(info["dp2_pp2/eval"])


def test_pp_tp_explainer_step_matches_sequential(world):
    """PP x TP (data 1 x pipe 2 x model 2): the teacher Megatron-sharded
    in mode "0", the stages tensor-parallel; the same bounds."""
    ranks = _check_step(world, "pp2_tp2")
    for info, _ in ranks:
        assert info["pp2_tp2/counts"].get("all_reduce", 0) > 0
        assert np.isfinite(info["pp2_tp2/eval"])


def test_pp_surrogate_step_matches_sequential(world):
    """`setup_pp_surrogate`'s step over (data 2 x pipe 2) on the JAX
    step's mask, teacher rows and labels: the KL loss and the cls metric
    against the JAX step (1e-5) and the port's one-process step (1e-6),
    the parameters at the JAX bound and at 1e-6 where settled; every rank
    logs the same rows."""
    want = world["want"]["srg_step"]
    jax_kld, jax_cls, jax_p = want["jax"]
    kld, cls, port_p = want["port"]
    ranks = world["ranks"]
    info0, arr0 = ranks[0]
    for info, arr in ranks:
        assert info["srg/loss"] == info0["srg/loss"]
        np.testing.assert_array_equal(arr["srg/adapt"], arr0["srg/adapt"])
    assert abs(info0["srg/loss"] - jax_kld) < 1e-5
    assert abs(info0["srg/cls"] - jax_cls) < 1e-5
    assert abs(info0["srg/loss"] - kld) <= 1e-6
    assert abs(info0["srg/cls"] - cls) <= 1e-6
    got = {k[len("srg/p/"):]: v for k, v in arr0.items()
           if k.startswith("srg/p/")}
    assert set(got) == set(jax_p)
    for k, w in jax_p.items():
        np.testing.assert_allclose(got[k], w, rtol=5e-3, atol=5e-4,
                                   err_msg=k)
        sure = want["settled"][k]
        assert np.all(np.abs(got[k] - port_p[k])[~sure] <= 2.02 * LR), k
        np.testing.assert_allclose(got[k][sure], port_p[k][sure],
                                   atol=ATOL_SETTLED, rtol=0, err_msg=k)


def one_device_teacher_calls(cfg_dict, srg, xs, masks) -> dict:
    """The kernel ops the port's one-device teacher dispatches on these
    rows, pallas mode "2" (W8A8, the teacher's default)."""
    from autognothi_tpu_torch.models.common import pallas_override
    from autognothi_tpu_torch.models.vit import VanillaViTConfig
    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.parallel import train_step as ts
    from autognothi_tpu_torch.recipes.vanilla_vit import vanilla_vit_recipe
    from tests.torch_port_pp_child import _spy_dispatch

    cfg = VanillaViTConfig(**cfg_dict)
    model = from_jax_params(srg, cfg, torch.device("cpu"),
                            section="surrogate")
    calls = {"teacher": {}}
    with _spy_dispatch(calls, {"now": "teacher"}), torch.no_grad(), \
            pallas_override("2"):
        ts._teacher(vanilla_vit_recipe(), cfg, model, torch.from_numpy(xs),
                    torch.from_numpy(masks))
    assert set(calls["teacher"]) == {"attention_block_int8",
                                     "mlp_block_int8"}, calls
    return calls["teacher"]


def check_teacher_on_pipe_mesh(ranks, want: dict) -> None:
    """Every rank's teacher ran the one-device teacher's kernel calls in
    mode "2"; the differentiated forward reached none (mode "0")."""
    for info, _ in ranks:
        got = info["teacher"]
        assert got["teacher"] == want, (got, want)
        assert got["modes"] == ["2"], got
        assert got["other"] == {}, got


def test_pp_teacher_keeps_its_kernels_on_a_pipe_mesh(world):
    """The explainer step's teacher on a mesh of one data rank (data 1 x
    pipe 4) runs the kernel ops, W8A8, on every rank, as many calls of
    each as the one-device teacher on the same rows (the JAX teacher's
    `sharded_call` on a mesh without a "model" axis); the differentiated
    forward reaches none (mode "0").  The (data 1 x pipe 2) mesh:
    tests/test_torch_port_pp_train.py."""
    a = world["arrays"]
    want = one_device_teacher_calls(
        world["cfg"].model_dump(),
        {k[8:]: v for k, v in a.items() if k.startswith("vit/srg/")},
        a["xs"], a["masks"])
    check_teacher_on_pipe_mesh(world["ranks"], want)
