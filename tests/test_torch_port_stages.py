"""Port parity, the training pipeline: the classifier and surrogate train
steps, the four conversions, `train_classifier` and `train_all` through the
port's CLI, optimizer-state checkpoints, the refusals, and the ladder's
route rule on the card (K5, F7), all against the JAX package on the same
numpy inputs made from a seed (mini LTT ViT of tests/test_ltt_e2e.py).

The step comparison (hidden 32, 2 layers, side 16, T = 17, B = 4), of the
loss (relative), each trainable gradient (within tol x the largest
gradient) and the updated parameters, as tests/test_torch_port_train.py
holds the explainer step:
- mode "0" (plain math) against the JAX XLA step: 1e-5;
- mode "2": the classifier's fused float ops (their plain versions on the
  CPU) against the JAX kernels interpreted, 1e-5; the surrogate with its
  int8 teacher (AUTOGNOTHI_INT8=1, K1 + K2) against the JAX teacher's int8
  kernels interpreted, 2e-5 (the bound of tests/test_torch_port_int8.py);
- mode "1" (the masked attention op) against JAX's interpreted: 1e-5.
The surrogate's coalition masks are drawn once with numpy and handed to
both packages (`jax.random` streams cannot be reproduced).  A gradient the
JAX step gives below 1e-4 of the largest is 0 by structure (under the
classifier's all-ones mask a key bias adds a per-query constant the
softmax ignores) and both packages' values are held below 1e-4 x max|g|.
Parameters the conversions make anew (`New()`) are held by shape and by
the init's law; copied parameters bit for bit.
"""

import contextlib
import json
import os
import pathlib
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autognothi_tpu.models import ltt_vit as jax_ltt
from autognothi_tpu.models.common import quant_override as jax_quant_override
from autognothi_tpu.ops.shapley import \
    loss_logits_kl_divergence as jax_kl
from autognothi_tpu.pipeline import training as jax_training
from autognothi_tpu.recipes import ltt_vit as jax_recipe_mod
from autognothi_tpu_torch.params import from_jax_params
from autognothi_tpu_torch.pipeline.train_classifier import classifier_loss
from autognothi_tpu_torch.pipeline.train_surrogate import (surrogate_loss,
                                                           surrogate_teacher)
from autognothi_tpu_torch.pipeline.training import AdamW, make_train_step
from autognothi_tpu_torch.recipes import ltt_vit as port_recipe_mod
from tests.test_ltt_e2e import _ltt_vit_hparams
from tests.test_torch_port_model import MINI

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
STEP = dict(MINI, img_px_size=16, img_patch_size=4)  # 16 players, T = 17
B, LR = 4, 1e-3
ENV_KEYS = ("AUTOGNOTHI_PALLAS", "AUTOGNOTHI_PALLAS_INTERPRET",
            "AUTOGNOTHI_INT8", "AUTOGNOTHI_INT8_TEACHER",
            "AUTOGNOTHI_CKPT_OPT")
TRUNK = ("vit.embeddings.", "vit.encoder.layers.", "vit.layernorm.",
         "classifier.")


@contextlib.contextmanager
def _env(values):
    saved = {k: os.environ.pop(k) for k in ENV_KEYS if k in os.environ}
    try:
        with mock.patch.dict(os.environ, values):
            yield
    finally:
        os.environ.update(saved)


def _np(p):
    return {k: np.asarray(v) for k, v in p.items()}


# ------------------------------------------------- one train step each


def _jax_step(stage, cfg, params, cls, xs, labels, masks):
    """The JAX step's loss, trainable gradients and updated parameters,
    with `loss_fn` as in `train_classifier.py:87-101` and
    `train_surrogate.py:90-102`."""
    recipe = jax_recipe_mod.ltt_vit_recipe()
    p = {k: jnp.asarray(v) for k, v in params.items()}
    trainable = recipe.trainable(cfg, stage)
    tx, opt_state = jax_training.make_optimizer(p, trainable)
    ones_p = jnp.ones((B, recipe.n_players(cfg)), jnp.int32)
    w = jnp.ones((B,), jnp.float32)
    xs, labels = jnp.asarray(xs), jnp.asarray(labels)
    if stage == "classifier":
        def loss_fn(p, xs, mask, labels, rng, ltt_active, weights):
            with jax_quant_override("none"):
                probs, _ = recipe.fw_classifier(
                    cfg, p, xs, mask, deterministic=False, rng=rng,
                    ltt_active_layers=ltt_active)
            return jax_training.cross_entropy_on_probs(probs, labels,
                                                       weights), probs
        batch = (xs, ones_p, labels, jax.random.PRNGKey(9), jnp.int32(2), w)
    else:
        cls_p = {k: jnp.asarray(v) for k, v in cls.items()}
        orig_ys = recipe.fw_classifier(cfg, cls_p, xs, ones_p)[1]

        def loss_fn(p, xs, mask, orig_ys, labels, rng, ltt_active, weights):
            with jax_quant_override("none"):
                adapt_ys, _ = recipe.fw_surrogate(
                    cfg, p, xs, mask, deterministic=False, rng=rng,
                    ltt_active_layers=ltt_active)
            kld = jax_kl(orig_ys, adapt_ys, weights)
            return kld, (jax_training.cross_entropy_on_probs(
                adapt_ys, labels, weights), adapt_ys)
        batch = (xs, jnp.asarray(masks), orig_ys, labels,
                 jax.random.PRNGKey(9), jnp.int32(2), w)
    step = jax_training.make_train_step(tx, loss_fn)
    ones = {k: jnp.ones(()) for k in p}
    new, _, loss, _ = step(p, opt_state, LR, ones, *batch)
    grads = jax.grad(lambda q: loss_fn(q, *batch)[0])(p)
    return (float(loss), {k: np.asarray(v) for k, v in grads.items()
                          if trainable(k)}, _np(new))


def _port_step(stage, params, cls, xs, labels, masks):
    recipe = port_recipe_mod.ltt_vit_recipe()
    cfg = recipe.t_config(**STEP)
    model = from_jax_params(params, cfg, CPU, section=stage)
    trainable = recipe.trainable(cfg, stage)
    for name, p in model.named_parameters():
        p.requires_grad_(trainable(name))
    named = dict(model.named_parameters())
    opt = AdamW(named, trainable)
    seen = {}
    update = opt.update

    def spy(p, grads, lr, mask):
        seen.update({k: v.detach().clone() for k, v in grads.items()
                     if v is not None})
        return update(p, grads, lr, mask)

    opt.update = spy
    t = torch.from_numpy
    ones_p = torch.ones((B, recipe.n_players(cfg)), dtype=torch.int32)
    w = torch.ones(B)
    if stage == "classifier":
        loss_fn = classifier_loss(recipe, cfg, True)
        batch = (t(xs), ones_p, t(labels), None, 2, w)
    else:
        cls_m = from_jax_params(cls, cfg, CPU, section="classifier")
        orig = surrogate_teacher(recipe, cfg)(cls_m, t(xs), ones_p)
        loss_fn = surrogate_loss(recipe, cfg, True)
        batch = (t(xs), t(masks), orig, t(labels), None, 2, w)
    step = make_train_step(loss_fn)
    loss, _ = step(model, opt, LR, {k: 1.0 for k in named}, *batch)
    return (loss.item(), {k: v.numpy() for k, v in seen.items()},
            {k: v.detach().numpy() for k, v in model.state_dict().items()})


INTERPRET = {"AUTOGNOTHI_PALLAS_INTERPRET": "1"}


@pytest.mark.parametrize("stage,setting,jax_env,port_env,tol", [
    ("classifier", "mode0", {"AUTOGNOTHI_PALLAS": "0"},
     {"AUTOGNOTHI_PALLAS": "0"}, 1e-5),
    ("classifier", "mode2", {"AUTOGNOTHI_PALLAS": "2", **INTERPRET}, {},
     1e-5),
    ("classifier", "mode1", {"AUTOGNOTHI_PALLAS": "1", **INTERPRET},
     {"AUTOGNOTHI_PALLAS": "1"}, 1e-5),
    ("surrogate", "mode0", {"AUTOGNOTHI_PALLAS": "0"},
     {"AUTOGNOTHI_PALLAS": "0"}, 1e-5),
    ("surrogate", "int8_teacher", {"AUTOGNOTHI_PALLAS": "2",
                                   "AUTOGNOTHI_INT8": "1", **INTERPRET},
     {"AUTOGNOTHI_INT8": "1"}, 2e-5),
    ("surrogate", "mode1", {"AUTOGNOTHI_PALLAS": "1", **INTERPRET},
     {"AUTOGNOTHI_PALLAS": "1"}, 1e-5),
])
def test_stage_train_step_matches_jax(stage, setting, jax_env, port_env,
                                      tol):
    cfg = jax_ltt.LttViTConfig(**STEP)
    k_c, k_s = jax.random.split(jax.random.PRNGKey(5))
    cls = _np(jax_ltt.init_ltt_vit_surrogate(k_c, cfg))
    params = cls if stage == "classifier" else {
        k: (cls[k] if k.startswith(TRUNK) else v) for k, v in
        _np(jax_ltt.init_ltt_vit_surrogate(k_s, cfg)).items()}
    rng = np.random.RandomState(17)
    xs = rng.randn(B, 3, 16, 16).astype(np.float32)
    labels = rng.randint(0, 3, size=B).astype(np.int32)
    masks = (rng.rand(B, 16) > rng.rand(B, 1)).astype(np.int32)
    with _env(jax_env), mock.patch(
            "autognothi_tpu.parallel.train_step.mesh_safe_pallas",
            contextlib.nullcontext):
        want_loss, want_g, want_p = _jax_step(stage, cfg, params, cls, xs,
                                              labels, masks)
    with _env(port_env):
        loss, got_g, got_p = _port_step(stage, params, cls, xs, labels,
                                        masks)
    assert abs(loss - want_loss) <= tol * abs(want_loss), (loss, want_loss)
    assert set(got_g) == set(want_g)
    g_max = max(np.abs(g).max() for g in want_g.values())
    for k, g in want_g.items():
        if np.abs(g).max() < 1e-4 * g_max:  # 0 by structure
            assert np.abs(got_g[k]).max() <= 1e-4 * g_max, k
            continue
        err = np.abs(got_g[k] - g).max()
        assert err <= tol * g_max, (k, err, g_max)
        moved = np.abs(g) > 1e-4 * g_max
        np.testing.assert_allclose(got_p[k][moved], want_p[k][moved],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in want_p:
        if k not in want_g:  # frozen: unchanged in both
            np.testing.assert_array_equal(got_p[k], params[k])
            np.testing.assert_array_equal(want_p[k], params[k])


def test_classifier_trains_on_the_side_and_the_teacher_is_the_trunk():
    """fw_classifier's order: (side branch-0, trunk) probabilities."""
    recipe = port_recipe_mod.ltt_vit_recipe()
    cfg = recipe.t_config(**STEP)
    flat = recipe.init_classifier(cfg, torch.Generator().manual_seed(3))
    model = from_jax_params(flat, cfg, CPU, section="classifier")
    xs = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(4))
    ones = torch.ones((2, 16), dtype=torch.int32)
    jp = {k: jnp.asarray(v) for k, v in flat.items()}
    with _env({"AUTOGNOTHI_PALLAS": "0"}), torch.no_grad():
        side, trunk = recipe.fw_classifier(cfg, model, xs, ones)
        j_side, j_trunk = jax_recipe_mod.fw_classifier(
            jax_ltt.LttViTConfig(**STEP), jp, jnp.asarray(xs.numpy()),
            jnp.asarray(ones.numpy()))
        h_side, h = port_recipe_mod.fw_classifier_repr(cfg, model, xs, ones)
    np.testing.assert_allclose(side.numpy(), np.asarray(j_side), atol=1e-5)
    np.testing.assert_allclose(trunk.numpy(), np.asarray(j_trunk), atol=1e-5)
    assert not np.allclose(side.numpy(), trunk.numpy())
    assert torch.equal(h_side, side) and h.shape == (2, 17, 32)


# --------------------------------------------------------- conversions


def _law(name, got, want, layout):
    """A parameter drawn anew: its shape, and the JAX init's law -
    LayerNorms exactly ones / zeros; the CLS token and position embeddings
    N(0, 1); every linear (and the patch projection) weight and bias
    U(+-1/sqrt(fan_in)), fan_in read from its weight in `layout`.  Both
    packages' values lie in the law's range; a tensor of 256 values or more
    also has the law's standard deviation (within 10%) and mean (within 4
    standard errors)."""
    assert got.shape == want.shape, name
    if "layernorm" in name or "_mlp.0." in name:
        ref = np.ones_like(want) if name.endswith(".weight") \
            else np.zeros_like(want)
        np.testing.assert_array_equal(got, ref, err_msg=name)
        np.testing.assert_array_equal(want, ref, err_msg=name)
        return
    if name.endswith(("cls_token", "position_embeddings")):
        bound, std = np.inf, 1.0
    else:
        fan_in = int(np.prod(layout[name.rsplit(".", 1)[0]
                                    + ".weight"].shape[1:]))
        bound = 1.0 / np.sqrt(fan_in)
        std = bound / np.sqrt(3.0)
    for x in (got, want):
        assert np.abs(x).max() <= bound, name
        if x.size >= 256:
            assert abs(x.std() - std) <= 0.1 * std, name
            assert abs(x.mean()) <= 4 * std / np.sqrt(x.size), name


def _check_conv(got, want, new_prefixes):
    assert set(got) == set(want)
    for k in want:
        if k.startswith(new_prefixes):
            _law(k, got[k], want[k], want)
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _stage_params():
    cfg = jax_ltt.LttViTConfig(**STEP)
    keys = jax.random.split(jax.random.PRNGKey(21), 3)
    cls = _np(jax_ltt.init_ltt_vit_surrogate(keys[0], cfg))
    srg = _np(jax_ltt.init_ltt_vit_surrogate(keys[1], cfg))
    exp = _np(jax_ltt.init_ltt_vit_explainer(keys[2], cfg))
    return cfg, cls, srg, exp


def test_conversions_match_jax():
    cfg, cls, srg, exp = _stage_params()
    pcfg = port_recipe_mod.ltt_vit_recipe().t_config(**STEP)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(1)
    jp = lambda p: {k: jnp.asarray(v) for k, v in p.items()}  # noqa: E731
    # classifier -> surrogate: everything copied
    _check_conv(port_recipe_mod.conv_classifier_surrogate(pcfg, None, cls,
                                                          gen),
                _np(jax_recipe_mod.conv_classifier_surrogate(
                    cfg, None, jp(cls), key)), ())
    # surrogate -> explainer: the explainer side layer and head are new
    _check_conv(port_recipe_mod.conv_surrogate_explainer(pcfg, None, srg,
                                                         gen),
                _np(jax_recipe_mod.conv_surrogate_explainer(
                    cfg, None, jp(srg), key)),
                ("s_explainer_attn.", "s_explainer_mlp."))
    # the final: three sources and surrogate_null, within 1e-6
    with _env({"AUTOGNOTHI_PALLAS": "0"}):
        got = port_recipe_mod.conv_explainer_final(pcfg, None, cls, srg, exp,
                                                   gen, CPU)
        want = _np(jax_recipe_mod.conv_explainer_final(
            cfg, None, jp(cls), jp(srg), jp(exp), key))
    np.testing.assert_allclose(got.pop("surrogate_null"),
                               want.pop("surrogate_null"), atol=1e-6)
    _check_conv(got, want, ())


def _hf_bundle(own, num_labels):
    """An HF ViTForImageClassification state dict of the own-layout
    classifier `own` (the inverse of HF_VIT_RULES), with a head of
    num_labels rows."""
    out = {}
    for k, v in own.items():
        hf = (k.replace("encoder.layers.", "encoder.layer.")
              .replace("attention.self.", "attention.attention."))
        out[hf] = v
    if num_labels != own["classifier.weight"].shape[0]:
        rng = np.random.RandomState(0)
        out["classifier.weight"] = rng.randn(
            num_labels, own["classifier.weight"].shape[1]).astype(np.float32)
        out["classifier.bias"] = rng.randn(num_labels).astype(np.float32)
    return out


@pytest.mark.parametrize("layout,num_labels", [("own", 3), ("hf", 3),
                                               ("hf", 7)])
def test_conv_pretrained_classifier_matches_jax(layout, num_labels):
    from autognothi_tpu.models.vit import init_vit_classifier

    cfg = jax_ltt.LttViTConfig(**STEP)
    own = _np(init_vit_classifier(jax.random.PRNGKey(2), cfg.into()))
    bundle = own if layout == "own" else _hf_bundle(own, num_labels)
    pcfg = port_recipe_mod.ltt_vit_recipe().t_config(**STEP)
    got = port_recipe_mod.conv_pretrained_classifier(
        pcfg, bundle, torch.Generator().manual_seed(0))
    want = _np(jax_recipe_mod.conv_pretrained_classifier(
        cfg, bundle, jax.random.PRNGKey(3)))
    new = ("vit.encoder.s_attn_maps.", "vit.encoder.s_attn_layers.",
           "vit.s_attn_layernorm.", "s_attn_classifier.")
    if num_labels != 3:  # no num_labels match: a fresh head
        new += ("classifier.",)
    _check_conv(got, want, new)
    if num_labels == 3:
        np.testing.assert_array_equal(got["classifier.weight"],
                                      own["classifier.weight"])


def test_inits_match_jax_layouts_and_laws():
    cfg = jax_ltt.LttViTConfig(**STEP)
    recipe = port_recipe_mod.ltt_vit_recipe()
    pcfg = recipe.t_config(**STEP)
    for port_init, jax_init in ((recipe.init_classifier,
                                 jax_ltt.init_ltt_vit_surrogate),
                                (recipe.init_explainer,
                                 jax_ltt.init_ltt_vit_explainer),
                                (recipe.init_final,
                                 jax_ltt.init_ltt_vit_final)):
        got = port_init(pcfg, torch.Generator().manual_seed(0))
        want = _np(jax_init(jax.random.PRNGKey(0), cfg))
        assert set(got) == set(want)
        for k in want:
            if k == "surrogate_null":
                np.testing.assert_array_equal(got[k], want[k])
            else:
                _law(k, got[k], want[k], want)


# -------------------------------------------------------- through the CLI


def _write_exp(root, hp=None):
    exp = root / "ltt_vit"
    exp.mkdir(parents=True)
    (exp / ".hparams.json").write_text(json.dumps(hp or _ltt_vit_hparams(),
                                                  indent=2))
    return exp


def test_train_classifier_cli_matches_jax(tmp_path):
    """From one classifier-epoch-0.ckpt both packages read (dropout 0, no
    masks drawn): classifier-epoch-1.ckpt within 1e-5.  AdamW normalises
    each gradient element, so an element whose gradient is within float
    noise of 0 steps by up to lr with a sign neither package settles: the
    side layers' key biases (0 by structure under the all-ones mask) are
    held to that bound in both packages, and at most 1% of any other
    tensor's elements may exceed 1e-5, each within two such steps."""
    import shutil

    from autognothi_tpu.pipeline.env import ExpEnv as JaxEnv
    from autognothi_tpu.pipeline.resources import load_params_file, \
        save_params
    from autognothi_tpu.pipeline.train_classifier import \
        train_classifier as jax_train_classifier
    from autognothi_tpu_torch.cli import main

    hp = _ltt_vit_hparams()
    port_dir = _write_exp(tmp_path / "port", hp)
    cfg = jax_ltt.LttViTConfig(**hp["net"]["params"])
    save_params(port_dir / "classifier-epoch-0.ckpt",
                jax_ltt.init_ltt_vit_surrogate(jax.random.PRNGKey(8), cfg))
    jax_dir = tmp_path / "jax"
    shutil.copytree(port_dir, jax_dir)
    with _env({}):
        main(["train_classifier", str(port_dir), "--device", "cpu"])
        jax_train_classifier(JaxEnv(jax_dir))
    got = load_params_file(port_dir / "classifier-epoch-1.ckpt")
    want = load_params_file(jax_dir / "classifier-epoch-1.ckpt")
    assert set(got) == set(want)
    start = load_params_file(port_dir / "classifier-epoch-0.ckpt")
    moved = [k for k in want if not np.array_equal(want[k], start[k])]
    assert moved and not any(k.startswith(TRUNK) for k in moved)
    steps = hp["dataset"]["train_size"] // hp["train_classifier"]["batch_size"]
    for k in want:
        if k.endswith("attention.self.key.bias"):
            # 0 by structure under the stage's all-ones mask: AdamW moves
            # float noise by up to lr a step, in either package
            for x in (got[k], want[k]):
                assert np.abs(x - start[k]).max() <= steps * LR * 1.01, k
            continue
        # an element whose gradient is within float noise of 0 may take
        # AdamW's step (up to lr) with either sign: at most 1% of a tensor
        err = np.abs(got[k] - want[k])
        unsettled = err > 1e-5
        assert unsettled.mean() <= 0.01, (k, unsettled.sum())
        assert err.max() <= 2 * steps * LR * 1.01, (k, err.max())
    log = (port_dir / ".log.txt").read_text()
    assert "epoch 1 done" in log and "test_acc" in log


def test_train_all_cli_runs_the_seven_stages(tmp_path):
    from autognothi_tpu.pipeline.resources import load_params_file
    from autognothi_tpu_torch.cli import main

    exp = _write_exp(tmp_path)
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    proc = subprocess.run(
        [sys.executable, "-m", "autognothi_tpu_torch", "train_all", str(exp),
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    log = (exp / ".log.txt").read_text()
    for line in ("current stage: 0 / 7", "train classifier",
                 "train surrogate", "train explainer",
                 "freeze side branches exc. first 1 layers",
                 "cls_diff: ", "verified final model is coherent",
                 "all stages ok"):
        assert line in log, line
    for name in ("classifier-epoch-1", "surrogate-epoch-2",
                 "explainer-epoch-2", "final-epoch-0"):
        assert (exp / f"{name}.ckpt").exists(), name
    # the final loads in the JAX package and its fw_final is the port's
    final = load_params_file(exp / "final-epoch-0.ckpt")
    hp = _ltt_vit_hparams()
    cfg = jax_ltt.LttViTConfig(**hp["net"]["params"])
    xs = np.random.RandomState(3).randn(2, 3, 16, 16).astype(np.float32)
    with _env({"AUTOGNOTHI_PALLAS": "0"}):
        j_probs, j_attr = jax_recipe_mod.fw_final(
            cfg, {k: jnp.asarray(v) for k, v in final.items()},
            jnp.asarray(xs))
        recipe = port_recipe_mod.ltt_vit_recipe()
        pcfg = recipe.t_config(**hp["net"]["params"])
        with torch.no_grad():
            probs, attr = recipe.fw_final(
                pcfg, from_jax_params(final, pcfg, CPU), torch.from_numpy(xs))
    np.testing.assert_allclose(probs.numpy(), np.asarray(j_probs), atol=1e-5)
    np.testing.assert_allclose(attr.numpy(), np.asarray(j_attr), atol=1e-5)
    # a rerun detects the last stage and has nothing to do
    with _env({}):
        main(["train_all", str(exp), "--device", "cpu"])
    assert "current stage: 7 / 7" in (exp / ".log.txt").read_text()


# ----------------------------------------- optimizer-state checkpoints


class _Stop(Exception):
    pass


def _surrogate_exp(root, name):
    from autognothi_tpu.pipeline.resources import save_params

    hp = _ltt_vit_hparams()  # 2 surrogate epochs, progressive
    exp = root / name
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    cfg = jax_ltt.LttViTConfig(**hp["net"]["params"])
    k_c, k_s = jax.random.split(jax.random.PRNGKey(12))
    save_params(exp / "classifier-epoch-1.ckpt",
                jax_ltt.init_ltt_vit_surrogate(k_c, cfg))
    save_params(exp / "surrogate-epoch-0.ckpt",
                jax_ltt.init_ltt_vit_surrogate(k_s, cfg))
    return exp


def _train_surrogate(exp, stop_after=None):
    """The CLI's train_surrogate; `stop_after` ends the run right after that
    epoch's checkpoints are written, as a kill would."""
    from autognothi_tpu_torch.cli import main
    from autognothi_tpu_torch.pipeline import train_surrogate as ts

    real = ts.save_epoch_ckpt

    def save(*args, **kw):
        out = real(*args, **kw)
        if args[3] == stop_after:
            raise _Stop()
        return out

    with mock.patch.object(ts, "save_epoch_ckpt", save):
        try:
            main(["train_surrogate", str(exp), "--device", "cpu"])
        except _Stop:
            pass


@pytest.mark.parametrize("opt_ckpt", [True, False])
def test_opt_state_resume_is_bit_identical(tmp_path, opt_ckpt):
    from autognothi_tpu_torch.params import load_params_file

    flag = {"AUTOGNOTHI_CKPT_OPT": "1" if opt_ckpt else "0"}
    whole = _surrogate_exp(tmp_path, "whole")
    split = _surrogate_exp(tmp_path, "split")
    with _env(flag):
        _train_surrogate(whole)
        _train_surrogate(split, stop_after=1)
        assert (split / "surrogate-epoch-1.opt.ckpt").exists() == opt_ckpt
        _train_surrogate(split)
    got = load_params_file(split / "surrogate-epoch-2.ckpt")
    want = load_params_file(whole / "surrogate-epoch-2.ckpt")
    same = all(np.array_equal(got[k], want[k]) for k in want)
    # with the moments saved the resumed run is the uninterrupted one; with
    # fresh moments (the reference's resume) it is not
    assert same == opt_ckpt
    if opt_ckpt:
        # retention: only the newest epoch's opt file is kept
        assert not (split / "surrogate-epoch-1.opt.ckpt").exists()
        assert (split / "surrogate-epoch-2.opt.ckpt").exists()
        opt = load_params_file(split / "surrogate-epoch-2.opt.ckpt")
        assert int(opt["count"]) == 4  # 2 epochs x 2 batches
        assert {k.split("/", 1)[0] for k in opt} == {"count", "mu", "nu"}


def test_a_jax_written_opt_file_is_refused(tmp_path):
    from autognothi_tpu.pipeline.resources import save_opt_state

    exp = _surrogate_exp(tmp_path, "exp")
    with _env({"AUTOGNOTHI_CKPT_OPT": "1"}):
        _train_surrogate(exp, stop_after=1)
        cfg = jax_ltt.LttViTConfig(**_ltt_vit_hparams()["net"]["params"])
        params = jax_ltt.init_ltt_vit_surrogate(jax.random.PRNGKey(0), cfg)
        _, state = jax_training.make_optimizer(params, lambda k: True)
        save_opt_state(exp, "surrogate", 1, state)
        with pytest.raises(ValueError, match="JAX package"):
            _train_surrogate(exp)
    assert not (exp / "surrogate-epoch-2.ckpt").exists()


# ------------------------------------------------------------ refusals


def test_training_verbs_refuse_what_is_not_ported(tmp_path):
    from autognothi_tpu_torch.cli import TRAINING, main

    # every net kind of the JAX package is ported: an unknown kind raises
    # a ValueError naming it, as the JAX package's schema does
    hp = _ltt_vit_hparams()
    hp["net"]["kind"] = "quadro_vit"
    unknown = _write_exp(tmp_path / "a", hp)
    for verb in TRAINING:
        with pytest.raises(ValueError, match="quadro_vit"):
            main([verb, str(unknown), "--device", "cpu"])
    hp = _ltt_vit_hparams()
    hp["net"]["base_model"] = "gg_vit_base"
    hub = _write_exp(tmp_path / "b", hp)
    with pytest.raises(NotImplementedError, match="transformers"):
        main(["train_all", str(hub), "--device", "cpu"])
    assert not (hub / "classifier-epoch-0.ckpt").exists()
    # imagenette is read from its local `datasets` cache only, which this
    # package's data directory does not hold
    hp = _ltt_vit_hparams()
    hp["dataset"] = {"kind": "imagenette", "train_size": 8, "test_size": 4,
                     "test_seed": 1,
                     "transforms": {"resize": {"height": 16, "width": 16}}}
    data = _write_exp(tmp_path / "c", hp)
    with pytest.raises(FileNotFoundError, match="imagenette"):
        main(["train_all", str(data), "--device", "cpu"])
    if not torch.cuda.is_available():  # --device defaults to cuda
        for verb in TRAINING:
            with pytest.raises(RuntimeError, match="cuda"):
                main([verb, str(data)])


# ---------------------------------------------- K5's route on the card


@pytest.mark.parametrize("s,heads,inter,t,route", [
    (96, 12, 384, 197, "stages"), (128, 16, 512, 197, "stages"),
    (8, 1, 16, 1, "stages"), (96, 12, 384, 512, "stages"),
    (192, 12, 768, 197, "per_branch"), (256, 16, 1024, 197, "per_branch"),
    (384, 12, 1536, 197, "per_branch"), (192, 3, 768, 512, "per_branch"),
    (136, 17, 544, 65, "per_branch"), (128, 2, 512, 9, "per_branch"),
    # d = 4 (zero-padded to 8), d = 128, T past 512 (F7, F8)
    (96, 24, 384, 197, "per_branch"), (256, 2, 1024, 197, "per_branch"),
    (192, 12, 768, 513, "per_branch"), (16, 4, 32, 17, "per_branch"),
    (96, 8, 384, 577, "per_branch"), (160, 2, 640, 1025, "per_branch"),
    (96, 12, 384, 577, "stages"),
    (512, 2, 2048, 197, None), (264, 2, 1056, 9, None),
    (36, 4, 144, 9, None), (96, 12, 100, 9, None), (96, 5, 384, 9, None)])
def test_ladder_route_by_shape(s, heads, inter, t, route):
    """The route K5 takes on the card, by shape alone: the stage kernels at
    d = 8 up to a side of 128, the per-branch route at every other head of
    d <= 128 (a d the attention core is not compiled for, such as 4 or 12,
    zero-padded to the next of 8, 16, 32, 64, 128) at any T; a head wider
    than 128, or a width that is no multiple of 8, raises, naming it."""
    from autognothi_tpu_torch.ops.ladder_block import ladder_route

    if route is None:
        with pytest.raises(ValueError, match=f"side {s} in {heads} heads"):
            ladder_route(s, inter, heads, t)
    else:
        assert ladder_route(s, inter, heads, t) == route


# ---------------------------------------------- K10's route on the card


@pytest.mark.parametrize("s,heads,branches,t,route", [
    (96, 12, 2, 197, "narrow"), (128, 16, 2, 197, "narrow"),
    (8, 1, 1, 1, "narrow"), (48, 6, 3, 17, "narrow"),
    (96, 12, 16, 513, "narrow"), (72, 9, 1, 32768, "narrow"),
    (768, 12, 2, 197, "per_branch"), (96, 24, 2, 197, "per_branch"),
    (96, 6, 2, 197, "per_branch"), (136, 17, 2, 197, "per_branch"),
    (96, 12, 17, 197, "per_branch"), (96, 12, 2, 32769, "per_branch"),
    (192, 12, 2, 197, "per_branch")])
def test_ladder_attention_route_by_shape(s, heads, branches, t, route):
    """K10 on the card, by shape alone: heads of d = 8 (S a multiple of 8
    up to 128, at most 16 branches, T up to 32768) take one launch of
    `csrc/ladder_attention.cu` for every branch; any other head takes
    K9's core once per branch.  The launcher follows the route: one
    narrow launch, or one core launch per branch (spied here, on CPU
    tensors, where no kernel runs)."""
    from autognothi_tpu_torch.ops import ladder_block as lb

    assert lb.ladder_attention_route(s, heads, branches, t) == route
    if t > 600:
        return
    calls = []
    qkv = [torch.zeros(1, t, s) for _ in range(3 * branches)]
    with mock.patch.object(lb, "ladder_attention_narrow",
                           lambda flat, m, mode: calls.append(len(flat))
                           or tuple(flat[::3])), \
            mock.patch.object(lb, "attention_heads",
                              lambda *a: calls.append("core")):
        lb.ladder_attention_launch(torch.ones(1, t), *qkv, n_heads=heads,
                                   mode="mul")
    assert calls == ([3 * branches] if route == "narrow"
                     else ["core"] * branches)
