"""Port parity, training: the Shapley sampler by its laws, the losses and
AdamW against the JAX package on the same numpy inputs, the seed
derivation, one explainer train step against `make_explainer_train_step`
on the same parameters and coalition masks, and a CPU `train_explainer`
run through the port's CLI whose checkpoint the JAX package loads.

The step comparison, per setting (mini LTT ViT: hidden 32, 2 layers, side
16, T = 17, B = 2 images x M = 4 coalitions), of the loss (relative) and of
each trainable gradient (within tol x the largest gradient):
- mode "0" (plain math) against the JAX XLA step: 1e-5 (fp32 sums in
  another order; measured 1.2e-7 on the loss, 1.1e-6 on the gradients);
- the int8 teacher (mode "2") against the JAX step with AUTOGNOTHI_PALLAS=2
  and its kernels interpreted: 2e-5, the bound of
  tests/test_torch_port_int8.py.  The teacher quantizes the same values
  with the same recipe; the interpreted kernels' GELU carries the A&S erf
  (error 1.5e-7) and LayerNorm/softmax sums run in another order, so a
  value could fall on the other side of an int8 code boundary and move a
  teacher value by a quantization step (~1e-3 of its row).  No code flips
  at these seeds (measured 1.2e-7 on the loss), so the bound allows none;
- mode "1" (the masked attention op) against the JAX step with
  AUTOGNOTHI_PALLAS=1 interpreted: 1e-5.
Gradients that are 0 by structure come out as float noise (~1e-5 of the
largest): the explainer head's last bias (the efficiency normalisation
removes any per-class constant) and the key biases (under the forward's
all-ones mask a key bias adds a per-query constant the softmax ignores);
both packages' noisy values are held below 1e-4 x max|g| instead.
Updated parameters are compared where |g| > 1e-4 max|g|, ten times the
gradient bound: AdamW's first update is about lr sign(g), so where a
gradient is within the bound of 0 its sign, and the update, is not
settled (it can move that parameter by up to 2 lr).
"""

import contextlib
import hashlib
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autognothi_tpu.models import ltt_vit as jax_ltt
from autognothi_tpu.models.common import quant_override as jax_quant_override
from autognothi_tpu.ops import shapley as jax_shapley
from autognothi_tpu.parallel.train_step import _make_teacher
from autognothi_tpu.parallel.train_step import \
    make_explainer_train_step as jax_make_step
from autognothi_tpu.pipeline.training import make_optimizer
from autognothi_tpu.recipes.ltt_vit import ltt_vit_recipe as jax_recipe
from autognothi_tpu.utils.seeding import derive_seed as jax_derive_seed
from autognothi_tpu_torch.ops import shapley
from autognothi_tpu_torch.parallel.train_step import make_explainer_train_step
from autognothi_tpu_torch.params import from_jax_params
from autognothi_tpu_torch.pipeline.training import AdamW, filter_mask
from autognothi_tpu_torch.recipes.ltt_vit import ltt_vit_recipe
from autognothi_tpu_torch.utils.seeding import (derive_seed,
                                                iterative_generator)
from tests.test_ltt_e2e import _ltt_vit_hparams
from tests.test_torch_port_model import MINI

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
STEP = dict(MINI, img_px_size=16, img_patch_size=4)  # 16 players, T = 17
B, M, LR = 2, 4, 1e-3
ENV_KEYS = ("AUTOGNOTHI_PALLAS", "AUTOGNOTHI_PALLAS_INTERPRET",
            "AUTOGNOTHI_INT8", "AUTOGNOTHI_INT8_TEACHER")
# gradients that are 0 by structure: the head's last bias adds a per-class
# constant that the efficiency projection removes, and under the all-ones
# mask of the explainer forward a key bias adds a per-query constant to the
# scores, which the softmax ignores
ZERO_GRADS = {"s_explainer_mlp.5.bias",
              *(f"vit.encoder.s_attn_layers.0_{i}.attention.self.key.bias"
                for i in range(2)),
              "s_explainer_attn.0.attention.self.key.bias"}


# ------------------------------------------------------ sampler and losses


def _binom_pmf(n, p):
    from math import comb
    return np.array([comb(n, s) * p ** s * (1 - p) ** (n - s)
                     for s in range(n + 1)])


def test_mask_shapley_laws():
    """Paired complements, and coalition sizes distributed as the
    Shapley-kernel mixture with the idx/n threshold: size ~ sum_idx p(idx)
    Binomial(n, 1 - idx/n) (the k/n threshold would shift it by one)."""
    n, draws = 8, 40000
    probs = shapley.shapley_kernel_probs(n)
    np.testing.assert_allclose(probs.numpy(), np.asarray(
        jax_shapley.shapley_kernel_probs(n)), rtol=1e-6)
    masks = shapley.mask_shapley(torch.Generator().manual_seed(0), draws, n)
    assert masks.dtype == torch.int32 and masks.shape == (draws, n)
    assert torch.equal(masks[0::2] + masks[1::2], torch.ones(draws // 2, n,
                                                             dtype=torch.int32))
    sizes = masks[0::2].sum(dim=1).numpy()
    hist = np.bincount(sizes, minlength=n + 1) / sizes.size
    want = sum(float(p) * _binom_pmf(n, 1 - idx / n)
               for idx, p in enumerate(probs))
    sigma = np.sqrt(want * (1 - want) / sizes.size)
    assert np.all(np.abs(hist - want) <= 5 * sigma + 1e-4), (hist, want)
    jax_masks = np.asarray(jax_shapley.mask_shapley(
        jax.random.PRNGKey(0), draws, n))
    jax_hist = np.bincount(jax_masks[0::2].sum(1), minlength=n + 1) / sizes.size
    assert np.all(np.abs(jax_hist - want) <= 5 * sigma + 1e-4)
    with pytest.raises(ValueError):
        shapley.mask_shapley(torch.Generator(), 3, n)


def test_uniform_masks_laws():
    g = torch.Generator().manual_seed(1)
    sel = shapley.mask_uniform_selective(g, 500, 10, 3)
    assert torch.all((sel == 0).sum(dim=1) == 3)
    uni = shapley.mask_purely_uniform(g, 20000, 10)
    off = (uni == 0).sum(dim=1).float()
    assert abs(off.mean().item() - 5.0) < 0.1  # uniform threshold: mean n/2


@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(weighted):
    rng = np.random.RandomState(5)
    b, m, p, c = 3, 4, 6, 5
    mask = (rng.rand(b, m, p) > 0.5).astype(np.int32)
    v0, v1 = rng.rand(1, c).astype(np.float32), rng.rand(b, c).astype(
        np.float32)
    vs = rng.rand(b * m, c).astype(np.float32)
    phi = rng.randn(b, c, p).astype(np.float32)
    w = np.asarray([1.0, 1.0, 0.0], np.float32) if weighted else None
    t, j = torch.from_numpy, jnp.asarray
    got = shapley.loss_shapley(t(mask), t(v0), t(vs), t(v1), t(phi),
                               None if w is None else t(w))
    want = jax_shapley.loss_shapley(j(mask), j(v0), j(vs), j(v1), j(phi),
                                    None if w is None else j(w))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    ref, cur = rng.randn(b, c).astype(np.float32), rng.randn(b, c).astype(
        np.float32)
    got = shapley.loss_logits_kl_divergence(t(ref), t(cur),
                                            None if w is None else t(w))
    want = jax_shapley.loss_logits_kl_divergence(j(ref), j(cur),
                                                 None if w is None else j(w))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # the orientation: F.kl_div(input=log_softmax(ref), target=softmax(cur))
    if w is None:
        textbook = torch.nn.functional.kl_div(
            torch.log_softmax(t(ref), -1), torch.softmax(t(cur), -1),
            reduction="batchmean")
        np.testing.assert_allclose(got.item(), textbook.item(), rtol=1e-5)


def test_derive_seed_matches_jax():
    for master, key in ((42, "train_explainer[epoch=1]"), (0, ""),
                        (7, "ünï")):
        assert derive_seed(master, key) == jax_derive_seed(master, key)
    tag = "[seed=42,key=k]".encode()
    assert derive_seed(42, "k") == int.from_bytes(
        hashlib.sha256(tag).digest()[:8], "big") % 2**32
    a = torch.rand(3, generator=iterative_generator(42, "k"))
    assert torch.equal(a, torch.rand(3, generator=iterative_generator(42, "k")))


def test_adamw_matches_optax():
    """3 steps with a frozen parameter and a zeroed update mask on one
    trainable parameter, against the JAX package's optimizer and step
    arithmetic (`parallel/train_step.py:161-165`)."""
    rng = np.random.RandomState(6)
    shapes = {"frozen.w": (3, 4), "side.w": (4, 5), "side.b": (5,),
              "head.w": (2, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}

    def trainable(name):
        return not name.startswith("frozen.")

    tx, state = make_optimizer({k: jnp.asarray(v) for k, v in params.items()},
                               trainable)
    mask = {k: 0.0 if k == "head.w" else 1.0 for k in params}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = AdamW(tp, trainable)
    for step, lr in enumerate((1e-2, 5e-3, 2e-3)):
        grads = {k: (rng.randn(*s) * 10 ** -step).astype(np.float32)
                 for k, s in shapes.items()}
        g = {k: jnp.asarray(v) * mask[k] for k, v in grads.items()}
        state = optax.tree_utils.tree_set(state, learning_rate=lr)
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, {k: u * mask[k]
                                      for k, u in updates.items()})
        opt.update(tp, {k: torch.from_numpy(v) for k, v in grads.items()
                        if trainable(k)}, lr, mask)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(tp["frozen.w"].numpy(), params["frozen.w"])
    np.testing.assert_array_equal(tp["head.w"].numpy(), params["head.w"])
    assert opt.count == 3 and set(opt.names) == {"side.w", "side.b",
                                                 "head.w"}
    assert filter_mask(tp, trainable) == {"frozen.w": 0.0, "side.w": 1.0,
                                          "side.b": 1.0, "head.w": 1.0}


# --------------------------------------------------------- one train step


def _jax_models(seed=0):
    cfg = jax_ltt.LttViTConfig(**STEP)
    k_s, k_e = jax.random.split(jax.random.PRNGKey(seed))
    srg = jax_ltt.init_ltt_vit_surrogate(k_s, cfg)
    exp = jax_ltt.init_ltt_vit_explainer(k_e, cfg)
    # share the trunk, as the conversion surrogate -> explainer does
    for k in exp:
        if k.startswith(("vit.embeddings.", "vit.encoder.layers.",
                         "vit.layernorm.", "classifier.")):
            exp[k] = srg[k]
    to_np = lambda p: {k: np.asarray(v) for k, v in p.items()}  # noqa
    return cfg, to_np(srg), to_np(exp)


def _jax_step(cfg, srg, exp, xs, key, null):
    """The JAX step's loss, trainable gradients and updated parameters."""
    recipe = jax_recipe()
    n_players = recipe.n_players(cfg)
    params = {k: jnp.asarray(v) for k, v in exp.items()}
    srg_p = {k: jnp.asarray(v) for k, v in srg.items()}
    trainable = recipe.trainable(cfg, "explainer")
    tx, opt_state = make_optimizer(params, trainable)
    step = jax_make_step(recipe, cfg, n_players, M, tx)
    ones = {k: jnp.ones(()) for k in params}
    new, _, loss = step(params, opt_state, srg_p, jnp.asarray(null),
                        jnp.asarray(xs), key, LR, ones, jnp.int32(2))
    # the gradients of the step's loss_fn (train_step.py:134-145)
    mask_key, _ = jax.random.split(key)
    masks = jax_shapley.mask_shapley(mask_key, B * M, n_players).reshape(
        B, M, n_players)
    v_s, v_1 = _make_teacher(recipe, cfg, n_players)(srg_p, jnp.asarray(xs),
                                                     masks)

    def loss_fn(p):
        with jax_quant_override("none"):
            phi, _ = recipe.fw_explainer(
                cfg, p, jnp.asarray(xs), jnp.ones((B, n_players), jnp.int32),
                v_1, jnp.asarray(null), deterministic=False,
                rng=jax.random.PRNGKey(9), ltt_active_layers=jnp.int32(2))
        return jax_shapley.loss_shapley(masks, jnp.asarray(null), v_s, v_1,
                                        phi)

    grads = jax.grad(loss_fn)(params)
    return (float(loss), np.asarray(masks),
            {k: np.asarray(v) for k, v in grads.items() if trainable(k)},
            {k: np.asarray(v) for k, v in new.items()})


def _port_step(srg, exp, xs, masks, null):
    recipe = ltt_vit_recipe()
    cfg = recipe.t_config(**STEP)
    srg_m = from_jax_params(srg, cfg, CPU, section="surrogate")
    srg_m.requires_grad_(False)
    model = from_jax_params(exp, cfg, CPU, section="explainer")
    trainable = recipe.trainable(cfg, "explainer")
    for name, p in model.named_parameters():
        p.requires_grad_(trainable(name))
    params = dict(model.named_parameters())
    opt = AdamW(params, trainable)
    seen = {}
    update = opt.update

    def spy(p, grads, lr, mask):
        seen.update({k: v.detach().clone() for k, v in grads.items()
                     if v is not None})
        return update(p, grads, lr, mask)

    opt.update = spy
    step = make_explainer_train_step(recipe, cfg, recipe.n_players(cfg), M)
    loss = step(model, opt, srg_m, torch.from_numpy(null),
                torch.from_numpy(xs), None, LR,
                {k: 1.0 for k in params}, 2,
                masks=torch.from_numpy(np.array(masks)))
    return (loss.item(), {k: v.numpy() for k, v in seen.items()},
            {k: v.detach().numpy() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("setting,jax_env,port_env,tol", [
    ("mode0", {"AUTOGNOTHI_PALLAS": "0"}, {"AUTOGNOTHI_PALLAS": "0"}, 1e-5),
    ("int8_teacher", {"AUTOGNOTHI_PALLAS": "2",
                      "AUTOGNOTHI_PALLAS_INTERPRET": "1"}, {}, 2e-5),
    ("mode1", {"AUTOGNOTHI_PALLAS": "1", "AUTOGNOTHI_PALLAS_INTERPRET": "1"},
     {"AUTOGNOTHI_PALLAS": "1"}, 1e-5),
])
def test_explainer_train_step_matches_jax(setting, jax_env, port_env, tol):
    cfg, srg, exp = _jax_models()
    rng = np.random.RandomState(7)
    xs = rng.randn(B, 3, 16, 16).astype(np.float32)
    null = np.asarray([[0.3, 0.3, 0.4]], np.float32)
    key = jax.random.PRNGKey(11)
    saved = {k: os.environ.pop(k) for k in ENV_KEYS if k in os.environ}
    try:
        # the JAX step as on one device: the suite's 8 virtual CPU devices
        # would pin it to the XLA path (its multi-device GSPMD workaround)
        with mock.patch.dict(os.environ, jax_env), mock.patch(
                "autognothi_tpu.parallel.train_step.mesh_safe_pallas",
                contextlib.nullcontext):
            want_loss, masks, want_g, want_p = _jax_step(cfg, srg, exp, xs,
                                                         key, null)
        with mock.patch.dict(os.environ, port_env):
            loss, got_g, got_p = _port_step(srg, exp, xs, masks, null)
    finally:
        os.environ.update(saved)
    assert abs(loss - want_loss) <= tol * abs(want_loss), (loss, want_loss)
    assert set(got_g) == set(want_g)
    g_max = max(np.abs(g).max() for g in want_g.values())
    for k, g in want_g.items():
        if k in ZERO_GRADS:
            assert max(np.abs(g).max(), np.abs(got_g[k]).max()) \
                <= 1e-4 * g_max, k
            continue
        err = np.abs(got_g[k] - g).max()
        assert err <= tol * g_max, (k, err, g_max)
        moved = np.abs(g) > 1e-4 * g_max
        assert moved.any(), k
        np.testing.assert_allclose(got_p[k][moved], want_p[k][moved],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in want_p:
        if k not in want_g:  # frozen: unchanged in both
            np.testing.assert_array_equal(got_p[k], exp[k])
            np.testing.assert_array_equal(want_p[k], exp[k])


# ------------------------------------------------------ the CLI, on the CPU


def test_train_explainer_cli_writes_a_checkpoint_jax_loads(tmp_path):
    from autognothi_tpu.pipeline.resources import load_params_file
    from autognothi_tpu.pipeline.resources import save_params

    hp = _ltt_vit_hparams()
    hp["train_explainer"].update(epochs=2, batch_size=4, n_mask_samples=2)
    exp_dir = tmp_path / "ltt_vit"
    exp_dir.mkdir()
    (exp_dir / ".hparams.json").write_text(json.dumps(hp, indent=2))
    cfg = jax_ltt.LttViTConfig(**hp["net"]["params"])
    k_s, k_e = jax.random.split(jax.random.PRNGKey(3))
    save_params(exp_dir / "surrogate-epoch-1.ckpt",
                jax_ltt.init_ltt_vit_surrogate(k_s, cfg))
    exp0 = jax_ltt.init_ltt_vit_explainer(k_e, cfg)
    save_params(exp_dir / "explainer-epoch-0.ckpt", exp0)
    proc = subprocess.run(
        [sys.executable, "-m", "autognothi_tpu_torch", "train_explainer",
         str(exp_dir), "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    log = (exp_dir / ".log.txt").read_text()
    assert "epoch 2 done" in log and "test_loss: shap" in log
    # retention: epoch 0 kept, epoch 1 kept by the cadence, epoch 2 written
    for e in (0, 1, 2):
        assert (exp_dir / f"explainer-epoch-{e}.ckpt").exists()
    got = load_params_file(exp_dir / "explainer-epoch-2.ckpt")
    assert {k: v.shape for k, v in got.items()} == \
        {k: np.asarray(v).shape for k, v in exp0.items()}
    moved = [k for k in got if not np.array_equal(got[k],
                                                  np.asarray(exp0[k]))]
    assert moved and all(not k.startswith(("vit.embeddings.",
                                           "vit.encoder.layers.",
                                           "classifier."))
                         for k in moved)
    # a second run resumes at the newest epoch and has nothing to do
    proc = subprocess.run(
        [sys.executable, "-m", "autognothi_tpu_torch", "train_explainer",
         str(exp_dir), "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0 and "explainer already trained" in \
        (exp_dir / ".log.txt").read_text()


@pytest.mark.parametrize("section", ["surrogate", "explainer"])
def test_sections_and_freeze_rules_match_jax(section):
    from autognothi_tpu_torch.models.ltt_vit import (init_ltt_vit,
                                                     ltt_vit_progressive,
                                                     ltt_vit_trainable)
    from autognothi_tpu_torch.params import to_flat

    cfg = jax_ltt.LttViTConfig(**STEP)
    init = {"surrogate": jax_ltt.init_ltt_vit_surrogate,
            "explainer": jax_ltt.init_ltt_vit_explainer}[section]
    want = {k: np.asarray(v).shape
            for k, v in init(jax.random.PRNGKey(0), cfg).items()}
    port_cfg = ltt_vit_recipe().t_config(**STEP)
    got = to_flat(init_ltt_vit(port_cfg, section,
                               torch.Generator().manual_seed(0)))
    assert {k: v.shape for k, v in got.items()} == want
    for unfrozen in (0, 1, 2):
        keep = ltt_vit_progressive(port_cfg, section, unfrozen)
        jkeep = jax_ltt.ltt_vit_progressive(cfg, section, unfrozen)
        assert {k for k in want if keep(k)} == {k for k in want if jkeep(k)}
    train = ltt_vit_trainable(port_cfg, section)
    jtrain = jax_ltt.ltt_vit_trainable(cfg, section)
    assert {k for k in want if train(k)} == {k for k in want if jtrain(k)}


def _cli_exp(tmp_path, epochs):
    from autognothi_tpu.pipeline.resources import save_params

    hp = _ltt_vit_hparams()
    hp["train_explainer"].update(epochs=epochs, batch_size=4,
                                 n_mask_samples=2)
    exp_dir = tmp_path / "ltt_vit"
    exp_dir.mkdir()
    (exp_dir / ".hparams.json").write_text(json.dumps(hp, indent=2))
    cfg = jax_ltt.LttViTConfig(**hp["net"]["params"])
    k_s, k_e = jax.random.split(jax.random.PRNGKey(3))
    save_params(exp_dir / "surrogate-epoch-1.ckpt",
                jax_ltt.init_ltt_vit_surrogate(k_s, cfg))
    save_params(exp_dir / "explainer-epoch-0.ckpt",
                jax_ltt.init_ltt_vit_explainer(k_e, cfg))
    return exp_dir


def test_train_explainer_refuses_what_is_not_ported(tmp_path):
    from autognothi_tpu_torch.cli import main

    exp_dir = _cli_exp(tmp_path, 1)
    if not torch.cuda.is_available():  # --device defaults to cuda
        with pytest.raises(RuntimeError, match="cuda"):
            main(["train_explainer", str(exp_dir)])
    # pipeline parallelism is ported for the vanilla kinds: an LTT kind
    # gets the JAX package's refusal, and so does AUTOGNOTHI_PP_TP alone
    for env, msg in (({"AUTOGNOTHI_PP": "2"}, "unsupported net kind"),
                     ({"AUTOGNOTHI_PP_TP": "2"}, "requires AUTOGNOTHI_PP")):
        with mock.patch.dict(os.environ, env), \
                pytest.raises(ValueError, match=msg):
            main(["train_explainer", str(exp_dir), "--device", "cpu"])
    assert not (exp_dir / "explainer-epoch-1.ckpt").exists()


def test_train_explainer_sigterm_stops_at_a_batch_and_exits_75(tmp_path):
    import signal
    import time

    exp_dir = _cli_exp(tmp_path, 10000)
    log = exp_dir / ".log.txt"
    proc = subprocess.Popen(
        [sys.executable, "-m", "autognothi_tpu_torch", "train_explainer",
         str(exp_dir), "--device", "cpu"], cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        while not (log.exists() and ":0:train" in log.read_text()):
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline, "training never started"
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 75, err
    assert "interrupted" in err and "batch boundary" in err
