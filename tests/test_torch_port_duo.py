"""Port parity, the duo family (ViT and BERT): the inits, the freeze rules,
the forward adapters (`fw_final`, `fw_explainer`, `fw_explainer_repr`) in
modes "0", "2", "2" int8 and "1", the dual-task gradient probe, one duo
explainer step on injected masks, the two duo conversions, the dual-task
report on shared masks and a mini duo ViT `run_all` through the port's
CLI, against the JAX package on the same numpy inputs and parameters
(the mini configs of tests/test_train_all_e2e.py and tests/test_bert_e2e.py:
hidden 32, 2 layers, 4 heads; ViT T = 5, BERT T = 16).

Tolerances, x max(1, max|ref|): fp32 1e-5; the W8A8 forward 2e-5, or
1e-2 where a per-token int8 code differs between the packages (the
`int8_codes` recorder of tests/test_torch_port_bert.py).  The probe's
gradients within 1e-5 of the largest |gradient|; the step's loss within
1e-5 relative (2e-5 with the int8 teacher), its gradients within the same
share of the largest, and the updated parameters where the gradient is
not float noise (the rule of tests/test_torch_port_stages.py: AdamW moves
a gradient of ~0 by up to lr with either sign); the dual-task
`cos_sim_avg` within 1e-5.  Copied parameters bit for bit; parameters
made anew by shape and the JAX init's law.
"""

import contextlib
import json
import pathlib
import shutil
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autognothi_tpu.ops import shapley as j_shapley
from autognothi_tpu.pipeline import training as j_training
from autognothi_tpu.models.common import quant_override as j_quant_override
from autognothi_tpu.recipes import duo_vanilla_bert as j_db
from autognothi_tpu.recipes import duo_vanilla_vit as j_dv
from autognothi_tpu_torch.params import from_jax_params
from autognothi_tpu_torch.pipeline.train_duo_explainer import \
    make_duo_explainer_steps
from autognothi_tpu_torch.pipeline.training import AdamW
from autognothi_tpu_torch.recipes import duo_vanilla_bert as p_db
from autognothi_tpu_torch.recipes import duo_vanilla_vit as p_dv
from tests.test_torch_port_bert import int8_codes  # noqa: F401 (fixture)
from tests.test_torch_port_reports import _clean_env
from tests.test_torch_port_vanilla import (CPU, SETTINGS, VOCAB, Family,
                                           _codes_agree, _env, _jp, _np,
                                           _within, bert_hparams,
                                           vit_hparams, write_exp)

REPO = pathlib.Path(__file__).resolve().parents[1]
B, M, LR = 2, 3, 1e-3
INTERPRET = {"AUTOGNOTHI_PALLAS_INTERPRET": "1"}


def _hparams(family: str) -> dict:
    hp = vit_hparams() if family == "vit" else bert_hparams()
    hp["net"]["kind"] = f"duo_vanilla_{family}"
    # one batch of the BERT's 24 test sentences, one of the ViT's 4
    hp["eval_dual_task_similarity"] = {"dataset": None, "batch_size": 24}
    return hp


FAMILIES = {
    "vit": lambda: Family("duo_vanilla_vit", j_dv, p_dv, _hparams("vit")),
    "bert": lambda: Family("duo_vanilla_bert", j_db, p_db,
                           _hparams("bert")),
}


def stage_params(fam: Family, seed=21):
    """JAX-initialised surrogate and duo explainer (the explainer sharing
    the surrogate's trunk and head, as the conversion makes it) and a final
    of the two with a non-zero null."""
    r, cfg = fam.j_recipe, fam.jcfg
    k_s, k_e = jax.random.split(jax.random.PRNGKey(seed))
    srg = _np(r.init_surrogate(k_s, cfg))
    exp = _np(r.init_explainer(k_e, cfg))
    for k in exp:
        if k in srg:
            exp[k] = srg[k]
    null = np.linspace(0.1, 0.2, cfg.num_labels, dtype=np.float32)[None]
    fin = {f"surrogate.{k}": v for k, v in srg.items()}
    fin.update({f"explainer.{k}": v for k, v in exp.items()})
    fin["surrogate_null"] = null
    return srg, exp, fin, null


def _is_ln(name: str, vit: bool) -> bool:
    return "layernorm" in name or "LayerNorm" in name or (
        vit and "explainer_mlp.0." in name)


def _law(name, got, want, layout, vit):
    """A parameter drawn anew: its shape and the JAX init's law (LayerNorms
    exactly ones / zeros, every linear U(+-1/sqrt(fan_in)); a tensor of 256
    values or more also with the law's std within 10%)."""
    assert got.shape == want.shape, name
    if _is_ln(name, vit):
        ref = np.ones_like(want) if name.endswith(".weight") \
            else np.zeros_like(want)
        np.testing.assert_array_equal(got, ref, err_msg=name)
        np.testing.assert_array_equal(want, ref, err_msg=name)
        return
    bound = 1.0 / np.sqrt(layout[name.rsplit(".", 1)[0] + ".weight"]
                          .shape[1])
    for x in (got, want):
        assert np.abs(x).max() <= bound, name
        if x.size >= 256:
            assert abs(x.std() - bound / np.sqrt(3.0)) \
                <= 0.1 * bound / np.sqrt(3.0), name


# ------------------------------------------------- inits and freeze rules


@pytest.mark.parametrize("family", list(FAMILIES))
def test_inits_match_jax_layouts_and_laws(family):
    fam = FAMILIES[family]()
    gen = torch.Generator().manual_seed(0)
    for stage in ("classifier", "surrogate", "explainer", "final"):
        want = _np(getattr(fam.j_recipe, f"init_{stage}")(
            jax.random.PRNGKey(0), fam.jcfg))
        got = getattr(fam.p_recipe, f"init_{stage}")(fam.pcfg, gen)
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}, stage
        from_jax_params(got, fam.pcfg, CPU, section=stage)
    assert not any(k.startswith("classifier.") for k in got)  # the final
    assert float(np.abs(got["surrogate_null"]).max()) == 0.0
    # the duo explainer's head and classifier, drawn with JAX's laws
    want = _np(fam.j_recipe.init_explainer(jax.random.PRNGKey(1), fam.jcfg))
    got = fam.p_recipe.init_explainer(fam.pcfg, gen)
    for k in want:
        if k.startswith(("explainer_attn.", "explainer_mlp.",
                         "classifier.")):
            _law(k, got[k], want[k], want, not fam.text)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("section", ["classifier", "surrogate", "explainer",
                                     "final"])
def test_freeze_rules_match_jax(family, section):
    fam = FAMILIES[family]()
    names = list(getattr(fam.j_recipe, f"init_{section}")(
        jax.random.PRNGKey(0), fam.jcfg))
    jtrain = fam.j_recipe.trainable(fam.jcfg, section)
    train = fam.p_recipe.trainable(fam.pcfg, section)
    assert [train(k) for k in names] == [jtrain(k) for k in names]
    model = from_jax_params(
        getattr(fam.p_recipe, f"init_{section}")(fam.pcfg,
                                                 torch.Generator()),
        fam.pcfg, CPU, section=section)
    assert sorted(n for n, _ in model.named_parameters()) == \
        sorted(k for k in names if k != "surrogate_null")


# -------------------------------------------------------------- forwards


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_forwards_match_jax(family, setting, int8_codes):
    """fw_final and fw_explainer (attributions and the head's outputs) on
    random player masks in each arithmetic, fw_explainer_repr in modes
    "0" and "2" (its trunk is fw_explainer's)."""
    fam = FAMILIES[family]()
    jax_env, port_env, tol = SETTINGS[setting]
    srg, exp, fin, null = stage_params(fam)
    rng = np.random.RandomState(5)
    p = fam.n_players()
    xs = fam.xs(rng)
    mask = (rng.rand(B, p) > rng.rand(B, 1)).astype(np.int32)
    grand = rng.dirichlet(np.ones(fam.pcfg.num_labels), B).astype(np.float32)
    jr, pr, jc, pc = fam.j_recipe, fam.p_recipe, fam.jcfg, fam.pcfg
    with _env(jax_env):
        jx, jm, jg, jn = (jnp.asarray(a) for a in (xs, mask, grand, null))
        want = {"final": jr.fw_final(jc, _jp(fin), jx),
                "exp": jr.fw_explainer(jc, _jp(exp), jx, jm, jg, jn)}
        if setting in ("mode0", "mode2"):
            want["exp_repr"] = jr.fw_explainer_repr(jc, _jp(exp), jx, jm,
                                                    jg, jn)
    t = torch.from_numpy
    with _env(port_env), torch.no_grad():
        exp_m = from_jax_params(exp, pc, CPU, section="explainer")
        got = {"final": pr.fw_final(pc, from_jax_params(fin, pc, CPU), t(xs)),
               "exp": pr.fw_explainer(pc, exp_m, t(xs), t(mask), t(grand),
                                      t(null)),
               "exp_repr": pr.fw_explainer_repr(pc, exp_m, t(xs), t(mask),
                                                t(grand), t(null))}
    if setting == "mode2_int8" and not _codes_agree():
        tol = 1e-2
    c = pc.num_labels
    assert got["final"][0].shape == (B, c)
    assert got["final"][1].shape == got["exp"][0].shape == (B, c, p)
    for name in want:  # exp_repr where the JAX side ran it
        for i, (gi, wi) in enumerate(zip(got[name], want[name])):
            _within(gi.numpy(), wi, tol, f"{name}[{i}]")
    # duo ViT's head is a softmax, duo BERT's gives raw logits
    sums = got["final"][0].sum(-1).numpy()
    if fam.text:
        assert np.abs(sums - 1.0).max() > 1e-3
    else:
        np.testing.assert_allclose(sums, 1.0, atol=1e-5)


def _probe_inputs(fam: Family, srg, null, rng):
    """xs, labels, coalition masks and the surrogate's v_s, v_1 (from the
    JAX surrogate at mode "0")."""
    p = fam.n_players()
    xs = fam.xs(rng)
    zs = rng.randint(0, fam.pcfg.num_labels, B).astype(np.int32)
    masks = (rng.rand(B, M, p) > 0.5).astype(np.int32)
    with _env({"AUTOGNOTHI_PALLAS": "0"}):
        sp = _jp(srg)
        v_s = np.asarray(fam.j_recipe.fw_surrogate_coalitions(
            fam.jcfg, sp, jnp.asarray(xs), jnp.asarray(masks))).reshape(
                B * M, -1)
        v_1 = np.asarray(fam.j_recipe.fw_surrogate(
            fam.jcfg, sp, jnp.asarray(xs), jnp.ones((B, p), jnp.int32))[0])
    return xs, zs, masks, v_s, v_1


@pytest.mark.parametrize("family,setting", [
    ("vit", "mode2"), ("bert", "mode2"), ("bert", "mode1")])
def test_grad_probe_matches_jax(family, setting):
    fam = FAMILIES[family]()
    jax_env, port_env, _ = SETTINGS[setting]
    srg, exp, _, null = stage_params(fam)
    xs, zs, masks, v_s, v_1 = _probe_inputs(fam, srg, null,
                                            np.random.RandomState(6))
    ones = np.ones((B, fam.n_players()), np.int32)
    args = (ones, v_1, null, zs, masks, null, v_s, v_1)
    with _env(jax_env):
        want = fam.j_recipe.measurements.allow_dual_task_similarity \
            .grad_probe(fam.jcfg, _jp(exp), jnp.asarray(xs),
                        *(jnp.asarray(a) for a in args))
    with _env(port_env):
        model = from_jax_params(exp, fam.pcfg, CPU, section="explainer")
        model.requires_grad_(False)
        got = fam.p_recipe.measurements.allow_dual_task_similarity \
            .grad_probe(fam.pcfg, model, torch.from_numpy(xs),
                        *(torch.from_numpy(np.asarray(a)) for a in args))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.shape[-1] == fam.pcfg.hidden_size
        scale = float(np.abs(w).max())
        assert scale > 0
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-5 * scale, (err, scale)


# ---------------------------------------------------- one duo step each


def _jax_duo_step(fam, srg, exp, xs, zs, masks, null):
    """The JAX duo step's loss, trainable gradients and updated
    parameters: `joint_loss` of `train_duo_explainer.py:82-94` under
    `make_train_step`, the teacher `_make_teacher`."""
    from autognothi_tpu.parallel.train_step import _make_teacher

    recipe, cfg = fam.j_recipe, fam.jcfg
    p_n = recipe.n_players(cfg)
    params, srg_p = _jp(exp), _jp(srg)
    trainable = recipe.trainable(cfg, "explainer")
    tx, opt_state = j_training.make_optimizer(params, trainable)
    xs_j, zs_j, masks_j = jnp.asarray(xs), jnp.asarray(zs), jnp.asarray(masks)
    v_s, v_1 = _make_teacher(recipe, cfg, p_n)(srg_p, xs_j, masks_j)

    def joint_loss(p, xs, zs, masks_bmp, v_0, v_s, v_1, rng, weights):
        mask_1 = jnp.ones((masks_bmp.shape[0], p_n), jnp.int32)
        with j_quant_override("none"):
            phi, base_ys = recipe.fw_explainer(
                cfg, p, xs, mask_1, v_1, v_0, deterministic=rng is None,
                rng=rng)
        loss_cls = j_training.cross_entropy_on_probs(base_ys, zs, weights)
        loss_shap = j_shapley.loss_shapley(masks_bmp, v_0, v_s, v_1, phi,
                                           weights)
        return loss_cls + loss_shap, (loss_cls, loss_shap, base_ys)

    batch = (xs_j, zs_j, masks_j, jnp.asarray(null), v_s, v_1,
             jax.random.PRNGKey(9), jnp.ones((B,), jnp.float32))
    step = j_training.make_train_step(tx, joint_loss)
    new, _, loss, _ = step(params, opt_state, LR,
                           {k: jnp.ones(()) for k in params}, *batch)
    grads = jax.grad(lambda q: joint_loss(q, *batch)[0])(params)
    return (float(loss), {k: np.asarray(v) for k, v in grads.items()
                          if trainable(k)}, _np(new))


def _port_duo_step(fam, srg, exp, xs, zs, masks, null):
    recipe, cfg = fam.p_recipe, fam.pcfg
    srg_m = from_jax_params(srg, cfg, CPU, section="surrogate")
    srg_m.requires_grad_(False)
    model = from_jax_params(exp, cfg, CPU, section="explainer")
    trainable = recipe.trainable(cfg, "explainer")
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
    step, _ = make_duo_explainer_steps(recipe, cfg, recipe.n_players(cfg), M)
    gen = torch.Generator().manual_seed(9)
    t = torch.from_numpy
    loss, _ = step(model, opt, srg_m, t(null), t(xs), t(zs.astype(np.int64)),
                   gen, LR, {k: 1.0 for k in named}, torch.ones(B),
                   masks=t(masks))
    return (loss.item(), {k: v.numpy() for k, v in seen.items()},
            {k: v.detach().numpy() for k, v in model.state_dict().items()})


STEP_SETTINGS = {
    "fp32_teacher": ({"AUTOGNOTHI_PALLAS": "0",
                      "AUTOGNOTHI_INT8_TEACHER": "0"},
                     {"AUTOGNOTHI_PALLAS": "0",
                      "AUTOGNOTHI_INT8_TEACHER": "0"}, 1e-5),
    "int8_teacher": ({"AUTOGNOTHI_PALLAS": "2", **INTERPRET}, {}, 2e-5),
}


@pytest.mark.parametrize("family,setting", [
    ("vit", "int8_teacher"), ("bert", "fp32_teacher")])
def test_duo_step_matches_jax(family, setting):
    jax_env, port_env, tol = STEP_SETTINGS[setting]
    fam = FAMILIES[family]()
    srg, exp, _, null = stage_params(fam)
    rng = np.random.RandomState(7)
    xs = fam.xs(rng)
    zs = rng.randint(0, fam.pcfg.num_labels, B).astype(np.int32)
    masks = (rng.rand(B, M, fam.n_players()) > 0.5).astype(np.int32)
    with _env(jax_env), mock.patch(
            "autognothi_tpu.parallel.train_step.mesh_safe_pallas",
            contextlib.nullcontext):
        want_loss, want_g, want_p = _jax_duo_step(fam, srg, exp, xs, zs,
                                                  masks, null)
    with _env(port_env):
        loss, got_g, got_p = _port_duo_step(fam, srg, exp, xs, zs, masks,
                                            null)
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


# ------------------------------------------------------------ conversions


@pytest.mark.parametrize("family", list(FAMILIES))
def test_conversions_match_jax(family):
    fam = FAMILIES[family]()
    jr, pr, jc, pc = fam.j_recipe, fam.p_recipe, fam.jcfg, fam.pcfg
    srg, exp, _, _ = stage_params(fam)
    gen, key = torch.Generator().manual_seed(0), jax.random.PRNGKey(1)
    got = pr.conv_surrogate_explainer(pc, None, srg, gen)
    want = _np(jr.conv_surrogate_explainer(jc, None, _jp(srg), key))
    new = ("explainer_attn.", "explainer_mlp.")
    assert set(got) == set(want)
    for k in want:
        if k.startswith(new):
            _law(k, got[k], want[k], want, not fam.text)
        else:  # the surrogate's trunk and head, copied
            np.testing.assert_array_equal(got[k], srg[k], err_msg=k)
            np.testing.assert_array_equal(want[k], srg[k], err_msg=k)
    with _env({"AUTOGNOTHI_PALLAS": "0"}):
        got = pr.conv_explainer_final(pc, fam.p_misc(), srg, srg, exp, gen,
                                      CPU)
        want = _np(jr.conv_explainer_final(jc, fam.j_misc(), _jp(srg),
                                           _jp(srg), _jp(exp), key))
    np.testing.assert_allclose(got.pop("surrogate_null"),
                               want.pop("surrogate_null"), atol=1e-6)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------- the dual-task report

def _dual_task_exp(root: pathlib.Path, fam: Family) -> pathlib.Path:
    """An experiment holding a trained surrogate and explainer epochs 0
    and 1 (the second's head moved), as the report reads them."""
    from autognothi_tpu_torch.params import save_params

    srg, exp, _, _ = stage_params(fam)
    hp = fam.hparams
    hp["train_explainer"]["epochs"] = 1
    ex = write_exp(root, "dual", hp)
    save_params(ex / f"surrogate-epoch-{hp['train_surrogate']['epochs']}"
                ".ckpt", srg)
    save_params(ex / "explainer-epoch-0.ckpt", exp)
    moved = dict(exp)
    for k in moved:
        if k.startswith("explainer_mlp."):
            moved[k] = moved[k] * np.float32(1.5)
    save_params(ex / "explainer-epoch-1.ckpt", moved)
    return ex


@pytest.mark.parametrize("family", ["vit"])
def test_dual_task_report_matches_jax(family, tmp_path):
    """Both packages' reports on the same checkpoints, their coalition
    masks patched to the same draws in both modules' namespaces (the duo
    BERT's probe: `test_grad_probe_matches_jax`)."""
    from autognothi_tpu.pipeline import measure_dual_task_similarity as jm
    from autognothi_tpu.pipeline.env import ExpEnv as JaxEnv
    from autognothi_tpu_torch.pipeline import \
        measure_dual_task_similarity as pm
    from autognothi_tpu_torch.pipeline.env import ExpEnv

    fam = FAMILIES[family]()
    exp = _dual_task_exp(tmp_path / "port", fam)
    jexp = tmp_path / "jax"
    shutil.copytree(exp, jexp)
    rng = np.random.RandomState(12)
    draws = [(rng.rand(n, fam.n_players()) > 0.5).astype(np.int32)
             for n in [64] * 4]

    def provider(to):
        calls = iter(draws)
        return lambda _key, n, p: to(next(calls)[:n])

    with _env({"AUTOGNOTHI_PALLAS": "0"}), \
            mock.patch.object(jm, "mask_shapley", provider(jnp.asarray)):
        want = jm.measure_dual_task_similarity(JaxEnv(jexp))
    with _env({"AUTOGNOTHI_PALLAS": "0"}), \
            mock.patch.object(pm, "mask_shapley",
                              provider(torch.from_numpy)), \
            ExpEnv(exp) as env:
        got = pm.measure_dual_task_similarity(env, device="cpu")
    assert got.epochs == list(want.epochs) == [0, 1]
    np.testing.assert_allclose(got.cos_sim_avg, want.cos_sim_avg, atol=1e-5)
    np.testing.assert_allclose(got.cos_sim_std, want.cos_sim_std, atol=1e-5)
    assert got.cos_sim_avg[0] != got.cos_sim_avg[1]


# --------------------------------------------------- run_all through CLI


def test_run_all_cli_on_the_cpu(tmp_path):
    """`python -m autognothi_tpu_torch run_all` of the mini duo ViT: the
    duo trainer's log, no coherency check, the seven reports, each of which
    the JAX package's report class loads, and a final JAX serves alike."""
    from autognothi_tpu.pipeline import measure_all as jax_ma
    from autognothi_tpu.pipeline import \
        measure_dual_task_similarity as jax_dt
    from autognothi_tpu.pipeline.resources import load_params_file
    from autognothi_tpu_torch.cli import REPORTS

    fam = FAMILIES["vit"]()
    exp = write_exp(tmp_path, "duo_vit", fam.hparams)
    proc = subprocess.run(
        [sys.executable, "-m", "autognothi_tpu_torch", "run_all", str(exp),
         "--device", "cpu"], cwd=REPO, env=_clean_env(),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = (exp / ".log.txt").read_text()
    for line in ("current stage: 0 / 7", "train duo explainer",
                 "loss: cls ", "skipped: net recipe does not support this",
                 "all stages ok", "[[[ done all measurements ]]]"):
        assert line in log, line
    names = sorted(p.name for p in (exp / ".reports").iterdir())
    assert names == sorted(name for _, _, name in REPORTS.values())
    for module, cls, name in REPORTS.values():
        got = json.loads((exp / ".reports" / name).read_text())
        if name == "train_resources.json":  # null memory cells on the CPU
            got = dict(got, init_mem=1.0,
                       srg_mem={"all": [1.0], "avg": 1.0, "std": 0.0},
                       exp_mem={"all": [1.0], "avg": 1.0, "std": 0.0})
        mod = jax_dt if name == "dual_task_similarity.json" else jax_ma
        getattr(mod, cls).model_validate(got)
    final = load_params_file(exp / "final-epoch-0.ckpt")
    assert not any(k.startswith("classifier.") for k in final)
    xs = fam.xs(np.random.RandomState(3), 2)
    with _env({"AUTOGNOTHI_PALLAS": "0"}):
        j_probs, j_attr = fam.j_recipe.fw_final(fam.jcfg, _jp(final),
                                                jnp.asarray(xs))
        with torch.no_grad():
            probs, attr = fam.p_recipe.fw_final(
                fam.pcfg, from_jax_params(final, fam.pcfg, CPU),
                torch.from_numpy(xs))
    _within(probs.numpy(), j_probs, 1e-5, "probs")
    _within(attr.numpy(), j_attr, 1e-5, "attr")
