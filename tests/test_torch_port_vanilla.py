"""Port parity, the vanilla towers of both families: the inits, the freeze
rules, every forward adapter of the vanilla ViT and vanilla BERT recipes,
the coalition forwards, the three conversions and a mini `run_all`
through the port's CLI, against the JAX package on the same numpy inputs
and parameters (the mini experiments of tests/test_train_all_e2e.py and
tests/test_bert_e2e.py: hidden 32, 2 layers, 4 heads; the ViT at 16 px in
8 px patches, T = 5; the BERT at T = 16 on the bundled `nlp_samples`).

Tolerances, x max(1, max|ref|): fp32 1e-5 against the JAX XLA math (mode
"0") and against its kernels interpreted (modes "2" and "1"); the W8A8
serving forward (mode "2", AUTOGNOTHI_INT8=1) 2e-5, or 1e-2 where a
per-token int8 code differs between the packages (the `int8_codes`
recorder of tests/test_torch_port_bert.py), the bounds of
tests/test_torch_port_int8.py.  Copied parameters are held bit for bit;
parameters a conversion makes anew (`New()`) by name and shape.
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

from autognothi_tpu.data import tokenizer as j_tok
from autognothi_tpu.recipes import vanilla_bert as j_vb
from autognothi_tpu.recipes import vanilla_vit as j_vv
from autognothi_tpu_torch.data import tokenizer as p_tok
from autognothi_tpu_torch.params import from_jax_params
from autognothi_tpu_torch.recipes import vanilla_bert as p_vb
from autognothi_tpu_torch.recipes import vanilla_vit as p_vv
from tests.test_bert_e2e import make_bert_hparams
from tests.test_torch_port_bert import _recorded_codes
from tests.test_torch_port_bert import int8_codes  # noqa: F401 (fixture)
from tests.test_torch_port_reports import NAMES, _clean_env
from tests.test_train_all_e2e import MINI_VIT_HPARAMS

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
B, M = 2, 3
TOL_FP32, TOL_INT8, TOL_FLIPPED = 1e-5, 2e-5, 1e-2
ENV_KEYS = ("AUTOGNOTHI_PALLAS", "AUTOGNOTHI_PALLAS_INTERPRET",
            "AUTOGNOTHI_INT8", "AUTOGNOTHI_INT8_TEACHER",
            "AUTOGNOTHI_CKPT_OPT", "AUTOGNOTHI_PROFILE_DIR")
INTERPRET = {"AUTOGNOTHI_PALLAS_INTERPRET": "1"}
# (JAX env, port env, tolerance) of each arithmetic
SETTINGS = {
    "mode0": ({"AUTOGNOTHI_PALLAS": "0"}, {"AUTOGNOTHI_PALLAS": "0"},
              TOL_FP32),
    "mode2": ({"AUTOGNOTHI_PALLAS": "2", **INTERPRET}, {}, TOL_FP32),
    "mode2_int8": ({"AUTOGNOTHI_PALLAS": "2", "AUTOGNOTHI_INT8": "1",
                    **INTERPRET}, {"AUTOGNOTHI_INT8": "1"}, TOL_INT8),
    "mode1": ({"AUTOGNOTHI_PALLAS": "1", **INTERPRET},
              {"AUTOGNOTHI_PALLAS": "1"}, TOL_FP32),
}


def _corpus():
    return [s["inputs"] for s in json.loads(
        (REPO / "autognothi_tpu_torch/data/nlp_samples.json").read_text())]


VOCAB = p_tok.build_vocab(_corpus(), max_size=400)


def vit_hparams() -> dict:
    return json.loads(json.dumps(MINI_VIT_HPARAMS))


def bert_hparams() -> dict:
    """The mini vanilla BERT of tests/test_bert_e2e.py, with one classifier
    epoch (the frozen classifier's stage runs) and a CKA block."""
    hp = make_bert_hparams(len(VOCAB))
    hp["train_classifier"]["epochs"] = 1
    hp["eval_branches_cka"] = {"dataset": None, "batch_size": 8}
    return hp


class Family:
    """One family's two recipes, config and inputs."""

    def __init__(self, name, j_mod, p_mod, hparams, kind=None):
        self.name, self.hparams = name, hparams
        self.j_recipe = getattr(j_mod, f"{name}_recipe")()
        self.p_recipe = getattr(p_mod, f"{name}_recipe")()
        params = hparams["net"]["params"]
        self.jcfg = self.j_recipe.t_config(**params)
        self.pcfg = self.p_recipe.t_config(**params)
        self.text = "bert" in name

    def n_players(self):
        return self.p_recipe.n_players(self.pcfg)

    def xs(self, rng, b=B):
        if self.text:
            ids = rng.randint(5, len(VOCAB), (b, self.n_players() + 1))
            ids[:, 0] = VOCAB.index("[CLS]")
            return ids.astype(np.int64)
        c = self.pcfg
        return rng.randn(b, c.img_channels, c.img_px_size,
                         c.img_px_size).astype(np.float32)

    def j_misc(self):
        return (j_vb.VanillaBertMisc(j_tok.WordPieceTokenizer(VOCAB))
                if self.text else None)

    def p_misc(self):
        return p_vb.BertMisc(p_tok.WordPieceTokenizer(VOCAB)) \
            if self.text else None


FAMILIES = {
    "vit": lambda: Family("vanilla_vit", j_vv, p_vv, vit_hparams()),
    "bert": lambda: Family("vanilla_bert", j_vb, p_vb, bert_hparams()),
}


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


def _jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _within(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _codes_agree() -> bool:
    port, jax_ = _recorded_codes()
    rows = [{r.tobytes() for c in codes for r in c} for codes in (port,
                                                                 jax_)]
    return rows[0] == rows[1]


def stage_params(fam: Family, seed=21):
    """JAX-initialised classifier, surrogate and explainer (sharing the
    surrogate's trunk, as the conversion does) and a final of the three
    with a non-zero null."""
    r, cfg = fam.j_recipe, fam.jcfg
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    cls = _np(r.init_classifier(keys[0], cfg))
    srg = _np(r.init_surrogate(keys[1], cfg))
    exp = _np(r.init_explainer(keys[2], cfg))
    for k in exp:
        if k in srg:
            exp[k] = srg[k]
    c = cfg.num_labels
    null = np.linspace(0.1, 0.2, c, dtype=np.float32)[None]
    fin = {f"classifier.{k}": v for k, v in cls.items()}
    fin.update({f"surrogate.{k}": v for k, v in srg.items()})
    fin.update({f"explainer.{k}": v for k, v in exp.items()})
    fin["surrogate_null"] = null
    return cls, srg, exp, fin, null


# ------------------------------------------------- inits and freeze rules


@pytest.mark.parametrize("family", list(FAMILIES))
def test_inits_match_jax_layouts(family):
    fam = FAMILIES[family]()
    gen = torch.Generator().manual_seed(0)
    for stage in ("classifier", "surrogate", "explainer", "final"):
        want = _np(getattr(fam.j_recipe, f"init_{stage}")(
            jax.random.PRNGKey(0), fam.jcfg))
        got = getattr(fam.p_recipe, f"init_{stage}")(fam.pcfg, gen)
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}, stage
        # and the section's module loads it strictly
        from_jax_params(got, fam.pcfg, CPU, section=stage)
    assert float(np.abs(got["surrogate_null"]).max()) == 0.0
    # the first explainer layer has no LN1
    ln1 = "layernorm_before" if family == "vit" \
        else "attention.output.LayerNorm"
    exp = fam.p_recipe.init_explainer(fam.pcfg, gen)
    assert f"explainer_attn.0.{ln1}.weight" not in exp
    trunk = "bert.encoder" if fam.text else "vit.encoder"
    assert f"{trunk}.layers.0.{ln1}.weight" in exp


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
    """fw_classifier, fw_surrogate, fw_classifier_repr, fw_explainer and
    fw_explainer_repr on random player masks, fw_surrogate_coalitions on
    <B, M, P> masks and fw_final, in each arithmetic."""
    fam = FAMILIES[family]()
    jax_env, port_env, tol = SETTINGS[setting]
    cls, srg, exp, fin, null = stage_params(fam)
    rng = np.random.RandomState(5)
    p = fam.n_players()
    xs = fam.xs(rng)
    mask = (rng.rand(B, p) > rng.rand(B, 1)).astype(np.int32)
    masks = (rng.rand(B, M, p) > 0.5).astype(np.int32)
    jr, pr, jc, pc = fam.j_recipe, fam.p_recipe, fam.jcfg, fam.pcfg
    with _env(jax_env):
        jx, jm = jnp.asarray(xs), jnp.asarray(mask)
        want = {"cls": jr.fw_classifier(jc, _jp(cls), jx, jm)[0],
                "srg": jr.fw_surrogate(jc, _jp(srg), jx, jm)[0],
                "cls_repr": jr.fw_classifier_repr(jc, _jp(cls), jx, jm)[1],
                "coal": jr.fw_surrogate_coalitions(jc, _jp(srg), jx,
                                                   jnp.asarray(masks)),
                "final": jr.fw_final(jc, _jp(fin), jx)}
        grand = np.asarray(want["srg"])
        want["exp"] = jr.fw_explainer(jc, _jp(exp), jx, jm,
                                      jnp.asarray(grand),
                                      jnp.asarray(null))[0]
        want["exp_repr"] = jr.fw_explainer_repr(
            jc, _jp(exp), jx, jm, jnp.asarray(grand), jnp.asarray(null))[1]
    t = torch.from_numpy
    with _env(port_env), torch.no_grad():
        pm = {s: from_jax_params(f, pc, CPU, section=s)
              for s, f in (("classifier", cls), ("surrogate", srg),
                           ("explainer", exp), ("final", fin))}
        got = {"cls": pr.fw_classifier(pc, pm["classifier"], t(xs),
                                       t(mask))[0],
               "srg": pr.fw_surrogate(pc, pm["surrogate"], t(xs), t(mask))[0],
               "cls_repr": pr.fw_classifier_repr(pc, pm["classifier"], t(xs),
                                                 t(mask))[1],
               "coal": pr.fw_surrogate_coalitions(pc, pm["surrogate"], t(xs),
                                                  t(masks)),
               "final": pr.fw_final(pc, pm["final"], t(xs)),
               "exp": pr.fw_explainer(pc, pm["explainer"], t(xs), t(mask),
                                      t(grand), t(null))[0],
               "exp_repr": pr.fw_explainer_repr(pc, pm["explainer"], t(xs),
                                                t(mask), t(grand),
                                                t(null))[1]}
    if setting == "mode2_int8" and not _codes_agree():
        tol = TOL_FLIPPED
    c = fam.pcfg.num_labels
    assert got["coal"].shape == (B, M, c)
    assert got["exp"].shape == (B, c, p)
    assert got["final"][1].shape == (B, c, p)
    for name in want:
        w = want[name] if isinstance(want[name], tuple) else (want[name],)
        g = got[name] if isinstance(got[name], tuple) else (got[name],)
        for i, (gi, wi) in enumerate(zip(g, w)):
            _within(gi.numpy(), wi, tol, f"{name}[{i}]")
    if setting == "mode2_int8":  # the W8A8 final is another function
        with _env({}), torch.no_grad():
            fp = pr.fw_final(pc, pm["final"], t(xs))[1]
        assert float((got["final"][1] - fp).abs().max()) > 1e-6


@pytest.mark.parametrize("family", list(FAMILIES))
def test_coalition_forward_is_the_surrogate_on_each_masked_copy(family):
    fam = FAMILIES[family]()
    _, srg, _, _, _ = stage_params(fam)
    rng = np.random.RandomState(8)
    p = fam.n_players()
    xs = torch.from_numpy(fam.xs(rng))
    masks = torch.from_numpy((rng.rand(B, M, p) > 0.5).astype(np.int32))
    pr, pc = fam.p_recipe, fam.pcfg
    with _env({}), torch.no_grad():
        model = from_jax_params(srg, pc, CPU, section="surrogate")
        got = pr.fw_surrogate_coalitions(pc, model, xs, masks)
        want, _ = pr.fw_surrogate(pc, model, xs.repeat_interleave(M, dim=0),
                                  masks.reshape(B * M, p))
        with pytest.raises(NotImplementedError, match="eval-mode"):
            pr.fw_surrogate_coalitions(pc, model, xs, masks,
                                       deterministic=False)
    _within(got.reshape(B * M, -1).numpy(), want.numpy(), 1e-6, "coal")


# ------------------------------------------------------------ conversions


def check_conv(got, want, new_prefixes):
    """Equal names and shapes; the parameters not made anew bit for bit."""
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if not k.startswith(new_prefixes):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_conversions_match_jax(family):
    fam = FAMILIES[family]()
    jr, pr, jc, pc = fam.j_recipe, fam.p_recipe, fam.jcfg, fam.pcfg
    cls, srg, exp, _, _ = stage_params(fam)
    gen, key = torch.Generator().manual_seed(0), jax.random.PRNGKey(1)
    check_conv(pr.conv_classifier_surrogate(pc, None, cls, gen),
               _np(jr.conv_classifier_surrogate(jc, None, _jp(cls), key)),
               ())
    got = pr.conv_surrogate_explainer(pc, None, srg, gen)
    check_conv(got, _np(jr.conv_surrogate_explainer(jc, None, _jp(srg),
                                                    key)),
               ("explainer_attn.", "explainer_mlp."))
    trunk = "bert." if fam.text else "vit."
    assert all(np.array_equal(got[k], srg[k]) for k in srg
               if k.startswith(trunk))
    with _env({"AUTOGNOTHI_PALLAS": "0"}):
        got = pr.conv_explainer_final(pc, fam.p_misc(), cls, srg, exp, gen,
                                      CPU)
        want = _np(jr.conv_explainer_final(jc, fam.j_misc(), _jp(cls),
                                           _jp(srg), _jp(exp), key))
    np.testing.assert_allclose(got.pop("surrogate_null"),
                               want.pop("surrogate_null"), atol=1e-6)
    check_conv(got, want, ())


# --------------------------------------------------- run_all through CLI


def write_exp(root: pathlib.Path, name: str, hparams: dict) -> pathlib.Path:
    exp = root / name
    exp.mkdir(parents=True)
    if hparams["net"]["kind"].endswith("bert"):
        p_tok.WordPieceTokenizer(VOCAB).save(exp / "tokenizer")
    (exp / ".hparams.json").write_text(json.dumps(hparams, indent=2))
    return exp


def run_all_and_check(fam: Family, exp: pathlib.Path):
    """`run_all` through `python -m autognothi_tpu_torch` on the CPU: the
    seven stages, the coherency check and the six reports, each of which
    the JAX package's report class loads; the written final's fw_final
    matches the JAX package's on it."""
    from autognothi_tpu.pipeline import measure_all as jax_ma
    from autognothi_tpu.pipeline.resources import load_params_file
    from autognothi_tpu_torch.cli import REPORTS

    proc = subprocess.run(
        [sys.executable, "-m", "autognothi_tpu_torch", "run_all", str(exp),
         "--device", "cpu"], cwd=REPO, env=_clean_env(),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = (exp / ".log.txt").read_text()
    for line in ("current stage: 0 / 7", "train surrogate",
                 "train explainer", "cls_diff: ",
                 "verified final model is coherent", "all stages ok",
                 "[[[ done all measurements ]]]"):
        assert line in log, line
    assert sorted(p.name for p in (exp / ".reports").iterdir()) == NAMES
    for module, cls, name in REPORTS.values():
        if name not in NAMES:  # the dual-task report, the duo recipes'
            continue
        got = json.loads((exp / ".reports" / name).read_text())
        if name == "train_resources.json":  # null memory cells on the CPU
            got = dict(got, init_mem=1.0,
                       srg_mem={"all": [1.0], "avg": 1.0, "std": 0.0},
                       exp_mem={"all": [1.0], "avg": 1.0, "std": 0.0})
        getattr(jax_ma, cls).model_validate(got)
    final = load_params_file(exp / "final-epoch-0.ckpt")
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
    return log


@pytest.mark.parametrize("family", list(FAMILIES))
def test_run_all_cli_on_the_cpu(family, tmp_path):
    fam = FAMILIES[family]()
    exp = write_exp(tmp_path, family, fam.hparams)
    log = run_all_and_check(fam, exp)
    # the frozen classifier's epoch trains nothing
    cls0 = np.load(exp / "classifier-epoch-0.ckpt")
    cls1 = np.load(exp / "classifier-epoch-1.ckpt")
    for k in cls0.files:
        np.testing.assert_array_equal(cls0[k], cls1[k], err_msg=k)
    assert "train classifier" in log
