"""Port parity, the demos and the other verbs: `run_text_explanation`,
`run_image_explanation`, `__preview_text_shapley__`
(`montecarlo_shapley`), `__show_fridge__`, `estimate_train_time`,
`pretrain_classifier` and `preload_all`, against the JAX package on the
same parameters and inputs (the mini experiments of tests/
test_train_all_e2e.py, tests/test_ltt_e2e.py and tests/test_bert_e2e.py),
and each verb through `python -m autognothi_tpu_torch ... --device cpu`.

Tolerances, x max(1, max|ref|): the finals' attributions and the
Shapley values 1e-5 (fp32, both packages on their plain math, pallas
mode "0"); the JPEG fields equal (the same Pillow encodes the same
pixels); the freeze tables, the time estimate, the exported `ft_*`
bases and their `model.json` equal.
"""

import base64
import builtins
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autognothi_tpu.pipeline.env import ExpEnv as JaxEnv
from autognothi_tpu_torch.params import from_jax_params, save_params
from autognothi_tpu_torch.pipeline.env import ExpEnv
from tests.test_ltt_e2e import _ltt_vit_hparams
from tests.test_torch_port_bert_train import ltt_bert_hparams
from tests.test_torch_port_reports import _clean_env
from tests.test_torch_port_vanilla import (VOCAB, _env, _np, _within,
                                           bert_hparams, vit_hparams,
                                           write_exp)

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = 1e-5
MODE0 = {"AUTOGNOTHI_PALLAS": "0"}


def _recipes(hp):
    from autognothi_tpu.pipeline.config import ExpConfig
    from autognothi_tpu.pipeline.resources import get_recipe as j_get
    from autognothi_tpu_torch.pipeline.config import parse_config
    from autognothi_tpu_torch.pipeline.resources import get_recipe as p_get

    return j_get(ExpConfig.model_validate(hp)), p_get(parse_config(hp))


def _with_final(root, name, hp, seed=3):
    """An experiment whose final is the JAX recipe's init (a non-zero
    null), and -> its directory."""
    exp = write_exp(root, name, hp)
    (jr, jc), _ = _recipes(hp)
    fin = _np(jr.init_final(jax.random.PRNGKey(seed), jc))
    fin["surrogate_null"] = np.linspace(
        0.1, 0.2, fin["surrogate_null"].size,
        dtype=np.float32).reshape(fin["surrogate_null"].shape)
    save_params(exp / "final-epoch-0.ckpt", fin)
    return exp


TEXT_KINDS = {"ltt_bert": ltt_bert_hparams, "vanilla_bert": bert_hparams}
IMAGE_KINDS = {"ltt_vit": _ltt_vit_hparams, "vanilla_vit": vit_hparams}


@pytest.mark.parametrize("kind", list(TEXT_KINDS))
def test_text_demo_matches_jax(kind, tmp_path):
    from autognothi_tpu.pipeline.run_text_explanation import \
        run_text_explanation as j_run
    from autognothi_tpu_torch.pipeline.run_text_explanation import \
        run_text_explanation as p_run

    exp = _with_final(tmp_path, kind, TEXT_KINDS[kind]())
    with _env(MODE0):
        j_run(JaxEnv(exp), None, tmp_path / "jax.json", None)
        with ExpEnv(exp) as env:
            p_run(env, None, tmp_path / "port.json", None, device="cpu")
    want = json.loads((tmp_path / "jax.json").read_text())["items"]
    got = json.loads((tmp_path / "port.json").read_text())["items"]
    assert want and list(got) == list(want)
    for k in want:
        assert [t for t, _ in got[k]] == [t for t, _ in want[k]]
        _within([a for _, a in got[k]], [a for _, a in want[k]], TOL, k)
    # indented by 2, with a final newline, as the JAX package writes it
    text = (tmp_path / "port.json").read_text()
    assert text.startswith('{\n  "items": {\n    "0": [') and \
        text.endswith("}\n")
    with _env(MODE0), ExpEnv(exp) as env:
        p_run(env, None, tmp_path / "two.json", 2, device="cpu")
    assert set(json.loads((tmp_path / "two.json").read_text())["items"]) \
        <= {"0", "1"}


@pytest.mark.parametrize("kind", list(IMAGE_KINDS))
def test_image_demo_matches_jax(kind, tmp_path, monkeypatch):
    from autognothi_tpu.data.loader import load_cv_samples as j_cv
    from autognothi_tpu.pipeline import run_image_explanation as j_rie
    from autognothi_tpu_torch.data.loader import load_cv_samples as p_cv
    from autognothi_tpu_torch.pipeline import run_image_explanation as p_rie

    j_run, p_run = j_rie.run_image_explanation, p_rie.run_image_explanation
    try:
        import PIL.Image  # noqa: F401
        pil = True
    except ImportError:  # hold everything but the JPEG field
        pil = False
        for mod in (j_rie, p_rie):
            monkeypatch.setattr(mod, "_to_b64_jpeg", lambda img, px: "")
        monkeypatch.setattr(p_rie, "require_pillow", lambda: None)
    hp = IMAGE_KINDS[kind]()
    exp = _with_final(tmp_path, kind, hp)
    data = dict(train_size=4, test_size=12, img_px_size=16, num_classes=3,
                seed=7)
    with _env(MODE0):
        j_run(JaxEnv(exp), j_cv(**data), tmp_path / "jax.json", None)
        with ExpEnv(exp) as env:
            p_run(env, p_cv(**data), tmp_path / "port.json", None,
                  device="cpu")
    want = json.loads((tmp_path / "jax.json").read_text())["items"]
    got = json.loads((tmp_path / "port.json").read_text())["items"]
    assert want and list(got) == list(want)
    for k in want:
        g, w = dict(got[k]), dict(want[k])
        _within(g.pop("explanation"), w.pop("explanation"), TOL, k)
        assert g == w  # the sizes and the base64 JPEG bytes
        assert not pil or base64.b64decode(g["image"])[:2] == b"\xff\xd8"
    # one line, as the JAX package writes it
    assert (tmp_path / "port.json").read_text().count("\n") == 1


def test_image_demo_refuses_without_pillow_before_loading(tmp_path,
                                                          monkeypatch):
    from autognothi_tpu_torch.pipeline import run_image_explanation as rie

    exp = write_exp(tmp_path, "vit", vit_hparams())  # no final: not read
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with ExpEnv(exp) as env, pytest.raises(ImportError, match="Pillow"):
        rie.run_image_explanation(env, None, tmp_path / "x.json", None,
                                  device="cpu")
    assert not (tmp_path / "x.json").exists()


# ------------------------------------------------------ Shapley preview


@pytest.mark.parametrize("kind", list(TEXT_KINDS))
def test_montecarlo_shapley_matches_jax_on_its_permutations(kind):
    from autognothi_tpu.pipeline.preview_text_shapley import \
        montecarlo_shapley as j_mc
    from autognothi_tpu_torch.pipeline.preview_text_shapley import \
        montecarlo_shapley as p_mc

    hp = TEXT_KINDS[kind]()
    (jr, jc), (pr, pc) = _recipes(hp)
    srg = _np(jr.init_surrogate(jax.random.PRNGKey(4), jc))
    from autognothi_tpu_torch.data.tokenizer import WordPieceTokenizer
    from autognothi_tpu_torch.data.tokenizer import encode_batch

    xs = encode_batch(WordPieceTokenizer(VOCAB), ["the food was great and "
                                                  "the staff friendly"],
                      pc.max_position_embeddings)
    n, reps = pr.n_players(pc), 4
    key = jax.random.fold_in(jax.random.PRNGKey(hp["seed"]), 0)
    # the permutations exactly as the JAX function draws them
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in jax.random.split(key, reps)])
    with _env(MODE0):
        want = j_mc(jr, jc, {k: jnp.asarray(v) for k, v in srg.items()},
                    jnp.asarray(xs), n, key, reps=reps)
        model = from_jax_params(srg, pc, CPU, section="surrogate")
        with torch.no_grad():
            got = p_mc(pr, pc, model, torch.from_numpy(xs),
                       torch.from_numpy(perms))
            slabbed = p_mc(pr, pc, model, torch.from_numpy(xs),
                           torch.from_numpy(perms), slab=5)
    for name, g, w, s in zip(("sv", "v0", "vN"), got, want, slabbed):
        assert g.shape == w.shape
        _within(g, w, TOL, name)
        _within(s, g, 1e-6, name)  # the coalition rows in slabs of 5


def test_preview_draws_seeded_permutations():
    from autognothi_tpu_torch.pipeline.preview_text_shapley import \
        draw_permutations

    a = draw_permutations(3407, 0, 8, 15)
    assert a.shape == (8, 15)
    assert all(sorted(p.tolist()) == list(range(15)) for p in a)
    assert torch.equal(a, draw_permutations(3407, 0, 8, 15))
    assert not torch.equal(a, draw_permutations(3407, 1, 8, 15))


# --------------------------------------------- fridge and time estimate


def _all_kinds():
    from tests.test_torch_port_duo import _hparams as duo
    from tests.test_torch_port_froyo import _froyo
    from tests.test_torch_port_kernel_shap import _hparams as kshap

    return {"ltt_vit": _ltt_vit_hparams, "ltt_bert": ltt_bert_hparams,
            "vanilla_vit": vit_hparams, "vanilla_bert": bert_hparams,
            "froyo_vit": lambda: _froyo(vit_hparams()),
            "froyo_bert": lambda: _froyo(bert_hparams()),
            "duo_vanilla_vit": lambda: duo("vit"),
            "duo_vanilla_bert": lambda: duo("bert"),
            "kernel_shap_bert": kshap}


@pytest.mark.parametrize("kind", list(_all_kinds()))
def test_show_fridge_matches_jax(kind, tmp_path, capsys, monkeypatch):
    from autognothi_tpu.pipeline.show_fridge import show_fridge as j_show
    from autognothi_tpu_torch.pipeline.show_fridge import \
        show_fridge as p_show

    hp = _all_kinds()[kind]()
    exp = write_exp(tmp_path, kind, hp)
    _, (pr, pc) = _recipes(hp)
    gen = torch.Generator().manual_seed(0)
    for section in ("classifier", "surrogate", "explainer", "final"):
        epoch = hp[f"train_{section}"]["epochs"] if section != "final" else 0
        if section == "surrogate" and kind == "kernel_shap_bert":
            continue  # KernelSHAP trains no surrogate: "no checkpoint"
        save_params(exp / f"{section}-epoch-{epoch}.ckpt",
                    getattr(pr, f"init_{section}")(pc, gen))
    monkeypatch.setitem(sys.modules, "rich", None)  # the plain lines
    monkeypatch.setitem(sys.modules, "rich.table", None)
    def table(out):  # the flag lines, without the environment's log
        return [ln for ln in out.splitlines()
                if ln.startswith(("train ", "frozen "))]

    j_show(JaxEnv(exp))
    want = table(capsys.readouterr().out)
    with ExpEnv(exp) as env:
        p_show(env)
    got = table(capsys.readouterr().out)
    assert got == want and any(ln.split()[1].startswith("final.")
                               for ln in got)
    monkeypatch.undo()
    with ExpEnv(exp) as env:
        p_show(env)  # rich's tables where rich imports
    assert "Fridge Status on `final` (epoch 0)" in capsys.readouterr().out


def _train_resources_report(exp):
    from autognothi_tpu_torch.pipeline.measure_train_resources import (
        MeasureTrainResourcesReport, MiBytesStats, SecondsStats)
    from autognothi_tpu_torch.pipeline.reports import dump_report

    report = MeasureTrainResourcesReport(
        init_tm=95.25, init_mem=512.0,
        srg_tm=SecondsStats(all=[0.0625], avg=0.0625, std=0.0),
        srg_mem=MiBytesStats(all=[64.0], avg=64.0, std=0.0),
        exp_tm=SecondsStats(all=[0.21875], avg=0.21875, std=0.0),
        exp_mem=MiBytesStats(all=[96.0], avg=96.0, std=0.0))
    (exp / ".reports").mkdir()
    (exp / ".reports" / "train_resources.json").write_text(
        dump_report(report))


def _estimate_lines(exp):
    return [ln.split("] ", 1)[1] for ln in
            (exp / ".log.txt").read_text().splitlines()
            if "estimated" in ln or "> surrogate" in ln
            or "> explainer" in ln]


@pytest.mark.parametrize("kind", ["vanilla_vit", "vanilla_bert"])
def test_estimate_train_time_matches_jax(kind, tmp_path, monkeypatch):
    from autognothi_tpu.pipeline.estimate_train_time import \
        estimate_train_time as j_est
    from autognothi_tpu_torch.pipeline.estimate_train_time import (
        estimate_train_time as p_est, fmt_tm)

    hp = (vit_hparams if kind == "vanilla_vit" else bert_hparams)()
    hp["train_surrogate"]["epochs"] = 40
    lines = {}
    asked = []
    # nlp_samples has no train_size: both packages ask for it
    monkeypatch.setattr(builtins, "input",
                        lambda prompt: asked.append(prompt) or "12000")
    for who, run in (("jax", lambda e: j_est(JaxEnv(e))),
                     ("port", lambda e: p_est(ExpEnv(e), device="cpu"))):
        exp = write_exp(tmp_path / who, kind, hp)
        _train_resources_report(exp)
        run(exp)
        lines[who] = _estimate_lines(exp)
    assert lines["port"] == lines["jax"] and len(lines["jax"]) == 3
    assert len(asked) == (0 if kind == "vanilla_vit" else 2)
    assert fmt_tm(59.0) == "     00m" and fmt_tm(3 * 3600 + 125) == \
        "  3h 02m"


# ------------------------------------------- the pretrained base store


@pytest.fixture()
def store(tmp_path, monkeypatch):
    """One temporary zoo store for both packages."""
    import autognothi_tpu.zoo.loader as j_zoo
    import autognothi_tpu_torch.zoo.loader as p_zoo

    root = tmp_path / "zoo"
    monkeypatch.setattr(j_zoo, "_STORE", root)
    monkeypatch.setattr(p_zoo, "_STORE", root)
    return root


def _classifier(exp):
    from autognothi_tpu_torch.params import load_params_file

    return load_params_file(exp / "classifier-epoch-0.ckpt")


def test_pretrained_base_round_trip_between_the_packages(tmp_path, store):
    from autognothi_tpu.pipeline.pretrain_classifier import \
        pretrain_classifier as j_pretrain
    from autognothi_tpu.pipeline.train_all import \
        conv_pretrained_classifier as j_conv
    from autognothi_tpu_torch.params import load_params_file
    from autognothi_tpu_torch.pipeline.pretrain_classifier import \
        pretrain_classifier as p_pretrain
    from autognothi_tpu_torch.pipeline.train_all import \
        conv_pretrained_classifier as p_conv

    # the port fine-tunes a ViT (every parameter trained one epoch) and
    # the JAX package builds a classifier on it
    hp = vit_hparams()
    ft = write_exp(tmp_path, "ft_vit_tiny_imagenette", hp)
    with ExpEnv(ft) as env:
        p_pretrain(env, device="cpu")
    exported = load_params_file(store / "ft_vit_tiny_imagenette" / "params.npz")
    before = load_params_file(ft / "classifier-epoch-0.ckpt")
    assert any(not np.array_equal(exported[k], before[k]) for k in before)
    hp2 = vit_hparams()
    hp2["net"]["base_model"] = "ft_vit_tiny_imagenette"
    user = write_exp(tmp_path, "jax_user", hp2)
    j_conv(JaxEnv(user))
    got = _classifier(user)
    assert sorted(got) == sorted(exported)
    assert all(np.array_equal(got[k], exported[k]) for k in exported)
    assert json.loads((store / "ft_vit_tiny_imagenette" / "model.json").read_text()) \
        == hp["net"]["params"]

    # the JAX package exports a BERT with its tokenizer and the port
    # builds a classifier on it
    hp = bert_hparams()
    hp["train_classifier"]["epochs"] = 0
    ft = write_exp(tmp_path, "ft_bert_mini_yelp", hp)
    j_pretrain(JaxEnv(ft))
    hp2 = bert_hparams()
    hp2["net"]["base_model"] = "ft_bert_mini_yelp"
    user = write_exp(tmp_path, "port_user", hp2)
    with ExpEnv(user) as env:
        p_conv(env, "cpu")
    exported = load_params_file(store / "ft_bert_mini_yelp" / "params.npz")
    got = _classifier(user)
    assert all(np.array_equal(got[k], exported[k]) for k in exported)
    assert (store / "ft_bert_mini_yelp" / "tokenizer" / "vocab.txt").read_text(
        ).split() == VOCAB


def test_pretrain_refuses_what_the_jax_package_refuses(tmp_path, store):
    from autognothi_tpu_torch.pipeline.pretrain_classifier import \
        pretrain_classifier
    from autognothi_tpu_torch.zoo.loader import preload_all_params

    exp = write_exp(tmp_path, "ltt", _ltt_vit_hparams())
    with ExpEnv(exp) as env, pytest.raises(ValueError,
                                           match="unsupported model kind"):
        pretrain_classifier(env, device="cpu")
    assert not store.exists()
    with pytest.raises(FileNotFoundError, match="gg_vit_large"):
        preload_all_params()


# ------------------------------------------------- the verbs via the CLI


VERBS = {
    "run_text_explanation": ("bert", ["--into", "{exp}/t.json", "--limit",
                                      "3"]),
    "run_image_explanation": ("vit", ["--into", "{exp}/i.json"]),
    "__preview_text_shapley__": ("bert", ["--dataset", "nlp_samples"]),
    "__show_fridge__": ("bert", []),
    "estimate_train_time": ("vit", []),
    "pretrain_classifier": ("vit", []),
    "preload_all": (None, []),
}


def _staged_exp(root, name, hp):
    """A mini experiment whose every stage has a checkpoint (the port's
    inits) and a cached train-resources report."""
    exp = write_exp(root, name, hp)
    _, (pr, pc) = _recipes(hp)
    gen = torch.Generator().manual_seed(1)
    for section in ("classifier", "surrogate", "explainer", "final"):
        epoch = hp[f"train_{section}"]["epochs"] if section != "final" else 0
        save_params(exp / f"{section}-epoch-{epoch}.ckpt",
                    getattr(pr, f"init_{section}")(pc, gen))
    _train_resources_report(exp)
    return exp


@pytest.fixture(scope="module")
def verb_runs(tmp_path_factory):
    """Each verb through `python -m autognothi_tpu_torch <verb> <exp>
    --device cpu` in its own copy of a mini vanilla BERT (the text verbs)
    or ViT, the seven processes at once -> {verb: (process, exp, args)}."""
    root = tmp_path_factory.mktemp("verbs")
    env = dict(_clean_env(), AUTOGNOTHI_ZOO=str(root / "zoo"))
    runs = {}
    for verb, (family, flags) in VERBS.items():
        args = [verb]
        exp = None
        if family is not None:
            exp = _staged_exp(root, verb.strip("_"),
                              bert_hparams() if family == "bert"
                              else vit_hparams())
            args += [str(exp), *(f.format(exp=exp) for f in flags),
                     "--device", "cpu"]
        proc = subprocess.Popen(
            [sys.executable, "-m", "autognothi_tpu_torch", *args], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        runs[verb] = (proc, exp, args)
    out = {}
    for verb, (proc, exp, args) in runs.items():
        stdout, stderr = proc.communicate(timeout=300)
        out[verb] = (proc.returncode, stdout, stderr, exp, args)
    out["zoo"] = root / "zoo"
    return out


@pytest.mark.parametrize("verb", list(VERBS))
def test_verb_runs_through_python_m_on_the_cpu(verb, verb_runs):
    from autognothi_tpu_torch.cli import main

    code, stdout, stderr, exp, args = verb_runs[verb]
    if verb == "preload_all":  # nothing is cached here: it names them all
        assert code != 0
        for name in ("yelp_polarity", "imagenette", "gg_vit_base",
                     "bert_tayp", "downloads nothing"):
            assert name in stderr, name
        return
    assert code == 0, stderr[-3000:]
    log = (exp / ".log.txt").read_text()
    if verb == "run_text_explanation":
        assert set(json.loads((exp / "t.json").read_text())["items"]) \
            <= {"0", "1", "2"}
    elif verb == "run_image_explanation":
        assert "saving into" in log and (exp / "i.json").exists()
    elif verb == "__preview_text_shapley__":
        assert stdout.count("[0] ") >= 24  # every sentence, 2 classes
    elif verb == "__show_fridge__":
        assert "Fridge Status on `explainer`" in stdout
    elif verb == "estimate_train_time":
        assert "> explainer:" in log
    else:
        assert (verb_runs["zoo"] / exp.name / "params.npz").exists()
    if not torch.cuda.is_available():  # --device defaults to cuda
        with pytest.raises(RuntimeError, match="cuda"):
            main(args[:-2])


def test_report_verb_on_an_override_dataset_is_not_cached(tmp_path):
    from autognothi_tpu_torch.cli import main

    exp = _staged_exp(tmp_path, "vit", vit_hparams())
    main(["measure_performance", str(exp), "--dataset", "cv_samples",
          "--device", "cpu"])
    assert not (exp / ".reports" / "performance.json").exists()
    assert "[[[ " in (exp / ".log.txt").read_text()
    with pytest.raises(ValueError, match="unknown dataset kind"):
        main(["measure_performance", str(exp), "--dataset", "mnist",
              "--device", "cpu"])
