"""Port parity, pipeline-parallel trainers (AUTOGNOTHI_PP): the port's
classifier (with `unfreeze_all`), surrogate and explainer trainers of
`pipeline/pp_trainer.py`, run over two gloo processes on the CPU
(tests/torch_port_pp_child.py, and the `python -m autognothi_tpu_torch`
CLI for the explainer), against the JAX package's sequential trainers on
the same checkpoints and data and against the port's one-process
trainers.  It mirrors the JAX package's tests/test_train_pp.py on its
mini experiment (tests/test_train_all_e2e.py's MINI_VIT_HPARAMS, dropout
0; each epoch is one step of 8 images), pallas mode "0" in every run.

Bounds:
- against the JAX trainer: tests/test_train_pp.py's own, parameters
  rtol 5e-3 / atol 5e-4, for the classifier stages, which draw nothing;
  the surrogate and explainer stages draw their coalition masks from the
  port's generator, which cannot reproduce JAX's keys, so their steps
  are held against the JAX steps on the same masks in
  tests/test_torch_port_pipeline.py;
- against the port's one-process trainer: the first epoch (one step) of
  each stage, parameters within 1e-6 where the one-process gradient is
  settled (|g| > 1e-4 max|g|, elsewhere within 2 lr), after that at the
  JAX bound;
- exact resume under AUTOGNOTHI_CKPT_OPT=1, an epoch stopped by SIGTERM
  on one rank only (every rank stops at the same batch): the final
  checkpoint bit-identical to an uninterrupted run.
"""

import contextlib
import copy
import json
import os
import pathlib
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from tests.test_torch_port_scaleout import REPO, free_port, run_world

LR = 1e-3
PP_ENV = {"AUTOGNOTHI_PP": "2", "AUTOGNOTHI_CKPT_OPT": "1"}
CLEAR = ("AUTOGNOTHI_PP", "AUTOGNOTHI_PP_TP", "AUTOGNOTHI_PP_MICROBATCHES",
         "AUTOGNOTHI_CKPT_OPT", "AUTOGNOTHI_DIST_COORD",
         "AUTOGNOTHI_DIST_NPROCS", "AUTOGNOTHI_DIST_PROC_ID")


def _vit_hparams() -> dict:
    from tests.test_train_all_e2e import MINI_VIT_HPARAMS

    hp = copy.deepcopy(MINI_VIT_HPARAMS)
    every = {"ckpt_when": "_:%1==0", "lr": LR, "batch_size": 8}
    hp["train_classifier"] = {"epochs": 2, **every}
    hp["train_surrogate"] = {"epochs": 1, **every}
    hp["train_explainer"] = {"epochs": 2, **every, "n_mask_samples": 2,
                             "lambda_efficiency": 0.0, "lambda_norm": 0.0}
    return hp


def _bert_hparams():
    import autognothi_tpu.data.loader as dl
    from autognothi_tpu.data.tokenizer import build_vocab
    from tests.test_bert_e2e import make_bert_hparams

    samples = json.loads(
        (pathlib.Path(dl.__file__).parent / "nlp_samples.json").read_text())
    vocab = build_vocab([s["inputs"] for s in samples], max_size=400)
    hp = make_bert_hparams(len(vocab))
    hp["train_classifier"] = {"epochs": 1, "ckpt_when": "_:%1==0",
                              "lr": LR, "batch_size": 8}
    return hp, vocab


def _mk(root: pathlib.Path, name: str, hp: dict, vocab=None,
        files=()) -> pathlib.Path:
    """An experiment `name` with `hp`, a tokenizer when given, and copies
    of `files` (paths)."""
    from autognothi_tpu.data.tokenizer import WordPieceTokenizer

    exp = root / name
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    if vocab is not None:
        WordPieceTokenizer(vocab).save(exp / "tokenizer")
    for f in files:
        shutil.copy(f, exp / f.name)
    return exp


@contextlib.contextmanager
def _env(**extra):
    """os.environ without the PP and world variables, plus `extra`."""
    saved = {k: os.environ.pop(k) for k in CLEAR if k in os.environ}
    saved_extra = {k: os.environ.get(k) for k in extra}
    os.environ.update(extra)
    try:
        yield
    finally:
        for k, v in saved_extra.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        os.environ.update(saved)


def _jax_chain(exp: pathlib.Path, stages) -> None:
    """The JAX package's sequential stages, one device's arithmetic
    (mode "0")."""
    from autognothi_tpu.pipeline import train_all as ta
    from autognothi_tpu.pipeline.env import ExpEnv
    from autognothi_tpu.pipeline.train_classifier import train_classifier
    from autognothi_tpu.pipeline.train_explainer import train_explainer
    from autognothi_tpu.pipeline.train_surrogate import train_surrogate

    fns = {"conv_cls": ta.conv_pretrained_classifier,
           "cls": lambda env: train_classifier(env, unfreeze_all=True),
           "conv_srg": ta.conv_classifier_surrogate, "srg": train_surrogate,
           "conv_exp": ta.conv_surrogate_explainer, "exp": train_explainer}
    with _env(AUTOGNOTHI_PALLAS="0"):
        env = ExpEnv(exp)
        for stage in stages:
            fns[stage](env)


def _port(exp: pathlib.Path, stage: str, grads: dict = None, **env) -> None:
    """The port's one-process trainer of `stage` in mode "0"; `grads`, when
    given, takes the first AdamW update's gradients."""
    import importlib

    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.training import AdamW

    mod = importlib.import_module(
        f"autognothi_tpu_torch.pipeline.train_{stage}")
    kw = {"unfreeze_all": True} if stage == "classifier" else {}
    real = AdamW.update

    def spy(self, params, g, lr, mask):
        if grads is not None and not grads:
            grads.update({k: v.detach().numpy().copy()
                          for k, v in g.items() if v is not None})
        return real(self, params, g, lr, mask)

    with _env(AUTOGNOTHI_PALLAS="0", **env), \
            mock.patch.object(AdamW, "update", spy), ExpEnv(exp) as e:
        getattr(mod, f"train_{stage}")(e, device="cpu", **kw)


def _load(exp: pathlib.Path, section: str, epoch: int) -> dict:
    from autognothi_tpu.pipeline.resources import load_params_file

    return dict(load_params_file(exp / f"{section}-epoch-{epoch}.ckpt"))


def _close(got: dict, want: dict, grads: dict = None) -> None:
    """The JAX bound; with `grads` (a one-step run's), where the gradient
    is float noise (not settled) the update's sign is too, and the bound
    is 2 lr there."""
    assert set(got) == set(want)  # pipeline parallelism is invisible on disk
    g_max = grads and max(np.abs(g).max() for g in grads.values())
    for k in sorted(want):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if grads and k in grads:
            sure = np.abs(grads[k]) > 1e-4 * g_max
            assert np.all(np.abs(g - w)[~sure] <= 2.02 * LR), k
            g, w = g[sure], w[sure]
        np.testing.assert_allclose(g, w, rtol=5e-3, atol=5e-4, err_msg=k)


def _settled(got: dict, want: dict, grads: dict) -> None:
    assert set(got) == set(want)
    g_max = max(np.abs(g).max() for g in grads.values())
    for k, w in want.items():
        g = grads.get(k)
        sure = (np.ones(w.shape, bool) if g is None
                else np.abs(g) > 1e-4 * g_max)
        assert np.all(np.abs(got[k] - w)[~sure] <= 2.02 * LR), k
        np.testing.assert_allclose(got[k][sure], w[sure], atol=1e-6, rtol=0,
                                   err_msg=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX chain, the port's one-process runs, and the pipeline-
    parallel runs (one child world of 2, one CLI world of 2)."""
    tmp = tmp_path_factory.mktemp("pp_train")
    hp = _vit_hparams()
    jax_dir = _mk(tmp, "jax", hp)
    _jax_chain(jax_dir, ("conv_cls", "cls", "conv_srg", "srg", "conv_exp",
                         "exp"))
    ck = lambda s, e: jax_dir / f"{s}-epoch-{e}.ckpt"  # noqa: E731
    cls0 = [ck("classifier", 0)]
    srg0 = [ck("classifier", 2), ck("surrogate", 0)]
    exp0 = [ck("surrogate", 1), ck("explainer", 0)]
    bert_hp, vocab = _bert_hparams()
    bert_jax = _mk(tmp, "bert_jax", bert_hp, vocab)
    _jax_chain(bert_jax, ("conv_cls", "cls"))
    bert0 = [bert_jax / "classifier-epoch-0.ckpt"]
    one = {"epochs": 1}
    hp_short = copy.deepcopy(hp)
    hp_short["train_classifier"].update(one)
    dirs = {name: _mk(tmp, name, h, v, files) for name, h, v, files in (
        ("seq_cls", hp, None, cls0), ("seq_srg", hp, None, srg0),
        ("seq_exp", hp, None, exp0), ("seq_bert", bert_hp, vocab, bert0),
        ("seq_resume", hp_short, None, cls0),
        ("pp_cls", hp, None, cls0), ("pp_cls_trip", hp, None, cls0),
        ("pp_resume", hp_short, None, cls0), ("pp_bert", bert_hp, vocab,
                                              bert0),
        ("pp_srg", hp, None, srg0), ("pp_exp", hp, None, exp0),
        ("pp_exp_trip", hp, None, exp0))}
    grads = {k: {} for k in ("cls", "srg", "exp")}
    _port(dirs["seq_cls"], "classifier", grads["cls"])
    _port(dirs["seq_srg"], "surrogate", grads["srg"])
    _port(dirs["seq_exp"], "explainer", grads["exp"])
    _port(dirs["seq_bert"], "classifier")
    _port(dirs["seq_resume"], "classifier")
    (dirs["seq_resume"] / ".hparams.json").write_text(json.dumps(hp))
    _port(dirs["seq_resume"], "classifier")
    trip = {"epoch": 2, "rank": 1}
    no_opt = dict(PP_ENV, AUTOGNOTHI_CKPT_OPT="0")
    runs_ = [
        dict(name="cls", stage="classifier", unfreeze_all=True,
             exp=str(dirs["pp_cls"]), env=PP_ENV),
        dict(name="cls_trip", stage="classifier", unfreeze_all=True,
             exp=str(dirs["pp_cls_trip"]), env=PP_ENV, trip=trip),
        dict(name="cls_resumed", stage="classifier", unfreeze_all=True,
             exp=str(dirs["pp_cls_trip"]), env=PP_ENV),
        dict(name="resume_1", stage="classifier", unfreeze_all=True,
             exp=str(dirs["pp_resume"]), env=no_opt),
        dict(name="resume_2", stage="classifier", unfreeze_all=True,
             exp=str(dirs["pp_resume"]), env=no_opt, hparams=hp),
        dict(name="bert", stage="classifier", unfreeze_all=True,
             exp=str(dirs["pp_bert"]), env=PP_ENV),
        dict(name="srg", stage="surrogate", exp=str(dirs["pp_srg"]),
             env=PP_ENV),
        dict(name="exp_trip", stage="explainer",
             exp=str(dirs["pp_exp_trip"]), env=PP_ENV, trip=trip),
        dict(name="exp_resumed", stage="explainer",
             exp=str(dirs["pp_exp_trip"]), env=PP_ENV)]
    teacher = _teacher_inputs(hp, tmp / "teacher.npz")
    ranks = run_world(dict(tag="trainers", jobs=["trainers", "teacher"],
                           runs=runs_, inputs=str(tmp / "teacher.npz"),
                           cfgs={"vit": teacher["cfg"]}, m=2, lr=LR),
                      2, tmp, module="tests.torch_port_pp_child")
    cli = _cli_world(dirs["pp_exp"], 2)
    return dict(dirs=dirs, jax=jax_dir, bert_jax=bert_jax, grads=grads,
                ranks=ranks, cli=cli, teacher=teacher)


def _teacher_inputs(hp: dict, path: pathlib.Path) -> dict:
    """The mini surrogate and explainer (the port's inits), 8 images and
    their coalition masks for the child's "teacher" job, saved to
    `path`."""
    from autognothi_tpu_torch.models.vit import (VanillaViTConfig,
                                                 init_vit_classifier,
                                                 init_vit_explainer)

    cfg = dict(hp["net"]["params"])
    pcfg = VanillaViTConfig(**cfg)
    srg = init_vit_classifier(pcfg, torch.Generator().manual_seed(5))
    exp = init_vit_explainer(pcfg, torch.Generator().manual_seed(6))
    xs = np.random.RandomState(7).randn(8, 3, 16, 16).astype(np.float32)
    masks = (np.random.RandomState(8).rand(8, 2, pcfg.n_patches)
             > 0.5).astype(np.int32)
    np.savez(path, xs=xs, masks=masks,
             step_null=np.full((1, 3), 1 / 3, np.float32),
             **{f"vit/srg/{k}": v for k, v in srg.items()},
             **{f"step/exp/{k}": v for k, v in exp.items()})
    return dict(cfg=cfg, srg=srg, xs=xs, masks=masks)


def _cli_world(exp: pathlib.Path, nprocs: int) -> list:
    """`python -m autognothi_tpu_torch train_explainer <exp> --device cpu`
    in nprocs gloo ranks with AUTOGNOTHI_PP=2 -> each rank's output."""
    port = free_port()
    procs = []
    for rank in range(nprocs):
        env = {k: v for k, v in os.environ.items() if k not in CLEAR}
        env.update(PP_ENV, AUTOGNOTHI_DIST_COORD=f"127.0.0.1:{port}",
                   AUTOGNOTHI_DIST_NPROCS=str(nprocs),
                   AUTOGNOTHI_DIST_PROC_ID=str(rank), AUTOGNOTHI_PALLAS="0",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "autognothi_tpu_torch", "train_explainer",
             str(exp), "--device", "cpu"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for rank, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=240)
            assert proc.returncode == 0, f"rank {rank}:\n{out[-3000:]}"
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def test_pp_trainer_vit_matches_sequential(runs):
    """The pipeline-parallel fine-tune lands on the JAX trainer's and the
    port's one-process checkpoints (its first epoch, one step, on the
    port's at 1e-6 where settled)."""
    d = runs["dirs"]
    got = _load(d["pp_cls"], "classifier", 2)
    _close(got, _load(runs["jax"], "classifier", 2))
    _close(got, _load(d["seq_cls"], "classifier", 2))
    _settled(_load(d["pp_cls"], "classifier", 1),
             _load(d["seq_cls"], "classifier", 1), runs["grads"]["cls"])


def test_pp_trainer_bert_matches_sequential(runs):
    d = runs["dirs"]
    got = _load(d["pp_bert"], "classifier", 1)
    _close(got, _load(runs["bert_jax"], "classifier", 1))
    _close(got, _load(d["seq_bert"], "classifier", 1))


def test_pp_trainer_resume_from_flat_ckpt(runs):
    """A run resumed from the flat epoch-1 checkpoint (re-split on load,
    fresh moments) matches the one-process run resumed at the same
    epoch."""
    d = runs["dirs"]
    _close(_load(d["pp_resume"], "classifier", 2),
           _load(d["seq_resume"], "classifier", 2))


def test_pp_exact_resume_is_bit_identical(runs):
    """AUTOGNOTHI_CKPT_OPT=1: stopped at epoch 2 by a SIGTERM that only
    rank 1 saw (both ranks stop), then resumed: the final checkpoint is
    bit-identical to the uninterrupted run's; the stage moments
    round-trip through the gathered opt file."""
    d = runs["dirs"]
    for info, _ in runs["ranks"]:
        assert info["cls_trip/interrupted"] is True, info
        assert info["cls_resumed/interrupted"] is False, info
    assert (d["pp_cls_trip"] / "classifier-epoch-1.opt.ckpt").exists() or \
        (d["pp_cls_trip"] / "classifier-epoch-2.opt.ckpt").exists()
    a = _load(d["pp_cls"], "classifier", 2)
    b = _load(d["pp_cls_trip"], "classifier", 2)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pp_opt_ckpt_holds_every_stage(runs):
    """The gathered optimizer file names every parameter once, with the
    one-process file's names."""
    from autognothi_tpu.pipeline.resources import load_params_file

    d = runs["dirs"]
    got = load_params_file(d["pp_cls"] / "classifier-epoch-2.opt.ckpt")
    params = _load(d["pp_cls"], "classifier", 2)
    assert set(got) == {"count", *(f"{m}/{k}" for m in ("mu", "nu")
                                   for k in params)}
    assert int(got["count"]) == 2
    for k, v in params.items():
        assert got[f"mu/{k}"].shape == v.shape, k


def test_pp_surrogate_matches_sequential(runs):
    d = runs["dirs"]
    _settled(_load(d["pp_srg"], "surrogate", 1),
             _load(d["seq_srg"], "surrogate", 1), runs["grads"]["srg"])


def test_pp_explainer_matches_sequential(runs):
    """The explainer through the CLI over two ranks: the port's
    one-process trainer's checkpoints (the first epoch at 1e-6 where
    settled), and the file loads in the JAX package and runs its
    explainer forward."""
    import jax.numpy as jnp

    from autognothi_tpu.pipeline.env import ExpEnv
    from autognothi_tpu.pipeline.resources import get_recipe

    d = runs["dirs"]
    got = _load(d["pp_exp"], "explainer", 2)
    _close(got, _load(d["seq_exp"], "explainer", 2))
    _settled(_load(d["pp_exp"], "explainer", 1),
             _load(d["seq_exp"], "explainer", 1), runs["grads"]["exp"])
    assert all("pipeline-parallel: 1 data x 2 pipe" in out
               for out in runs["cli"])
    recipe, cfg = get_recipe(ExpEnv(runs["jax"]).config)
    n = recipe.n_players(cfg)
    phi, _ = recipe.fw_explainer(
        cfg, {k: jnp.asarray(v) for k, v in got.items()},
        jnp.zeros((2, 3, 16, 16)), jnp.ones((2, n), jnp.int32),
        jnp.ones((2, 3)) / 3, jnp.zeros((1, 3)))
    assert phi.shape == (2, 3, n) and np.all(np.isfinite(np.asarray(phi)))


def test_pp_explainer_exact_resume_bit_identical(runs):
    d = runs["dirs"]
    for info, _ in runs["ranks"]:
        assert info["exp_trip/interrupted"] is True, info
        assert info["exp_resumed/interrupted"] is False, info
    a = _load(d["pp_exp"], "explainer", 2)
    b = _load(d["pp_exp_trip"], "explainer", 2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pp_teacher_keeps_its_kernels_on_a_data1_pipe2_mesh(runs):
    """Fault 2's case: two ranks on a ("data" = 1, "pipe" = 2) mesh, the
    explainer step's teacher on each runs the one-device teacher's kernel
    calls (W8A8, mode "2"), as the JAX `_make_teacher` keeps its kernels
    there; the differentiated forward none."""
    from tests.test_torch_port_pipeline import (check_teacher_on_pipe_mesh,
                                                one_device_teacher_calls)

    t = runs["teacher"]
    check_teacher_on_pipe_mesh(runs["ranks"], one_device_teacher_calls(
        t["cfg"], t["srg"], t["xs"], t["masks"]))


def test_pp_fail_closed():
    """The JAX refusals: a kind that is not vanilla, a pipe that does not
    divide the depth (the batch's: tests/test_torch_port_pipeline.py)."""
    from types import SimpleNamespace

    from autognothi_tpu_torch.pipeline.pp_trainer import _pp_context

    env = SimpleNamespace(log=lambda *_: None)
    cfg = lambda kind: SimpleNamespace(  # noqa: E731
        net=SimpleNamespace(kind=kind))
    for kind in ("ltt_vit", "froyo_bert", "duo_vanilla_vit",
                 "kernel_shap_bert"):
        with pytest.raises(ValueError, match="unsupported net kind"):
            _pp_context(env, cfg(kind), None, {}, lambda n: True, 2, 2, 8,
                        section="classifier", device=torch.device("cpu"))
    m_cfg = SimpleNamespace(num_hidden_layers=2)
    with pytest.raises(ValueError, match="does not divide"):
        _pp_context(env, cfg("vanilla_vit"), m_cfg, {}, lambda n: True,
                    3, 2, 8, section="classifier",
                    device=torch.device("cpu"))


def test_pp_env_parse():
    """The JAX test's cases, with one departure on purpose (F2): there
    AUTOGNOTHI_PP_TP=0 raises with AUTOGNOTHI_PP=2 but means "off" without
    it; here "0", like "1" and unset, means no tensor parallelism either
    way."""
    from autognothi_tpu_torch.parallel.pipeline import pp_config_from_env

    def parse(**env):
        with _env(**env):
            return pp_config_from_env()

    for off in ("", "0", "1"):
        assert parse(AUTOGNOTHI_PP=off) is None
    assert parse() is None
    assert parse(AUTOGNOTHI_PP="2") == (2, 2, 1)  # microbatches = pipe
    assert parse(AUTOGNOTHI_PP="2", AUTOGNOTHI_PP_MICROBATCHES="4") == \
        (2, 4, 1)
    assert parse(AUTOGNOTHI_PP="2", AUTOGNOTHI_PP_MICROBATCHES="4",
                 AUTOGNOTHI_PP_TP="") == (2, 4, 1)
    assert parse(AUTOGNOTHI_PP="2", AUTOGNOTHI_PP_MICROBATCHES="4",
                 AUTOGNOTHI_PP_TP="2") == (2, 4, 2)
    # F2: one meaning for "0"
    assert parse(AUTOGNOTHI_PP="2", AUTOGNOTHI_PP_TP="0") == (2, 2, 1)
    assert parse(AUTOGNOTHI_PP_TP="0") is None
    assert parse(AUTOGNOTHI_PP="2", AUTOGNOTHI_PP_TP="1") == (2, 2, 1)
    with pytest.raises(ValueError):
        parse(AUTOGNOTHI_PP="2", AUTOGNOTHI_PP_MICROBATCHES="0")
    with pytest.raises(ValueError, match="requires AUTOGNOTHI_PP"):
        parse(AUTOGNOTHI_PP_TP="4")


def test_pp_duo_explainer_ignores_pp(tmp_path):
    """As the JAX duo trainer, which never reads AUTOGNOTHI_PP: the duo
    explainer trains under AUTOGNOTHI_PP=2 in a world of one, while the
    duo classifier stage, which reads it, refuses the kind."""
    from autognothi_tpu_torch.pipeline import train_all as ta
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.train_classifier import \
        train_classifier
    from autognothi_tpu_torch.pipeline.train_explainer import \
        train_explainer
    from autognothi_tpu_torch.pipeline.train_surrogate import \
        train_surrogate
    from tests.test_torch_port_vanilla import vit_hparams

    hp = vit_hparams()
    hp["net"]["kind"] = "duo_vanilla_vit"
    hp["train_explainer"]["epochs"] = 1
    exp = _mk(tmp_path, "duo", hp)
    with _env(AUTOGNOTHI_PALLAS="0"), ExpEnv(exp) as env:
        ta.conv_pretrained_classifier(env, device="cpu")
        train_classifier(env, device="cpu")
        ta.conv_classifier_surrogate(env, device="cpu")
        train_surrogate(env, device="cpu")
        ta.conv_surrogate_explainer(env, device="cpu")
    with _env(AUTOGNOTHI_PALLAS="0", AUTOGNOTHI_PP="2"), ExpEnv(exp) as env:
        train_explainer(env, device="cpu")
        assert (exp / "explainer-epoch-1.ckpt").exists()
    hp["train_classifier"]["epochs"] += 1  # the stage has an epoch to run
    (exp / ".hparams.json").write_text(json.dumps(hp))
    with _env(AUTOGNOTHI_PALLAS="0", AUTOGNOTHI_PP="2"), ExpEnv(exp) as env:
        with pytest.raises(ValueError, match="unsupported net kind"):
            train_classifier(env, device="cpu", unfreeze_all=True)
