"""Port parity, the KernelSHAP BERT baseline: the copied numpy solver
(`ops/kernel_shap.py`) against the JAX package's on the same callback and
data, a mini `kernel_shap_bert` `train_all` in both packages (k-means on
the host: `Xs_train` equal, int32 in both files, and each package's npz
loads in the other), the host final against the JAX package's on the same
checkpoint, the faithfulness report on the host final, the served host
final on `--device cpu`, and the JAX package's `under-trained surrogate`
behaviour with the shipped training blocks (ROADMAP F12).

The mini experiment is tests/test_variants_e2e.py's: the BERT of
tests/test_bert_e2e.py at T = 8 (7 players), 64 coalition samples, 3
background rows.  Tolerances: the solver and k-means bit for bit; the host
final's probabilities within 1e-5 and its attributions within 1e-4 x
max(1, max|ref|) (the WLS solve of 7 players amplifies the last-bit
differences of the classifier's probabilities through the logit link);
faithfulness AUCs within 1e-5.
"""

import copy
import json
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autognothi_tpu.ops import kernel_shap as j_ks
from autognothi_tpu_torch.ops import kernel_shap as p_ks
from tests.test_bert_e2e import make_bert_hparams
from tests.test_torch_port_vanilla import VOCAB, _env, _corpus

CPU = torch.device("cpu")


def _hparams() -> dict:
    hp = make_bert_hparams(len(VOCAB))
    hp["net"]["kind"] = "kernel_shap_bert"
    hp["net"]["params"].update(max_position_embeddings=8,
                               kernel_shap_n_samples=64,
                               kernel_shap_data_size=3)
    hp["train_classifier"]["epochs"] = 0
    hp["train_surrogate"]["epochs"] = 0
    hp["train_explainer"]["epochs"] = 1
    hp["eval_faithfulness"]["resolution"] = 4
    return hp


def _write(root: pathlib.Path, hp: dict) -> pathlib.Path:
    from autognothi_tpu_torch.data.tokenizer import WordPieceTokenizer

    root.mkdir(parents=True)
    WordPieceTokenizer(VOCAB).save(root / "tokenizer")
    (root / ".hparams.json").write_text(json.dumps(hp, indent=2))
    return root


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The mini experiment trained by each package's `train_all` (the JAX
    one on the XLA path)."""
    from autognothi_tpu.pipeline.env import ExpEnv as JaxEnv
    from autognothi_tpu.pipeline.train_all import train_all as jax_train_all
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.train_all import train_all

    root = tmp_path_factory.mktemp("kshap")
    jexp = _write(root / "jax", _hparams())
    pexp = _write(root / "port", _hparams())
    with _env({"AUTOGNOTHI_PALLAS": "0"}):
        jax_train_all(JaxEnv(jexp))
        with ExpEnv(pexp) as env:
            train_all(env, device="cpu")
    return jexp, pexp


def _load(file):
    with np.load(file) as data:
        return {k: data[k] for k in data.files}


# ----------------------------------------------------- the copied solver


def _model(m: int, c: int = 3):
    """A fixed softmax over a random linear map of the rows."""
    w = np.random.RandomState(4).randn(m, c)

    def fn(rows):
        z = np.asarray(rows, np.float64) @ w / m
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    return fn


@pytest.mark.parametrize("m,n_samples", [(7, 64), (7, 14), (12, 300),
                                         (1, 8)])
def test_kernel_shap_and_kmeans_equal_jax(m, n_samples):
    rng = np.random.RandomState(m)
    data = rng.randint(0, 50, (20, m)).astype(np.int64)
    for k in (1, 3, 5):
        got = p_ks.kmeans_compress(data, k, seed=3)
        want = j_ks.kmeans_compress(data, k, seed=3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    background, _ = p_ks.kmeans_compress(data, 3, seed=3)
    x = rng.randint(0, 50, m).astype(np.int64)
    bw = np.ones(background.shape[0])
    got = p_ks.kernel_shap(_model(m), background, bw, x, n_samples)
    want = j_ks.kernel_shap(_model(m), background, bw, x, n_samples)
    assert got.shape == (3, m)
    np.testing.assert_array_equal(got, want)
    # efficiency: the attributions sum to the logit difference
    f = _model(m)
    total = p_ks._logit(f(x[None])[0]) - p_ks._logit(f(background).mean(0))
    np.testing.assert_allclose(got.sum(axis=1), total, atol=1e-9)


# ------------------------------------------------------- train_all, final


def test_train_all_stores_the_same_background(trained):
    from autognothi_tpu.pipeline.resources import \
        load_params_file as jax_load

    jexp, pexp = trained
    for name in ("explainer-epoch-1.ckpt", "final-epoch-0.ckpt"):
        key = "Xs_train" if name.startswith("explainer") \
            else "explainer.Xs_train"
        j, p = _load(jexp / name), _load(pexp / name)
        assert j[key].dtype == p[key].dtype == np.int32
        assert j[key].shape == (3, 8)
        np.testing.assert_array_equal(p[key], j[key])
        assert set(p) == set(j)
        # each package reads the other's file
        assert np.asarray(jax_load(pexp / name)[key]).dtype == np.int32
    assert (j["explainer.Xs_train"] != 0).any()
    log = (pexp / ".log.txt").read_text()
    for line in ("skip: classifier cannot be trained",
                 "skip: surrogate cannot be trained",
                 "> compressed data: (3, 8)",
                 "skipped: net recipe does not support this",
                 "all stages ok"):
        assert line in log, line


def _xs(n: int = 2) -> np.ndarray:
    from autognothi_tpu_torch.data.tokenizer import (WordPieceTokenizer,
                                                     encode_batch)

    return encode_batch(WordPieceTokenizer(VOCAB), _corpus()[:n], 8)


def test_host_final_matches_jax(trained):
    """fw_final on the JAX package's final: probabilities and the WLS
    attributions over every player but CLS."""
    from autognothi_tpu.pipeline.config import ExpConfig as JaxConfig
    from autognothi_tpu.pipeline.resources import get_recipe as jax_recipe
    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.recipes.kernel_shap_bert import \
        kernel_shap_bert_recipe

    jexp, _ = trained
    final = _load(jexp / "final-epoch-0.ckpt")
    jr, jcfg = jax_recipe(JaxConfig(**json.loads(
        (jexp / ".hparams.json").read_text())))
    pr = kernel_shap_bert_recipe()
    pcfg = pr.t_config(**_hparams()["net"]["params"])
    assert pr.fw_final_host and jr.fw_final_host
    xs = _xs()
    with _env({"AUTOGNOTHI_PALLAS": "0"}):
        j_probs, j_attr = jr.fw_final(
            jcfg, {k: jnp.asarray(v) for k, v in final.items()},
            jnp.asarray(xs))
        with torch.no_grad():
            probs, attr = pr.fw_final(pcfg, from_jax_params(final, pcfg, CPU),
                                      torch.from_numpy(xs))
    assert probs.shape == (2, 2) and attr.shape == (2, 2, 7)
    assert attr.dtype == torch.float32
    np.testing.assert_allclose(probs.numpy(), np.asarray(j_probs),
                               atol=1e-5)
    j_attr = np.asarray(j_attr)
    err = float(np.abs(attr.numpy() - j_attr).max())
    assert err <= 1e-4 * max(1.0, float(np.abs(j_attr).max())), err
    with pytest.raises(NotImplementedError, match="KernelSHAP"):
        pr.fw_explainer(pcfg, None, None, None, None, None)


def test_faithfulness_runs_on_the_host_final(trained, tmp_path):
    """The port's faithfulness report on a copy of the JAX package's
    experiment, against the JAX package's on its own: the same AUCs."""
    from autognothi_tpu.pipeline.env import ExpEnv as JaxEnv
    from autognothi_tpu.pipeline.measure_faithfulness import \
        measure_faithfulness as jax_faith
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.measure_faithfulness import \
        measure_faithfulness
    from autognothi_tpu_torch.pipeline.reports import to_json

    jexp, _ = trained
    exp = tmp_path / "copy"
    shutil.copytree(jexp, exp)
    with _env({"AUTOGNOTHI_PALLAS": "0"}):
        want = jax_faith(JaxEnv(jexp), resolution=4)
        with ExpEnv(exp) as env:
            got = to_json(measure_faithfulness(env, resolution=4,
                                               device="cpu"))
    for curve in ("insertion", "deletion", "insertion_non_ok",
                  "deletion_non_ok"):
        assert np.isfinite(got[curve]["auc"])
        assert abs(got[curve]["auc"] - getattr(want, curve).auc) <= 1e-5
    assert got["data_cls"] == list(want.data_cls)


def test_served_host_final_on_the_cpu(trained):
    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import ExplainService
    from autognothi_tpu_torch.recipes.kernel_shap_bert import \
        kernel_shap_bert_recipe

    _, pexp = trained
    texts = _corpus()[:2]
    with _env({}), ExpEnv(pexp) as env:
        service = ExplainService(env, batch_size=2, device="cpu")
        try:
            out = service.explain({"texts": texts})
        finally:
            service.close()
    pr = kernel_shap_bert_recipe()
    pcfg = pr.t_config(**_hparams()["net"]["params"])
    model = from_jax_params(_load(pexp / "final-epoch-0.ckpt"), pcfg, CPU)
    with _env({}), torch.no_grad():
        probs, attr = pr.fw_final(pcfg, model, torch.from_numpy(_xs()))
    np.testing.assert_allclose(out["logits"], probs.numpy(), atol=1e-6)
    np.testing.assert_allclose(out["attributions"], attr.numpy(), atol=1e-6)


def test_shipped_training_blocks_stop_at_the_surrogate(tmp_path):
    """F12, as the JAX package does it: the shipped experiment trains the
    surrogate 5 epochs, which the recipe does not support, so `train_all`
    skips it and then refuses the epoch-0 surrogate in
    `conv_surrogate_explainer`."""
    from autognothi_tpu.pipeline.env import ExpEnv as JaxEnv
    from autognothi_tpu.pipeline.train_all import train_all as jax_train_all
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.train_all import train_all

    shipped = json.loads((pathlib.Path(__file__).resolve().parents[1]
                          / "experiments/bert_base_tayp_kernel_shap"
                          / ".hparams.json").read_text())
    hp = copy.deepcopy(_hparams())
    hp["train_surrogate"]["epochs"] = shipped["train_surrogate"]["epochs"]
    assert hp["train_surrogate"]["epochs"] == 5
    jexp, pexp = _write(tmp_path / "jax", hp), _write(tmp_path / "port", hp)
    with _env({"AUTOGNOTHI_PALLAS": "0"}):
        with pytest.raises(ValueError, match="under-trained surrogate"):
            jax_train_all(JaxEnv(jexp))
        with ExpEnv(pexp) as env, \
                pytest.raises(ValueError, match="under-trained surrogate"):
            train_all(env, device="cpu")
    for exp in (jexp, pexp):
        assert sorted(p.name for p in exp.glob("*.ckpt")) == \
            ["classifier-epoch-0.ckpt", "surrogate-epoch-0.ckpt"]
        assert "skip: surrogate cannot be trained" in \
            (exp / ".log.txt").read_text()
