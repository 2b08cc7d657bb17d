"""Port parity, the reports: the six reports of the LTT ViT recipe,
`measure_all`'s cache and `run_all`, against the JAX package on one set of
checkpoints (the mini LTT ViT of tests/test_ltt_e2e.py, trained once by
the JAX `train_all`).

Each package measures its own copy of the experiment directory (a report
found in `<exp>/.reports/` is loaded, not computed, so a shared directory
would only reload the first package's files); the port runs on the CPU,
where every kernel op takes its plain version.  Held:
- faithfulness: every curve (`data_*`) and each summary within 1e-5 (the
  two packages' fp32 forwards differ by float noise);
- cls_acc: equal;
- accuracy: equal, with both packages handed the same numpy masks (the
  JAX package draws its masks from `jax.random`, the port from a
  `torch.Generator`: their streams differ, so the test patches each
  package's `mask_uniform_selective`);
- branches_cka: every value within 1e-5;
- performance: parameter counts equal, GFLOPs within 1e-3 relative (both
  count 2*M*N*K per product), times above 0, memory cells labelled;
- train_resources: the schema, times above 0, the memory label;
- each package loads the other's files (the JAX schema refuses the null
  memory cells of a CPU train_resources report, and only those).
Also `ops/cka.py` against the JAX CKA within 1e-6, `perturbation_masks`
against JAX's bit for bit on tied attributions, and `run_all` through
`python -m autognothi_tpu_torch` on the CPU.
"""

import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_ltt_e2e import _ltt_vit_hparams

REPO = pathlib.Path(__file__).resolve().parents[1]
NAMES = ["accuracy.json", "branches_cka.json", "cls_acc.json",
         "faithfulness.json", "performance.json", "train_resources.json"]
ENV_KEYS = ("AUTOGNOTHI_PALLAS", "AUTOGNOTHI_PALLAS_INTERPRET",
            "AUTOGNOTHI_INT8", "AUTOGNOTHI_INT8_TEACHER",
            "AUTOGNOTHI_CKPT_OPT", "AUTOGNOTHI_PROFILE_DIR")


def _clean_env():
    return {k: v for k, v in os.environ.items() if k not in ENV_KEYS}


def _shared_masks():
    """-> (jax_fn, port_fn): `mask_uniform_selective` stand-ins that hand
    both packages the same masks, call by call (both draw in the same
    order: per masked count, per test batch)."""
    calls = {"jax": 0, "port": 0}

    def draw(who, batch, n_players, n_masked):
        rng = np.random.RandomState(1000 + calls[who])
        calls[who] += 1
        ranks = rng.rand(batch, n_players).argsort(-1).argsort(-1)
        return (ranks >= n_masked).astype(np.int32)

    def jax_fn(_key, batch, n_players, n_masked):
        return jnp.asarray(draw("jax", batch, n_players, n_masked))

    def port_fn(_gen, batch, n_players, n_masked):
        return torch.from_numpy(draw("port", batch, n_players, n_masked))

    return jax_fn, port_fn


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    """The JAX-trained mini LTT ViT, measured by each package in its own
    copy -> (jax dir, port dir)."""
    from autognothi_tpu.pipeline.env import ExpEnv as JaxEnv
    from autognothi_tpu.pipeline.measure_all import \
        measure_all as jax_measure_all
    from autognothi_tpu.pipeline.train_all import train_all as jax_train_all
    from autognothi_tpu_torch.cli import main

    root = tmp_path_factory.mktemp("reports")
    trained = root / "trained"
    trained.mkdir()
    (trained / ".hparams.json").write_text(
        json.dumps(_ltt_vit_hparams(), indent=2))
    with mock.patch.dict(os.environ, {}, clear=False):
        for k in ENV_KEYS:
            os.environ.pop(k, None)
        jax_train_all(JaxEnv(trained))
        jax_dir, port_dir = root / "jax", root / "port"
        shutil.copytree(trained, jax_dir)
        shutil.copytree(trained, port_dir)
        jax_masks, port_masks = _shared_masks()
        with mock.patch("autognothi_tpu.pipeline.measure_accuracy."
                        "mask_uniform_selective", jax_masks):
            jax_measure_all(JaxEnv(jax_dir))
        with mock.patch("autognothi_tpu_torch.pipeline.measure_accuracy."
                        "mask_uniform_selective", port_masks):
            main(["measure_all", str(port_dir), "--device", "cpu"])
    return jax_dir, port_dir


def _report(exp, name):
    return json.loads((exp / ".reports" / name).read_text())


def _close(got, want, tol, path=""):
    """Nested JSON values equal in structure, floats within tol."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _close(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= tol, (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_measure_all_writes_the_six_reports(measured):
    jax_dir, port_dir = measured
    produced = sorted(p.name for p in (port_dir / ".reports").iterdir())
    assert produced == NAMES  # dual-task similarity is off for LTT ViT
    assert produced == sorted(p.name for p in (jax_dir / ".reports")
                              .iterdir())
    for name in NAMES:  # the same keys in the same order
        assert list(_report(port_dir, name)) == list(_report(jax_dir, name))
    log = (port_dir / ".log.txt").read_text()
    assert "[[[ done all measurements ]]]" in log


def test_faithfulness_matches_jax(measured):
    jax_dir, port_dir = measured
    got = _report(port_dir, "faithfulness.json")
    want = _report(jax_dir, "faithfulness.json")
    _close(got, want, 1e-5)
    assert got["data_cls"] == want["data_cls"]
    assert 0.0 <= got["insertion"]["auc"] <= 1.0
    assert 0.0 <= got["deletion"]["auc"] <= 1.0
    # three stops over 4 players: linspace(0, 4, 3) = 0, 2, 4
    assert list(got["insertion"]["avg"]) == ["0", "2", "4"]


def test_cls_acc_matches_jax(measured):
    jax_dir, port_dir = measured
    got = _report(port_dir, "cls_acc.json")
    assert got == _report(jax_dir, "cls_acc.json")
    assert got["epochs"] == [0, 1, 2]


def test_accuracy_matches_jax_on_shared_masks(measured):
    jax_dir, port_dir = measured
    got = _report(port_dir, "accuracy.json")
    assert got == _report(jax_dir, "accuracy.json")
    assert got["masked_players"] == [0, 2, 4]


def test_branches_cka_matches_jax(measured):
    jax_dir, port_dir = measured
    got = _report(port_dir, "branches_cka.json")
    _close(got, _report(jax_dir, "branches_cka.json"), 1e-5)
    assert got["epochs"] == [0, 1, 2]
    assert sorted(got["by_cls"]) == ["0", "1", "2"]


def test_performance_matches_jax(measured):
    jax_dir, port_dir = measured
    got = _report(port_dir, "performance.json")
    want = _report(jax_dir, "performance.json")
    for stage in ("classifier", "surrogate", "explainer", "final"):
        g, w = got[stage], want[stage]
        assert list(g) == list(w), stage
        assert g["params_all"] == w["params_all"], stage
        assert g["params_trainable"] == w["params_trainable"], stage
        assert g["gflops"] > 0
        assert abs(g["gflops"] - w["gflops"]) <= 1e-3 * w["gflops"], stage
        assert g["time_avg"] > 0 and all(t > 0 for t in g["time"])
        assert len(g["time"]) == len(w["time"])
        # the CPU has no device allocator: labelled null, never 0
        assert g["mem_mib"] is None
        assert "cpu" in g["mem_estimator"]
    assert got["final"]["params_all"] > got["classifier"]["params_all"]


def test_train_resources_schema(measured):
    jax_dir, port_dir = measured
    got = _report(port_dir, "train_resources.json")
    assert list(got) == list(_report(jax_dir, "train_resources.json"))
    assert got["init_tm"] > 0
    for stage in ("srg_tm", "exp_tm"):
        assert got[stage]["avg"] > 0 and len(got[stage]["all"]) == 1
        assert all(t > 0 for t in got[stage]["all"])
    for cell in ("init_mem", "srg_mem", "exp_mem"):
        assert got[cell] is None, cell
    assert got["mem_estimator"].startswith("not_measured")


@pytest.mark.parametrize("name", NAMES)
def test_each_package_loads_the_others_report(measured, name):
    import pydantic

    from autognothi_tpu.pipeline import measure_all as jax_ma
    from autognothi_tpu_torch.cli import REPORTS
    from autognothi_tpu_torch.pipeline.reports import dump_report, \
        load_report

    jax_dir, port_dir = measured
    module, cls, _ = next(v for v in REPORTS.values() if v[2] == name)
    port_cls = getattr(__import__(
        f"autognothi_tpu_torch.pipeline.{module}", fromlist=[cls]), cls)
    jax_cls = getattr(jax_ma, cls)
    # the port reads the JAX file, and writes it back as the JAX file
    jax_text = (jax_dir / ".reports" / name).read_text()
    assert dump_report(load_report(port_cls, json.loads(jax_text))) == \
        jax_text
    # the JAX package reads the port's file (a CPU train_resources holds
    # null memory cells, which its schema types as numbers)
    port_json = _report(port_dir, name)
    if name == "train_resources.json":
        with pytest.raises(pydantic.ValidationError) as err:
            jax_cls.model_validate(port_json)
        assert {e["loc"][0] for e in err.value.errors()} == {
            "init_mem", "srg_mem", "exp_mem"}
        port_json = dict(port_json, init_mem=1.0,
                         srg_mem={"all": [1.0], "avg": 1.0, "std": 0.0},
                         exp_mem={"all": [1.0], "avg": 1.0, "std": 0.0})
    loaded = jax_cls.model_validate(port_json)
    assert json.loads(loaded.model_dump_json(by_alias=True)) == port_json


def test_a_cached_report_is_loaded_not_recomputed(measured, tmp_path):
    from autognothi_tpu_torch.cli import main

    _, port_dir = measured
    exp = tmp_path / "exp"
    shutil.copytree(port_dir, exp)
    acc = _report(exp, "accuracy.json")
    sentinel = dict(acc, accuracy=[0.123] * 3)
    (exp / ".reports" / "accuracy.json").write_text(json.dumps(sentinel))
    before = {n: (exp / ".reports" / n).read_text() for n in NAMES}
    main(["measure_all", str(exp), "--device", "cpu"])
    main(["measure_accuracy", str(exp), "--device", "cpu"])
    assert {n: (exp / ".reports" / n).read_text() for n in NAMES} == before
    # a cached file that does not fit the report's schema raises
    bad = dict(acc, accuracy="high")
    (exp / ".reports" / "accuracy.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="accuracy"):
        main(["measure_accuracy", str(exp), "--device", "cpu"])
    extra = dict(acc, surplus=1)
    (exp / ".reports" / "accuracy.json").write_text(json.dumps(extra))
    with pytest.raises(ValueError, match="surplus"):
        main(["measure_all", str(exp), "--device", "cpu"])
    # --no-run-* skips a report, whatever is cached
    (exp / ".reports" / "accuracy.json").unlink()
    main(["measure_all", str(exp), "--device", "cpu", "--no-run-accuracy"])
    assert not (exp / ".reports" / "accuracy.json").exists()
    assert "[[[ skip: accuracy ]]]" in (exp / ".log.txt").read_text()


def test_report_json_rules():
    """Int dict keys become strings, None is null, field order is kept,
    NaN is null (pydantic's rules); loading validates keys and types."""
    from autognothi_tpu_torch.pipeline.measure_faithfulness import \
        FaithfulnessCurve
    from autognothi_tpu_torch.pipeline.measure_performance import (
        MeasurePerformanceReport, ModelPerformance)
    from autognothi_tpu_torch.pipeline.reports import dump_report, \
        load_report

    curve = FaithfulnessCurve(auc=0.5, avg={0: 1.0, 4: float("nan")},
                              std={0: 0.0, 4: 0.1})
    assert json.loads(dump_report(curve)) == {
        "auc": 0.5, "avg": {"0": 1.0, "4": None}, "std": {"0": 0.0, "4": 0.1}}
    perf = MeasurePerformanceReport(
        classifier=None, surrogate=None, explainer=None,
        final=ModelPerformance(time=[1.0], time_avg=1.0, time_std=0.0,
                               gflops=2.0, params_all=3.0,
                               params_trainable=1.0))
    text = dump_report(perf)
    assert list(json.loads(text)) == ["classifier", "surrogate", "explainer",
                                      "final"]
    assert load_report(MeasurePerformanceReport, json.loads(text)) == perf
    short = json.loads(text)
    del short["final"]["mem_mib"]  # a field with a default may be missing
    assert load_report(MeasurePerformanceReport, short) == perf
    for bad, match in (({"auc": "x", "avg": {}, "std": {}}, "auc"),
                       ({"auc": 1.0, "avg": {"a": 1.0}, "std": {}}, "avg"),
                       ({"auc": 1.0, "avg": {}}, "std: missing"),
                       ({"auc": 1.0, "avg": {}, "std": {}, "x": 1}, "'x'")):
        with pytest.raises(ValueError, match=match):
            load_report(FaithfulnessCurve, bad)


# ---------------------------------------------------- the ops, on their own


def _cka_inputs():
    rng = np.random.RandomState(5)
    x = rng.randn(3, 6, 8).astype(np.float32)  # even count of rows
    y = rng.randn(3, 6, 5).astype(np.float32)
    x[1, 2] = 0.0  # a zero row
    x[2, :2] = x[2, 2:4]  # repeated rows: zero distances
    return x, y


@pytest.mark.parametrize("kind", ["linear", "rbf", "rbf sigma 2.5"])
def test_cka_matches_jax(kind):
    from autognothi_tpu.ops import cka as jax_cka
    from autognothi_tpu_torch.ops import cka as port_cka

    x, y = _cka_inputs()
    if kind == "linear":
        want = jax_cka.linear_cka(jnp.asarray(x), jnp.asarray(y))
        got = port_cka.linear_cka(torch.from_numpy(x), torch.from_numpy(y))
    else:
        sigma = 2.5 if "sigma" in kind else None
        want = jax_cka.kernel_cka(jnp.asarray(x), jnp.asarray(y), sigma)
        got = port_cka.kernel_cka(torch.from_numpy(x), torch.from_numpy(y),
                                  sigma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_perturbation_masks_match_jax_with_ties():
    from autognothi_tpu.pipeline.measure_faithfulness import \
        perturbation_masks as jax_masks
    from autognothi_tpu_torch.pipeline.measure_faithfulness import \
        perturbation_masks as port_masks

    rng = np.random.RandomState(9)
    attr = rng.randint(-2, 3, size=(4, 16)).astype(np.float32)  # many ties
    attr[0] = 0.0
    attr[1, ::2] = -0.0
    stops = np.linspace(0, 16, 7, dtype=np.int64)
    for base in (0, 1):
        want = np.asarray(jax_masks(jnp.asarray(attr), jnp.asarray(stops),
                                    base))
        got = port_masks(torch.from_numpy(attr), torch.from_numpy(stops),
                         base).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_report_helpers_match_jax():
    """`_auc` (mean of midpoints; 0.0 for one stop) and `_paint_curve`
    (std with ddof 0), and the CKA report's ddof-1 stats."""
    from autognothi_tpu.pipeline import measure_branches_cka as jax_cka_r
    from autognothi_tpu.pipeline import measure_faithfulness as jax_f
    from autognothi_tpu_torch.pipeline import \
        measure_branches_cka as port_cka_r
    from autognothi_tpu_torch.pipeline import measure_faithfulness as port_f
    from autognothi_tpu_torch.pipeline.reports import to_json

    curves = [{0: 0.1, 5: 0.4, 9: 0.3}, {0: 0.2, 5: 0.7, 9: 0.9}]
    for one in ({3: 0.25}, curves[0]):
        assert port_f._auc(one) == jax_f._auc(one)
    assert to_json(port_f._paint_curve(curves)) == \
        json.loads(jax_f._paint_curve(curves).model_dump_json())
    lin, krn = [[0.9, 0.8, 0.85], [0.5]], [[0.1, 0.3], [0.2, 0.2]]
    assert to_json(port_cka_r._stat(lin, krn)) == \
        json.loads(jax_cka_r._stat(lin, krn).model_dump_json())


# ------------------------------------------------------ through the CLI


def test_run_all_cli_on_the_cpu(tmp_path):
    exp = tmp_path / "ltt_vit"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(_ltt_vit_hparams(),
                                                  indent=2))
    proc = subprocess.run(
        [sys.executable, "-m", "autognothi_tpu_torch", "run_all", str(exp),
         "--device", "cpu"], cwd=REPO, env=_clean_env(),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(p.name for p in (exp / ".reports").iterdir()) == NAMES
    log = (exp / ".log.txt").read_text()
    for line in ("all stages ok", "verified final model is coherent",
                 "[[[ Measuring: faithfulness ]]]",
                 "[[[ done all measurements ]]]"):
        assert line in log, line
    faith = _report(exp, "faithfulness.json")
    assert 0.0 <= faith["insertion"]["auc"] <= 1.0


def test_report_verbs_refuse_what_is_not_ported(tmp_path):
    from autognothi_tpu_torch.cli import REPORTS, main

    # every net kind of the JAX package is ported: an unknown kind raises
    # a ValueError naming it, as the JAX package's schema does
    hp = _ltt_vit_hparams()
    hp["net"]["kind"] = "quadro_vit"
    unknown = tmp_path / "unknown"
    unknown.mkdir()
    (unknown / ".hparams.json").write_text(json.dumps(hp))
    for verb in (*REPORTS, "measure_all", "run_all"):
        with pytest.raises(ValueError, match="quadro_vit"):
            main([verb, str(unknown), "--device", "cpu"])
    vit = tmp_path / "vit"
    vit.mkdir()
    (vit / ".hparams.json").write_text(json.dumps(_ltt_vit_hparams()))
    # --dataset is ported (tests/test_torch_port_demos.py); imagenette is
    # read from its local cache only, which this package does not hold
    with pytest.raises(FileNotFoundError, match="imagenette"):
        main(["measure_accuracy", str(vit), "--device", "cpu", "--dataset",
              "imagenette"])
    # the dual-task report is ported: measure_all runs it for a recipe
    # that allows it, and writes the file the JAX schema loads
    from autognothi_tpu.pipeline.measure_dual_task_similarity import \
        MeasureDualTaskSimilarityReport as JaxDualTask
    from autognothi_tpu_torch.pipeline import measure_all as ma
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.recipes import ltt_vit

    recipe = ltt_vit.ltt_vit_recipe()
    duo = dataclasses.replace(recipe, measurements=dataclasses.replace(
        recipe.measurements, allow_dual_task_similarity=True))
    ran = []
    report = ma.MeasureDualTaskSimilarityReport(
        epochs=[0, 1], cos_sim_avg=[0.25, 0.5], cos_sim_std=[0.0, 0.125])
    with mock.patch.object(ma, "get_recipe", lambda cfg: (duo, None)), \
            mock.patch.object(ma, "measure_dual_task_similarity",
                              lambda env, device: ran.append(device)
                              or report):
        ma.measure_all(ExpEnv(vit), device="cpu", **{
            f"run_{f}": f == "dual_task_similarity"
            for f in ("accuracy", "faithfulness", "cls_acc", "performance",
                      "train_resources", "branches_cka",
                      "dual_task_similarity")})
    assert ran == ["cpu"]
    written = json.loads((vit / ".reports" / "dual_task_similarity.json")
                         .read_text())
    assert JaxDualTask.model_validate(written).cos_sim_std == [0.0, 0.125]
    if not torch.cuda.is_available():  # --device defaults to cuda
        for verb in (*REPORTS, "measure_all", "run_all"):
            with pytest.raises(RuntimeError, match="cuda"):
                main([verb, str(vit)])


def test_copied_functional_matches_jax():
    """`utils/functional.py` is a copy of the JAX package's (numpy only):
    the same slabs, pads and re-split outputs."""
    from autognothi_tpu.utils import functional as jax_fn
    from autognothi_tpu_torch.utils import functional as port_fn

    rng = np.random.RandomState(2)
    items = [rng.randn(n, 3).astype(np.float32) for n in (2, 0, 5, 1, 4)]

    def run(mod):
        return list(mod.batched(lambda: iter(items), lambda x: x * 2,
                                lambda slab: slab.sum(axis=1, keepdims=True),
                                batch_size=3))

    for got, want in zip(run(port_fn), run(jax_fn)):
        np.testing.assert_array_equal(got, want)
    arrays = [np.arange(7), np.arange(14).reshape(7, 2)]
    for drop in (False, True):
        got = list(port_fn.iter_fixed_batches(arrays, 3, drop))
        want = list(jax_fn.iter_fixed_batches(arrays, 3, drop))
        assert [r for _, r in got] == [r for _, r in want]
        for (g, _), (w, _) in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
