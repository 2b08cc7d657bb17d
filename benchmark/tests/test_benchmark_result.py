"""The last line's schema, the faults that `correct` has to catch, and the
controls, on tiny copies of the cells (the CPU, the program's plain
versions) or, marked `cuda`, at the cells' own sizes on the card."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import control, core, run
from benchmark.tests.test_benchmark_manifest import CELLS

CPU = torch.device("cpu")
SERVE = [c for c in CELLS if "train" not in c]
TRAIN = [c for c in CELLS if "train" in c]


def execute(bench, name, trace=False, seconds=1.0):
    cell = core.load_cell(name, bench)
    return cell, run.execute(cell, 2 ** 31 + 101, seconds, trace, CPU,
                             time.perf_counter())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_last_line_schema(tiny, name, trace):
    cell, done = execute(tiny, name, trace)
    lines = run.report(done, "cpu stand-in", 1)
    line = json.loads(lines[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = cell.per_layer() if trace else cell.end_to_end()
    # a reader that finds nothing to read (no device here) leaves its
    # metric out; everything reported is the cell's and in its unit
    units = {m["name"]: m["unit"] for m in want}
    assert set(line["metrics"]) <= set(units)
    for k, v in line["metrics"].items():
        assert v["unit"] == units[k] and v["value"] == v["value"]
    if not trace:
        assert set(line["metrics"]) == set(units)
    else:
        assert {"busy_s", "window_s", } <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    for c in done["checks"]:
        assert line["checks"][c["name"]] == {"value": c["value"],
                                             "limit": c["limit"]}
    assert lines[-2].startswith("[bench] check ")


def test_without_a_card_no_result():
    out = subprocess.run(
        [sys.executable, str(core.BENCH_DIR / "run.py"), "--workload",
         CELLS[0], "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and '"correct"' not in out.stdout


def _alter_answers(monkeypatch, family, share):
    """A fault: every slab's first answer altered where it is produced, one
    attribution moved by `share` of its row's largest."""
    import importlib

    mod = importlib.import_module(f"autognothi_tpu_torch.recipes.{family}")
    real = mod.fw_final

    def altered(cfg, model, xs):
        probs, attr = real(cfg, model, xs)
        attr = attr.clone()
        attr[0, 0, 0] += share * attr[0].abs().max()
        return probs, attr

    monkeypatch.setattr(mod, "fw_final", altered)


@pytest.mark.parametrize("name", SERVE)
def test_an_altered_answer_is_not_correct(tiny, monkeypatch, name):
    """Moved by half its row's largest attribution: a wrong answer, far
    beyond what int8 rounding moves (float32 cells catch a hundredth)."""
    cell = core.load_cell(name, tiny)
    _alter_answers(monkeypatch, cell.family,
                   0.5 if cell.serve_bits() else 0.01)
    _, done = execute(tiny, name)
    assert not done["correct"], done["checks"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        tiny, monkeypatch):
    from autognothi_tpu_torch.pipeline import training

    monkeypatch.setattr(training.AdamW, "update",
                        lambda self, *a, **k: None)
    for name in TRAIN:
        _, done = execute(tiny, name)
        assert not done["correct"], done["checks"]


def test_half_the_batch_left_out_is_not_correct(tiny, monkeypatch):
    from autognothi_tpu_torch.parallel import train_step

    real = train_step.loss_shapley

    def half(mask, v_0, v_s, v_1, phi, weights=None):
        h = mask.shape[0] // 2
        return real(mask[:h], v_0, v_s[:h * mask.shape[1]], v_1[:h],
                    phi[:h])

    monkeypatch.setattr(train_step, "loss_shapley", half)
    for name in TRAIN:
        _, done = execute(tiny, name)
        assert not done["correct"], done["checks"]


def test_an_explainer_off_by_a_rounding_is_not_correct(tiny, monkeypatch):
    """The explainer's attributions moved by a thousandth, about what TF32
    products move them by, with the teacher exact: the int8 teacher's
    rounding on both sides of the whole step hides it, and the explainer's
    stage, followed on the program's teacher values, finds it."""
    from autognothi_tpu_torch.parallel import train_step

    real = train_step._explainer_fw

    def off(*a, **k):
        fw = real(*a, **k)

        def moved(*b, **c):
            phi, rest = fw(*b, **c)
            return phi * (1 + 1e-3), rest

        return moved

    monkeypatch.setattr(train_step, "_explainer_fw", off)
    for name in TRAIN:
        _, done = execute(tiny, name)
        assert not done["correct"], done["checks"]
        assert any(c["value"] > c["limit"] for c in done["checks"]
                   if c["name"].startswith("expl_")), done["checks"]


def test_int8_controls_fail_at_test_size(tiny):
    """int4 in place of the int8 the configuration states (a W8A8 serving
    cell; the training cell's teacher)."""
    for name in CELLS:
        cell = core.load_cell(name, tiny)
        if cell.serve_bits() != 8 and name not in TRAIN:
            continue
        r = core.Run(cell, 2 ** 31 + 9, 0.0, False, CPU, 0.0)
        got = control.train_control(r) if name in TRAIN \
            else control.serve_control(r)
        row = got["int4_teacher"] if name in TRAIN else got["control"]
        assert not row["correct"], got


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_controls_fail_at_the_cells_size(card, name):
    """Every control and fault of the cell, at its own size on three seeds:
    none is correct."""
    cell = core.load_cell(name)
    core.env_for_program(cell)
    for seed in (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23):
        r = core.Run(cell, seed, 0.0, False, card, 0.0)
        got = control.train_control(r) if name in TRAIN \
            else control.serve_control(r)
        for row in got.values():
            assert not row["correct"], got


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN)
def test_a_tf32_program_is_not_correct(card, name):
    """The program's own products on TF32 (torch's switch, which its
    cuBLAS products and plain backward follow), at the cell's size: a
    whole run, read by the run's own comparison, is not correct."""
    cell = core.load_cell(name)
    core.env_for_program(cell)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        done = run.execute(cell, 2 ** 31 + 31, 1.0, False, card,
                           time.perf_counter())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert not done["correct"], done["checks"]
