"""BENCHMARK.json against the benchmark's contract, and every cell built
from its files by name, including a cell that exists only in a copy."""

import json
import math
import re
import shutil

import pytest
import torch

from benchmark import core, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MANIFEST = core.read_json(core.REPO / "BENCHMARK.json")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_names():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["benchmark"]
    assert m["command"][1] == "benchmark/run.py"
    assert 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        cfg = core.read_json(core.REPO / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert not any(k.endswith(("_dim", "_rank", "_size"))
                       for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in m["configs"]} == {w["config"]
                                                 for w in m["workloads"]}


def test_metrics_follow_the_contract():
    m = MANIFEST
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= x["bound"] <= 0.25 and UNIT.match(x["unit"])
        assert x["source"] in ("host_clock", "device_trace")
    layers = {}
    for x in m["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["moves"] in e2e and UNIT.match(x["unit"])
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in x["workloads"]:
            assert w in CELLS
            assert w in e2e[x["moves"]].get("workloads", CELLS)
        layers.setdefault(x["name"].split(".")[0], set()).add(x["layer"])
        # every metric has a reader, found by the name before the dot
        assert hasattr(core.reader(x["name"]), "read")
    assert all(len(v) == 1 for v in layers.values())
    for cell in CELLS:
        c = core.load_cell(cell)
        reported = [x["name"] for x in c.end_to_end()]
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer()
        # a roofline that moves a metric has a share of the peak beside it
        rooflines = {x["moves"] for x in c.per_layer()
                     if x["name"].endswith("_roofline")
                     or "_roofline." in x["name"]}
        mfus = {x["moves"] for x in c.per_layer() if "mfu" in x["name"]}
        assert rooflines <= mfus


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_builds_from_its_files(name):
    cell = core.load_cell(name)
    assert cell.spec["config"] == cell.entry["config"]
    assert core.module("traffic", cell.mix["driver"]).run
    assert core.module("reference", cell.family).param_specs
    assert core.module("work", cell.family)
    for k, v in cell.spec["limits"].items():
        assert 0 < v < math.inf, k


def test_a_cell_added_as_files_only_is_found_and_runs(tiny):
    """A throwaway cell whose files exist only in the temporary copy: a
    new cell file and a new manifest entry, no code."""
    manifest = core.read_json(tiny.parent / "BENCHMARK.json")
    manifest["workloads"].append({
        "name": "ltt_vit.serve_fp32_c4", "config": "ltt_vit_b16_224",
        "traffic": "closed4_u8", "chips": 1, "why": "a test cell"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "ltt_vit.serve_fp32" in m.get("workloads", []):
            m["workloads"].append("ltt_vit.serve_fp32_c4")
    (tiny.parent / "BENCHMARK.json").write_text(json.dumps(manifest))
    mix = core.read_json(tiny / "traffic" / "closed16_u8.json")
    mix["clients"] = 4
    (tiny / "traffic" / "closed4_u8.json").write_text(json.dumps(mix))
    spec = core.read_json(tiny / "workloads" / "ltt_vit.serve_fp32.json")
    spec["traffic"] = "closed4_u8"
    (tiny / "workloads" / "ltt_vit.serve_fp32_c4.json").write_text(
        json.dumps(spec))
    with pytest.raises(KeyError):
        core.load_cell("ltt_vit.serve_fp32_c4")
    cell = core.load_cell("ltt_vit.serve_fp32_c4", tiny)
    assert cell.mix["clients"] == 4
    done = run.execute(cell, 2 ** 31 + 77, 1.0, False, torch.device("cpu"),
                       0.0)
    assert done["correct"], done["checks"]
    assert set(done["metrics"]) == {"expl_per_s", "setup_s"}


def test_the_open_loop_cell_returns_by_a_manifest_entry(tiny):
    """The open-loop BERT cell's files are kept without a manifest entry:
    the entry and its tail metric alone bring it back, and it runs."""
    manifest = core.read_json(tiny.parent / "BENCHMARK.json")
    name = "ltt_bert.serve_fp32_open"
    manifest["workloads"].append({
        "name": name, "config": "ltt_bert_base_512",
        "traffic": "open_texts_yelp", "chips": 1, "why": "a test cell"})
    manifest["end_to_end"].append({
        "name": "p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
        "source": "host_clock", "workloads": [name]})
    (tiny.parent / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = core.load_cell(name, tiny)
    done = run.execute(cell, 2 ** 31 + 78, 1.0, False, torch.device("cpu"),
                       0.0)
    assert done["correct"], done["checks"]
    assert set(done["metrics"]) == {"p95_ms", "setup_s"}


def test_paths_hold_only_the_benchmark(tmp_path):
    """Run from a directory holding only BENCHMARK.json and the files
    under `paths`: the program is not there, and no result is printed."""
    import subprocess
    import sys

    shutil.copy(core.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
