"""Tiny copies of the benchmark's data files for CPU runs of the harness:
`tiny_bench(tmp)` copies BENCHMARK.json and the data directories into a
temporary benchmark directory and shrinks every configuration and mix, so
that a cell runs end to end on the CPU in seconds with the plain
versions of the program's kernel ops."""

from __future__ import annotations

import json
import pathlib
import shutil

from benchmark import core

TINY_MODEL = {
    "ltt_vit": dict(hidden_size=32, intermediate_size=64,
                    num_attention_heads=4, num_hidden_layers=2,
                    s_attn_hidden_size=16, s_attn_intermediate_size=32,
                    explainer_s_head_hidden_size=32, num_labels=3,
                    img_px_size=32, img_patch_size=8),
    "ltt_bert": dict(hidden_size=32, intermediate_size=64,
                     num_attention_heads=4, num_hidden_layers=2,
                     s_attn_hidden_size=16, s_attn_intermediate_size=32,
                     explainer_s_head_hidden_size=32,
                     max_position_embeddings=32, vocab_size=600),
}
TINY_MIX = {
    "closed_serve": dict(clients=2, sizes_per_client=8, pool=16,
                         rows={"law": "log_uniform_int", "min": 1,
                               "max": 4},
                         words={"law": "lognormal_int", "median": 8,
                                "sigma": 0.5, "min": 3, "max": 40}),
    "open_serve": dict(client_threads=4,
                       rows={"law": "uniform_int", "min": 1, "max": 2},
                       words={"law": "lognormal_int", "median": 8,
                              "sigma": 0.5, "min": 3, "max": 40}),
    "train_steps": dict(batch=2, coalitions=4),
}


def tiny_bench(tmp: pathlib.Path) -> pathlib.Path:
    """-> a benchmark directory under tmp with BENCHMARK.json beside it."""
    root = pathlib.Path(tmp) / "checkout"
    bench = root / "benchmark"
    bench.mkdir(parents=True)
    shutil.copy(core.REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("configs", "traffic", "workloads"):
        shutil.copytree(core.BENCH_DIR / sub, bench / sub,
                        ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    for f in (bench / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["model"].update(TINY_MODEL[cfg["family"]])
        if "vocab_words" in cfg:
            cfg["vocab_words"] = 400
        f.write_text(json.dumps(cfg))
    for f in (bench / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix.update(TINY_MIX[mix["driver"]])
        f.write_text(json.dumps(mix))
    for f in (bench / "workloads").glob("*.json"):
        spec = json.loads(f.read_text())
        spec["serve"] = dict(spec.get("serve", {}), batch_size=4) \
            if "serve" in spec else spec.get("serve")
        if "rate_per_s" in spec:
            spec["rate_per_s"] = 20.0
        if "sample" in spec:
            spec["sample"] = {"p": 0.5, "max_rows": 16, "chunk": 4}
        f.write_text(json.dumps({k: v for k, v in spec.items()
                                 if v is not None}))
    return bench
