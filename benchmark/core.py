"""The harness's shared parts: finding a cell's files by name, the run's
context, the profiler's reading, the import guard and the result line.

Data files are found under a benchmark directory (the checkout's
`benchmark/` unless a caller names another):
    BENCHMARK.json (beside it)       the manifest
    configs/<config>.json            one configuration
    traffic/<traffic>.json           one traffic mix (its `driver`)
    workloads/<cell>.json            one cell
Code is found by name in this package: `traffic/<driver>.py`,
`metrics/<metric before the dot>.py`, `reference/<family>.py` and
`work/<family>.py`."""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import pathlib
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

BENCH_DIR = pathlib.Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
# top-level modules the port's process may never hold (whole names)
FORBIDDEN = ("jax", "jaxlib", "flax", "autognothi_tpu")


def read_json(path: pathlib.Path) -> dict:
    return json.loads(pathlib.Path(path).read_text("utf-8"))


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the manifest's workload entry
    spec: dict           # workloads/<cell>.json
    config: dict         # configs/<config>.json
    mix: dict            # traffic/<traffic>.json
    manifest: dict

    @property
    def family(self) -> str:
        return self.config["family"]

    @property
    def model(self) -> dict:
        return self.config["model"]

    def env(self) -> Dict[str, str]:
        """Environment the configuration and the cell set for the program."""
        return {**self.config.get("env", {}), **self.spec.get("env", {})}

    def serve_bits(self) -> Optional[int]:
        """The served final's arithmetic, read from the key the program
        reads: W8A8 (8) where the environment sets AUTOGNOTHI_INT8=1, else
        float32 (None).  The reference works the int8 codes out again."""
        return 8 if self.env().get("AUTOGNOTHI_INT8") == "1" else None

    def end_to_end(self) -> List[dict]:
        return [m for m in self.manifest["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        return [m for m in self.manifest["per_layer"]
                if self.name in m.get("workloads", [self.name])]


def load_cell(name: str, bench_dir: pathlib.Path = BENCH_DIR,
              manifest_path: Optional[pathlib.Path] = None) -> Cell:
    bench_dir = pathlib.Path(bench_dir)
    manifest = read_json(manifest_path or bench_dir.parent
                         / "BENCHMARK.json")
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    spec = read_json(bench_dir / "workloads" / f"{name}.json")
    config = read_json(bench_dir / "configs" / f"{entry['config']}.json")
    mix = read_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    if spec["config"] != entry["config"] or spec["traffic"] != \
            entry["traffic"] or entry["config"] not in configs:
        raise ValueError(f"workloads/{name}.json and BENCHMARK.json name "
                         "different configurations or traffic")
    return Cell(name, entry, spec, config, mix, manifest)


def module(kind: str, name: str):
    """benchmark/<kind>/<name>.py, imported by name."""
    return importlib.import_module(f"benchmark.{kind}.{name}")


def reader(metric: str):
    """The reader of a per-layer metric: the module named by the part of
    the metric's name before the first dot."""
    return module("metrics", metric.split(".", 1)[0])


def cache_env() -> Dict[str, str]:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = REPO / "build" / "bench_cache"
    return {"TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "TRITON_CACHE_DIR": str(cache / "triton"),
            "USE_FLAX": "0", "USE_JAX": "0"}


def card_line(query: str = "name,power.limit,clocks.max.sm") -> str:
    """What nvidia-smi reads of the card: by default its name, power limit
    and top SM clock."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi unavailable ({err})"


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the port's process may not
    hold, compared whole (`autognothi_tpu_torch` is not
    `autognothi_tpu`)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def reference_imports() -> List[str]:
    """Modules of the program or of JAX that a reference module imports
    (the references stand apart from what they judge) -> 'file: module'."""
    import ast

    banned = FORBIDDEN + ("autognothi_tpu_torch",)
    bad = []
    for path in sorted((BENCH_DIR / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text("utf-8"))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".", 1)[0] in banned]
    return bad


class Run:
    """One run of one cell: its arguments, its files, its clock."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device, self.t_start = trace, device, t_start
        self.t_setup: Optional[float] = None

    def log(self, msg: str) -> None:
        print(f"[bench {self.cell.name}] {msg}", file=sys.stderr, flush=True)

    def setup_done(self) -> float:
        """Set-up ends here: the window opens next."""
        self.t_setup = time.perf_counter() - self.t_start
        return self.t_setup

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, tuple], device: dict,
                checks: List[dict], breakdown: Optional[dict] = None) -> str:
    out: Dict[str, Any] = {
        "correct": bool(correct), "attempted": int(attempted),
        "failed": int(failed),
        "metrics": {k: {"value": v, "unit": u}
                    for k, (v, u) in metrics.items()},
        "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return json.dumps(out)


def env_for_program(cell: Cell) -> None:
    """Set what the cell's program reads from its environment, before the
    program is imported."""
    for k, v in {**cache_env(), **cell.env()}.items():
        os.environ[k] = str(v)


class _Window:
    def __init__(self):
        self.t0 = 0.0
        self.seconds = 0.0
        self.trace = None


class window:
    """The measured window: from here to the end of the `with` block.
    With `--trace 1` the profiler records it, marked by the user range
    `trace.WINDOW`, and its reading lands in `.trace` on exit."""

    def __init__(self, run: Run):
        self.run = run
        self.w = _Window()
        self._prof = self._range = None

    def __enter__(self) -> _Window:
        from torch.autograd.profiler import record_function

        if self.run.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.run.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        self._range = record_function("bench.window")
        self._range.__enter__()
        self.w.t0 = time.perf_counter()
        return self.w

    def __exit__(self, *exc):
        from . import trace

        self.w.seconds = time.perf_counter() - self.w.t0
        self._range.__exit__(*exc)
        if self._prof is not None:
            self.run.sync()
            self._prof.__exit__(*exc)
            if exc[0] is None:
                t0 = time.perf_counter()
                self.w.trace = trace.read(self._prof)
                self.run.log(f"trace read in {time.perf_counter() - t0:.1f}"
                             f" s: {len(self.w.trace.kernels)} device "
                             f"activities")
        return False


def memory_peak(run: Run) -> int:
    import torch

    if run.device.type != "cuda":
        return 0
    run.sync()
    return int(torch.cuda.max_memory_allocated(run.device))
