"""Run one cell of the benchmark once, on the card this process is given.

    python3 benchmark/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Loads the cell's files by name (`core.py`), builds the program's side
from the seed, warms every shape the cell uses (set-up), measures for
`--seconds`, checks the answers against the plain reference, and prints
as its last line of standard output one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` a
`breakdown`, and last `checks`, each number compared with its limit
(also the last lines of standard error).  Exits non-zero, printing no
result, without a CUDA card, with fewer cards than the cell asks for, or
when the process holds JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import core  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cell: core.Cell, seed: int, seconds: float, trace: bool,
            device, t_start: float) -> dict:
    """Run the cell's traffic driver and read its metrics -> the parts of
    the result line.  Device-agnostic: `main` decides the device."""
    run = core.Run(cell, seed, seconds, trace, device, t_start)
    driver = core.module("traffic", cell.mix["driver"])
    out = driver.run(run)
    metrics = {}
    if trace:
        for m in cell.per_layer():
            value = core.reader(m["name"]).read(out["layer"])
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
    else:
        values = dict(out["end_to_end"], setup_s=run.t_setup)
        for m in cell.end_to_end():
            metrics[m["name"]] = (values[m["name"]], m["unit"])
    checks = out["checks"]
    correct = out["failed"] == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks)
    return dict(run=run, out=out, metrics=metrics, checks=checks,
                correct=correct)


def report(done: dict, kind: str, chips: int) -> list:
    """The run's closing lines: its notes, each number compared with its
    limit (for standard error), and last the result line."""
    out = done["out"]
    lines = [f"[bench] {note}" for note in out.get("notes", [])]
    dev = {"platform": "gpu", "kind": kind, "count": chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    breakdown = None
    trace = out["layer"].get("trace")
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        breakdown = trace.breakdown()
    lines += [f"[bench] check {c['name']} = {c['value']!r} (limit "
              f"{c['limit']!r})" for c in done["checks"]]
    lines.append(core.result_line(done["correct"], out["attempted"],
                                  out["failed"], done["metrics"], dev,
                                  done["checks"], breakdown))
    return lines


def main(argv=None) -> int:
    args = parse(argv)
    cell = core.load_cell(args.workload)
    core.env_for_program(cell)
    import torch

    chips = int(cell.entry["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"[bench] needs {chips} CUDA card(s); found {found} — no "
              "result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    print(f"[bench] card: {kind}; nvidia-smi: {core.card_line()}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}", flush=True)
    done = execute(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)
    print("[bench] after the run, SM clock, power, temperature: "
          + core.card_line("clocks.sm,power.draw,temperature.gpu"),
          flush=True)
    bad = core.forbidden_modules()
    if bad:
        print(f"[bench] the process holds {bad} after the window — no "
              "result", file=sys.stderr)
        return 3
    bad = core.reference_imports()
    if bad:
        print(f"[bench] the reference imports {bad} — no result",
              file=sys.stderr)
        return 3
    for line in report(done, kind, chips):
        print(line, file=sys.stderr if line.startswith("[bench] check")
              else sys.stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
