"""Find the highest request rate the open-loop cell's service sustains:
one process, one service, the rates given in turn, each for `--seconds`.

    python3 benchmark/sweep.py --workload ltt_bert.serve_fp32_open \\
        --seed 7 --seconds 10 --rates 60,80,100,120

Per rate: the offered and answered texts a second, the latency quantiles
from each request's due time, and whether the backlog grew (the median
latency of the window's last quarter of requests against its first).
The cell's `rate_per_s` is set once, by hand, at about four fifths of the
knee; the benchmark's runs never search."""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import core, serving  # noqa: E402
from benchmark.traffic import open_serve  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    cell = core.load_cell(args.workload)
    core.env_for_program(cell)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    r = core.Run(cell, args.seed, args.seconds, False,
                 torch.device("cuda", 0), time.perf_counter())
    served = serving.Served(r)
    print(f"[sweep] {cell.name} on {torch.cuda.get_device_name(0)}; "
          f"{core.card_line()}", flush=True)
    rows = []
    for rate in (float(x) for x in args.rates.split(",")):
        due, sizes, lengths = open_serve.schedule(r, rate)
        texts = open_serve.make_texts(r, served, sizes, lengths,
                                      np.random.default_rng([r.seed, 1]))
        got = open_serve.offer(r, served, due, texts, None)
        lat = got["latency"]
        ok = ~np.isnan(lat)
        q = len(lat) // 4
        row = {"rate_per_s": rate, "texts_per_s": float(sizes.sum())
               / args.seconds,
               "answered_texts_per_s": float(sizes[ok].sum()) / args.seconds,
               "unanswered": int((~ok).sum()),
               "p50_ms": float(np.percentile(lat[ok], 50) * 1e3),
               "p95_ms": float(np.percentile(lat[ok], 95) * 1e3),
               "p99_ms": float(np.percentile(lat[ok], 99) * 1e3),
               "first_quarter_p50_ms": float(np.nanmedian(lat[:q]) * 1e3),
               "last_quarter_p50_ms": float(np.nanmedian(lat[-q:]) * 1e3),
               "occupancy": got["rows"] / max(1, got["slabs"] * served.batch)}
        rows.append(row)
        print(f"[sweep] {json.dumps(row)}", flush=True)
    served.close()
    print(json.dumps({"workload": cell.name, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
