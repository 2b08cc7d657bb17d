"""Open loop: requests of independent users arrive on a schedule, whatever
the service's pace (an explanation service).  The schedule is the cell's
fixed rate with exponential gaps; gaps, request sizes and text lengths
are fixed multisets drawn from the mix's own seed, which the run's seed
reorders; the words come from the run's seed.  A pool of threads calls
`ExplainService.explain` at each request's due time; a request waits in
the pool's queue when every thread is busy, and that wait counts.

End to end: `p95_ms`, the 95th percentile over every request due in the
window of the time from when it was due to its answer.  Answers that come
after the window's close are waited for, up to a minute."""

from __future__ import annotations

import concurrent.futures as cf
import threading
import time

import numpy as np
import torch

from .. import core, serving
from ..reference.wordpiece import WordPiece

WAIT_AFTER_S = 60.0


def schedule(r: core.Run, rate: float):
    """-> (due offsets in seconds, request sizes, words per text) of the
    requests due in the window."""
    mix = r.cell.mix
    n = int(round(rate * r.seconds * 1.5)) + 8
    order = np.random.default_rng([r.seed, 2])
    gaps = order.permutation(serving.fixed_draws(
        mix["seed"], n, {"law": "exponential", "mean": 1.0 / rate}))
    sizes = order.permutation(serving.fixed_draws(mix["seed"] + 1, n,
                                                  mix["rows"]))
    due = np.cumsum(gaps)
    keep = due < r.seconds
    lengths = order.permutation(serving.fixed_draws(
        mix["seed"] + 2, int(sizes[keep].sum()), mix["words"]))
    return due[keep], sizes[keep], lengths


def make_texts(r: core.Run, served, sizes, lengths, rng):
    texts, at = [], 0
    for n in sizes:
        texts.append([serving.make_text(rng, served.words, int(k))
                      for k in lengths[at:at + n]])
        at += n
    return texts


def offer(r: core.Run, served, due, texts, sample) -> dict:
    """Send each request at its due time from a pool of threads; wait for
    every answer (up to WAIT_AFTER_S past the close) -> latencies (NaN
    where none came), the generator's lateness, failures, the batcher's
    counts over the window, the window."""
    mix = r.cell.mix
    latency = np.full(len(due), np.nan)
    late = np.zeros(len(due))
    failed = [0]
    lock = threading.Lock()

    def call(i: int, t_due: float):
        from torch.profiler import record_function

        try:
            with record_function("bench.explain"):
                resp = served.service.explain({"texts": texts[i]})
        except Exception as err:  # noqa: BLE001 — counted as failed
            with lock:
                failed[0] += 1
            r.log(f"request {i} failed: {err!r}")
            return
        latency[i] = time.perf_counter() - t_due
        if sample is not None:
            sample.offer(texts[i], resp)

    pool = cf.ThreadPoolExecutor(max_workers=mix["client_threads"],
                                 thread_name_prefix="bench-client")
    before = served.batcher_counts()
    futures = []
    with core.window(r) as w:
        for i, offset in enumerate(due):
            t_due = w.t0 + offset
            wait = t_due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[i] = time.perf_counter() - t_due
            futures.append(pool.submit(call, i, t_due))
        time.sleep(max(0.0, w.t0 + r.seconds - time.perf_counter()))
        after = served.batcher_counts()
    cf.wait(futures, timeout=WAIT_AFTER_S)
    pool.shutdown(wait=True, cancel_futures=True)
    for f in futures:
        if f.done():
            f.result()
    return {"latency": latency, "late": late, "failed": failed[0],
            "rows": after["rows"] - before["rows"],
            "slabs": after["slabs"] - before["slabs"], "window": w}


def run(r: core.Run) -> dict:
    mix, spec = r.cell.mix, r.cell.spec
    if mix["payload"] != "texts":
        raise ValueError(f"open_serve sends texts, not {mix['payload']!r}")
    if r.cell.serve_bits() is not None:
        raise ValueError("open_serve compares with the float32 reference; "
                         "it has no W8A8 text reference")
    served = serving.Served(r)
    rate = float(spec["rate_per_s"])
    due, sizes, lengths = schedule(r, rate)
    rng = np.random.default_rng([r.seed, 1])
    texts = make_texts(r, served, sizes, lengths, rng)
    warm = [serving.make_text(rng, served.words, int(k))
            for k in lengths[:mix["rows"]["max"]]]
    served.service.explain({"texts": warm})
    r.sync()
    r.log(f"{len(due)} requests, {int(sizes.sum())} texts due; set-up "
          f"{r.setup_done():.2f} s")
    sample = serving.Sample(r.seed, spec["sample"]["p"],
                            spec["sample"]["max_rows"], mix["rows"]["max"])
    got = offer(r, served, due, texts, sample)
    latency, late, w = got["latency"], got["late"], got["window"]
    memory = core.memory_peak(r)
    served.close()
    missing = int(np.isnan(latency).sum()) - got["failed"]

    word_piece = WordPiece(served.vocab)
    t_len = r.cell.model["max_position_embeddings"]
    inputs = [t for k in sample.kept for t in k["inputs"]]
    probs = np.concatenate([k["logits"] for k in sample.kept])
    attrs = np.concatenate([k["attributions"] for k in sample.kept])

    def forward(params, model, chunk, **kw):
        ids = np.stack([word_piece.encode(t, t_len) for t in chunk])
        return served.ref.final(params, model,
                                torch.from_numpy(ids).to(r.device), **kw)

    t0 = time.perf_counter()
    ref_p, ref_a = serving.reference_outputs(
        r, served.params, forward, inputs, spec["sample"]["chunk"])
    gaps = serving.compare(probs, attrs, ref_p, ref_a)
    r.log(f"reference over {len(inputs)} texts of {len(sample.kept)} "
          f"requests in {time.perf_counter() - t0:.2f} s")
    answered = latency[~np.isnan(latency)]
    p95 = float(np.percentile(answered, 95)) * 1e3 if answered.size \
        else float("nan")
    return {
        "end_to_end": {"p95_ms": p95},
        "checks": serving.checks_from(gaps, spec["limits"]),
        "attempted": len(due), "failed": got["failed"] + missing,
        "memory_peak_bytes": memory,
        "layer": {"cell": r.cell, "window_s": w.seconds, "trace": w.trace,
                  "batch": served.batch,
                  "rows": got["rows"], "slabs": got["slabs"],
                  "answered_rows": int(sizes[~np.isnan(latency)].sum()),
                  "int8": False},
        "notes": [f"offered {rate} requests/s ({rate * sizes.mean():.1f} "
                  f"texts/s): {len(due)} requests, {int(sizes.sum())} texts",
                  f"p50 {np.percentile(answered, 50) * 1e3:.3f} ms, p99 "
                  f"{np.percentile(answered, 99) * 1e3:.3f} ms, max "
                  f"{answered.max() * 1e3:.3f} ms"
                  if answered.size else "no answers",
                  f"generator lateness p50 {np.percentile(late, 50) * 1e3:.3f}"
                  f" ms, p99 {np.percentile(late, 99) * 1e3:.3f} ms, max "
                  f"{late.max() * 1e3:.3f} ms",
                  f"kept for the comparison: {len(inputs)} texts"],
    }
