"""Closed loop: `clients` callers of `ExplainService.explain`, each sending
its next request as soon as its last one is answered (offline or batch
explanation of a data set).  Request sizes come from the mix's law as a
fixed multiset that the run's seed reorders; rows come from a pool made
from the seed during set-up: uint8 images (`images_u8`), or texts
(`texts`) of word counts drawn from the mix's law as a fixed multiset.

End to end: `expl_per_s`, the rows of the requests answered inside the
window over the window."""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from .. import core, serving
from ..reference.wordpiece import WordPiece


def image_pool(run: core.Run, n: int) -> np.ndarray:
    m = run.cell.model
    rng = np.random.default_rng([run.seed, 1])
    return rng.integers(0, 256, size=(n, m["img_channels"], m["img_px_size"],
                                      m["img_px_size"]), dtype=np.uint8)


def text_pool(run: core.Run, served: serving.Served, n: int) -> list:
    mix = run.cell.mix
    lengths = serving.fixed_draws(mix["seed"] + 2, n, mix["words"])
    rng = np.random.default_rng([run.seed, 1])
    return [serving.make_text(rng, served.words, int(k)) for k in lengths]


def run(r: core.Run) -> dict:
    mix, spec = r.cell.mix, r.cell.spec
    payload = mix["payload"]
    if payload not in ("images_u8", "texts"):
        raise ValueError(f"closed_serve sends images_u8 or texts, not "
                         f"{payload!r}")
    if payload == "texts" and r.cell.serve_bits() is not None:
        raise ValueError("closed_serve compares texts with the float32 "
                         "reference; it has no W8A8 text reference")
    served = serving.Served(r)
    if payload == "texts":
        pool = text_pool(r, served, mix["pool"])

        def request(idx):
            return {"texts": [pool[i] for i in idx]}
    else:
        pool = image_pool(r, mix["pool"])

        def request(idx):
            return {"images_u8": pool[idx]}
    sizes = serving.fixed_draws(mix["seed"], mix["sizes_per_client"],
                                mix["rows"])
    orders = [np.random.default_rng([r.seed, 2, c]).permutation(sizes)
              for c in range(mix["clients"])]
    picks = np.random.default_rng([r.seed, 3])
    sample = serving.Sample(r.seed, spec["sample"]["p"],
                            spec["sample"]["max_rows"], mix["rows"]["max"])
    # the largest request once more, through explain(): the payload's path
    # and the answer's conversion are warm before the window
    served.service.explain(request(np.arange(mix["rows"]["max"])))
    r.sync()
    r.log(f"set-up {r.setup_done():.2f} s")

    lock = threading.Lock()
    done = {"rows": 0, "requests": 0, "failed": 0, "late_rows": 0}
    t_end = [0.0]

    def client(c: int):
        from torch.profiler import record_function

        k = 0
        while time.perf_counter() < t_end[0]:
            n = int(orders[c][k % len(orders[c])])
            with lock:
                idx = picks.integers(0, len(pool), size=n)
            k += 1
            try:
                with record_function("bench.explain"):
                    resp = served.service.explain(request(idx))
            except Exception as err:  # noqa: BLE001 — counted as failed
                with lock:
                    done["failed"] += 1
                r.log(f"request failed: {err!r}")
                continue
            t = time.perf_counter()
            with lock:
                done["requests"] += 1
                if t <= t_end[0]:
                    done["rows"] += n
                else:
                    done["late_rows"] += n
            sample.offer(idx, resp)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(mix["clients"])]
    before = served.batcher_counts()
    with core.window(r) as w:
        t_end[0] = w.t0 + r.seconds
        for t in threads:
            t.start()
        time.sleep(max(0.0, t_end[0] - time.perf_counter()))
        after = served.batcher_counts()
    for t in threads:
        t.join(timeout=120)
        if t.is_alive():
            raise RuntimeError("a client did not finish within 120 s of "
                               "the window's close")
    memory = core.memory_peak(r)
    served.close()

    # the reference over the kept rows, after the program is freed
    inputs = [row for k in sample.kept for row in k["inputs"]]
    probs = np.concatenate([k["logits"] for k in sample.kept])
    attrs = np.concatenate([k["attributions"] for k in sample.kept])

    if payload == "texts":
        word_piece = WordPiece(served.vocab)
        t_len = r.cell.model["max_position_embeddings"]

        def batch_of(idx):
            return torch.from_numpy(np.stack(
                [word_piece.encode(pool[i], t_len) for i in idx])).to(
                    r.device)
    else:
        def batch_of(idx):
            x = torch.from_numpy(pool[np.asarray(idx)]).to(r.device)
            return x.float() * (1.0 / 255.0)

    def forward(params, model, idx, **kw):
        return served.ref.final(params, model, batch_of(idx), **kw)

    t0 = time.perf_counter()
    ref_p, ref_a = serving.reference_outputs(
        r, served.params, forward, inputs, spec["sample"]["chunk"],
        bits=r.cell.serve_bits())
    gaps = serving.compare(probs, attrs, ref_p, ref_a)
    r.log(f"reference over {len(inputs)} rows of {len(sample.kept)} "
          f"requests in {time.perf_counter() - t0:.2f} s")
    return {
        "end_to_end": {"expl_per_s": done["rows"] / r.seconds},
        "checks": serving.checks_from(gaps, spec["limits"]),
        "attempted": done["requests"] + done["failed"],
        "failed": done["failed"],
        "memory_peak_bytes": memory,
        "layer": {"cell": r.cell, "window_s": w.seconds, "trace": w.trace,
                  "batch": served.batch, "rows": after["rows"]
                  - before["rows"], "slabs": after["slabs"]
                  - before["slabs"], "answered_rows": done["rows"],
                  "int8": r.cell.serve_bits() == 8},
        "notes": [f"rows answered after the close: {done['late_rows']}",
                  f"kept for the comparison: {len(inputs)} rows"],
    }
