"""The readings that the limits of `correct` are set from, on the card:
the control (the reference put in the program's place, one precision
below the configuration's) and, for a training cell, the faults, each
against the reference, on the cell's own sizes and the seeds given.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

Serving cells: the reference at the configuration's precision against
the control (float32 -> TF32; int8 -> int4) over as many rows as a run
compares, drawn as a run draws them.  The training cell: the reference
steps against the same steps with the teacher in int4 and with the
explainer in TF32 (the controls: each of the step's two stated
precisions one lower), and with half of the batch left out of the loss
(a fault).  Each row says whether the cell's limits find it correct.
The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import core, serving, weights  # noqa: E402
from benchmark.reference import common as ref_common  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402


def serve_inputs(r: core.Run, n_rows: int):
    """A run's kept rows: images of the pool, or texts of the mix."""
    cell = r.cell
    if cell.mix["payload"] == "images_u8":
        from benchmark.traffic.closed_serve import image_pool

        pool = image_pool(r, cell.mix["pool"])
        idx = np.random.default_rng([r.seed, 3]).integers(0, len(pool),
                                                          n_rows)
        x = torch.from_numpy(pool[idx]).to(r.device).float() * (1.0 / 255.0)
        return [x[i:i + 1] for i in range(n_rows)], \
            lambda chunk: torch.cat(chunk)
    from benchmark.reference.wordpiece import WordPiece

    words, vocab = serving.make_vocab(cell.config["vocab_words"],
                                      cell.model["vocab_size"])
    rng = np.random.default_rng([r.seed, 1])
    lengths = serving.fixed_draws(cell.mix["seed"] + 2, n_rows,
                                  cell.mix["words"])
    texts = [serving.make_text(rng, words, int(k)) for k in lengths]
    wp = WordPiece(vocab)
    t_len = cell.model["max_position_embeddings"]
    return texts, lambda chunk: torch.from_numpy(np.stack(
        [wp.encode(t, t_len) for t in chunk])).to(r.device)


def serve_control(r: core.Run) -> dict:
    ref = core.module("reference", r.cell.family)
    params = weights.make(ref.param_specs(r.cell.model, "final"), r.seed,
                          r.device)
    spec = r.cell.spec
    inputs, batch_of = serve_inputs(r, spec["sample"]["max_rows"])
    bits = r.cell.serve_bits()

    def forward(p, model, chunk, **kw):
        return ref.final(p, model, batch_of(chunk), **kw)

    chunk = spec["sample"]["chunk"]
    want = serving.reference_outputs(r, params, forward, inputs, chunk,
                                     bits=bits)
    if bits is None:   # float32 -> TF32
        got = serving.reference_outputs(r, params, forward, inputs, chunk,
                                        tf32=True)
    else:              # int8 -> int4
        got = serving.reference_outputs(r, params, forward, inputs, chunk,
                                        bits=4)
    readings = serving.compare(got[0].numpy(), got[1].numpy(), *want)
    return {"control": dict(readings, correct=not _fails(
        r.cell.spec["limits"], readings))}


def train_control(r: core.Run) -> dict:
    """The reference steps against the same steps in each control's or
    fault's place: the teacher in int4, the explainer in TF32, half of the
    batch left out of the loss.  Each is read as a run reads the program:
    by `train_steps.compare`, with the reference explainer also following
    it on its own teacher values, and judged by the cell's limits."""
    from benchmark.traffic import train_steps

    mix = r.cell.mix
    ref, srg, exp, null, trainable = train_steps.build(r)
    feed = train_steps.Feed(r, mix["batch"], mix["coalitions"])
    batches = [feed(k) for k in range(mix["checked_steps"])]
    args = (ref, r.cell.model, srg, exp, trainable, null, batches,
            mix["lr"], train_steps.teacher_bits(r.cell),
            train_steps.REFERENCE_CHUNK)
    limits = r.cell.spec["limits"]
    p0 = {k: exp[k] for k in trainable}
    out = {}
    with ref_common.float32_matmuls(False):
        want = ref_train.steps(*args)
        int4 = args[:8] + (4,) + args[9:]
        for name, a, kw in (
                ("int4_teacher", int4, {}),
                ("tf32_explainer", args, dict(
                    explainer_scope=lambda: ref_common.float32_matmuls(True))),
                ("half_batch", args,
                 dict(loss_fn=ref_train.half_batch_loss))):
            got = ref_train.steps(*a, **kw)
            follow = ref_train.steps(*args, teacher=got["teacher"])
            _, diag = train_steps.compare(
                {"losses": got["losses"], "grads": got["grads"], "p0": p0,
                 "p3": got["params"], "teacher": got["teacher"]},
                want, follow, trainable, {})
            readings = diag.pop("readings")
            out[name] = dict(readings, correct=not _fails(limits, readings),
                             diagnostics=diag)
    return out


def _fails(limits: dict, readings: dict) -> bool:
    return any(readings[k] > limits[k] for k in limits)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    cell = core.load_cell(args.workload)
    core.env_for_program(cell)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"[control] {cell.name} on {torch.cuda.get_device_name(dev)}; "
          f"{core.card_line()}", flush=True)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = core.Run(cell, seed, 0.0, False, dev, t0)
        got = train_control(r) if cell.mix["driver"] == "train_steps" \
            else serve_control(r)
        got["seed"] = seed
        rows.append(got)
        print(f"[control] {cell.name} seed {seed}: {json.dumps(got)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": cell.name, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
