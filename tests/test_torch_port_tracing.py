"""The port's span primitive (`autognothi_tpu_torch/utils/tracing.py`) and
the serving front's spans, on the CPU: off, a span only counts; under a
`torch.profiler` session it is logged from every thread, on the profiler's
clock, and is a profiler range on the threads the profiler records; the
batcher's dispatcher spans tile its loop; the service's request and slab
spans nest as documented; `/statz` reports the totals."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from autognothi_tpu_torch.utils import tracing
from tests.test_ltt_e2e import _ltt_vit_hparams

DISPATCHER = ("batcher.wait", "batcher.pack", "batcher.run",
              "batcher.blocked")


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def _profiled(kineto_events, name):
    return [(e.start_ns(), e.start_ns() + e.duration_ns(),
             e.start_thread_id())
            for e in kineto_events if e.name() == name]


def _logged(name, spans=None):
    spans = tracing.snapshot().spans if spans is None else spans
    return [(s, e, tid) for n, tid, s, e in spans if n == name]


def test_off_counts_and_logs_nothing():
    for _ in range(3):
        with tracing.span("t.off"):
            time.sleep(0.001)
    snap = tracing.snapshot()
    assert snap.spans == [] and snap.dropped == 0
    total = tracing.totals()["t.off"]
    assert total["count"] == 3 and 0.003 <= total["seconds"] < 1.0


def test_on_main_thread_is_a_profiler_range_and_logged():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("t.main"):
            time.sleep(0.001)
    ranges = _profiled(prof.profiler.kineto_results.events(), "t.main")
    logged = _logged("t.main")
    assert len(ranges) == 1 and len(logged) == 1
    assert logged[0][2] == threading.get_native_id()
    assert tracing.totals()["t.main"]["count"] == 1
    # an exception passes through and the span still closes
    with pytest.raises(KeyError):
        with tracing.span("t.raises"):
            raise KeyError("x")
    assert tracing.totals()["t.raises"]["count"] == 1


def test_on_a_thread_started_before_the_session_is_logged_only():
    go, done = threading.Event(), threading.Event()

    def other():
        go.wait(30)
        with tracing.span("t.other"):
            time.sleep(0.001)
        done.set()

    thread = threading.Thread(target=other)
    thread.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        go.set()
        assert done.wait(30)
    thread.join(30)
    assert not thread.is_alive()
    assert _profiled(prof.profiler.kineto_results.events(), "t.other") == []
    logged = _logged("t.other")
    assert len(logged) == 1 and logged[0][2] == thread.native_id


def test_a_span_open_when_the_session_starts_is_logged():
    waiting = tracing.span("t.straddle").__enter__()
    with profile(activities=[ProfilerActivity.CPU]):
        waiting.__exit__(None, None, None)
    assert len(_logged("t.straddle")) == 1


def test_spans_are_on_the_profilers_clock():
    """Both nestings, 300 times each: a logged span opened inside a
    profiler range lies inside it, and one around a range holds it."""
    n = 300
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            with record_function("t.range_out"):
                with tracing.span("t.span_in"):
                    pass
            with tracing.span("t.span_out"):
                with record_function("t.range_in"):
                    pass
    events = list(prof.profiler.kineto_results.events())
    for outer, inner in ((_profiled(events, "t.range_out"),
                          _logged("t.span_in")),
                         (_logged("t.span_out"),
                          _profiled(events, "t.range_in"))):
        assert len(outer) == len(inner) == n
        for (os_, oe, _), (is_, ie, _) in zip(sorted(outer), sorted(inner)):
            assert os_ <= is_ <= ie <= oe, (os_, is_, ie, oe)


def test_the_log_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "_REGISTRY", tracing._Registry(4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            with tracing.span(f"t.{i}"):
                pass
    snap = tracing.snapshot()
    assert [s[0] for s in snap.spans] == ["t.2", "t.3", "t.4", "t.5"]
    assert snap.dropped == 2
    assert snap.dropped_end_ns <= snap.spans[0][2]
    assert sum(t["count"] for t in tracing.totals().values()) == 6


def test_dispatcher_spans_tile_its_loop():
    from autognothi_tpu_torch.pipeline.batching import MicroBatcher

    def run_slab(xs):
        time.sleep(0.002)
        return (xs * 2.0,)

    def finalize(outs):
        time.sleep(0.003)
        return tuple(np.asarray(o) for o in outs)

    batcher = MicroBatcher(run_slab, batch_size=4, depth=2,
                           finalize=finalize)

    def client(c):
        rng = np.random.default_rng(c)
        for k in range(8):
            n = int(rng.integers(1, 7)) if c else 1
            out, = batcher.submit(np.full((n, 3), c + k, np.float32))
            assert out.shape == (n, 3)
            np.testing.assert_array_equal(out, 2.0 * (c + k))
            if c == 0:
                time.sleep(0.004)   # an empty queue now and then

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    assert not any(t.is_alive() for t in threads)
    batcher.close()
    spans = tracing.snapshot().spans
    tids = {tid for name, tid, _, _ in spans if name in DISPATCHER}
    assert tids == {batcher._thread.native_id}
    fetch = {tid for name, tid, _, _ in spans
             if name in ("batcher.fetch", "batcher.settle")}
    assert fetch == {batcher._completer.native_id}
    runs = _logged("batcher.run", spans)
    assert len(runs) >= 10
    t0, t1 = min(s for s, _, _ in runs), max(e for _, e, _ in runs)
    tiles = sorted((s, e) for name, _, s, e in spans
                   if name in DISPATCHER and e > t0 and s < t1)
    for (_, e), (s, _) in zip(tiles, tiles[1:]):
        assert e <= s                              # no overlap
    covered = sum(min(e, t1) - max(s, t0) for s, e in tiles)
    assert covered >= 0.95 * (t1 - t0), covered / (t1 - t0)
    assert len(_logged("batcher.pack", spans)) == len(runs)
    assert len(_logged("batcher.blocked", spans)) == len(runs)
    assert len(_logged("batcher.fetch", spans)) == len(runs)


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    from autognothi_tpu_torch.params import save_params
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import ExplainService
    from autognothi_tpu_torch.recipes.ltt_vit import ltt_vit_recipe

    exp = tmp_path_factory.mktemp("tracing") / "ltt_vit"
    exp.mkdir()
    hp = _ltt_vit_hparams()
    (exp / ".hparams.json").write_text(json.dumps(hp))
    recipe = ltt_vit_recipe()
    flat = recipe.init_final(recipe.t_config(**hp["net"]["params"]),
                             torch.Generator().manual_seed(0))
    save_params(exp / "final-epoch-0.ckpt", flat)
    env = ExpEnv(exp)
    service = ExplainService(env, batch_size=2, device="cpu")
    service.warmup()
    yield service
    service.close()
    env.close()


def test_service_spans_per_request_and_per_slab(service):
    rng = np.random.default_rng(1)
    sizes = [1, 3, 2, 1, 4]
    payloads = [{"images_u8": rng.integers(0, 256, (n, 3, 16, 16)).tolist()}
                for n in sizes]
    payloads[1] = {"images": rng.random((3, 3, 16, 16)).tolist()}
    answers = []
    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(
            target=lambda p=p: answers.append(service.explain(p)))
            for p in payloads]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert sorted(len(a["logits"]) for a in answers) == sorted(sizes)
    spans = tracing.snapshot().spans
    for name in ("serve.payload", "serve.respond"):
        got = _logged(name, spans)
        assert len(got) == len(payloads), name
        assert {tid for _, _, tid in got} == {t.native_id for t in threads}
    runs = _logged("batcher.run", spans)
    assert len(runs) >= -(-sum(sizes) // 2)
    for name in ("serve.h2d", "serve.forward"):
        inner = _logged(name, spans)
        assert len(inner) == len(runs), name
        for (rs, re_, rt), (s, e, t) in zip(sorted(runs), sorted(inner)):
            assert rs <= s <= e <= re_ and rt == t, name


def test_statz_reports_the_span_totals(service):
    from autognothi_tpu_torch.pipeline.serve import make_server

    service.explain({"images_u8": np.zeros((3, 3, 16, 16), int).tolist()})
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = server.server_address
        with urllib.request.urlopen(f"http://{host}:{port}/statz",
                                    timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
    spans = stats["spans"]
    for name in ("serve.payload", "serve.respond", "batcher.wait",
                 "batcher.pack", "batcher.run", "batcher.blocked",
                 "batcher.fetch", "batcher.settle", "serve.h2d",
                 "serve.forward"):
        assert spans[name]["count"] >= 1, name
        assert spans[name]["seconds"] >= 0.0, name
    assert spans["serve.payload"]["count"] == 1
    assert spans["batcher.run"]["count"] == 2
    assert stats["slabs"] >= 2 and stats["batch_size"] == 2


def test_the_train_step_spans_go_through_the_one_primitive(monkeypatch):
    """What `chip_smoke.SpanTimer` relies on: patching `tracing.span`
    catches the trainers' spans, in order, under their names."""
    from autognothi_tpu_torch.pipeline.training import AdamW, make_train_step

    seen = []
    real = tracing.span

    def spy(name):
        seen.append(name)
        return real(name)

    monkeypatch.setattr(tracing, "span", spy)
    model = torch.nn.Linear(3, 2)
    params = dict(model.named_parameters())
    opt = AdamW(params, lambda k: True)
    step = make_train_step(lambda m, x: (m(x).square().mean(), ()))
    step(model, opt, 1e-3, {k: 1.0 for k in params}, torch.ones(4, 3))
    assert seen == ["forward", "backward", "adamw"]
    assert {"forward", "backward", "adamw"} <= set(tracing.totals())
