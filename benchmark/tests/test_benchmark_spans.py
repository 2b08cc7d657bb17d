"""The readers of the program's span log (`spans.py` and the five
`metrics/` readers of the serving front) on a synthetic trace and log, and
what they read when there is nothing to read."""

import sys

import pytest

from benchmark import core, spans
from benchmark.trace import Trace

SPAN_METRICS = ("idle_launching.serve", "idle_waiting.serve",
                "idle_blocked.serve", "slab_issue_ms.serve",
                "caller_ms.serve")
WINDOW = (1_000, 11_000)
# busy 2,000-4,000 and 6,000-7,000: idle 7,000 of 10,000 ns
KERNELS = [("k1", 2_000, 2_000), ("k2", 6_000, 1_000), ("k3", 3_000, 500)]
DISPATCHER = [("batcher.wait", 500, 1_500), ("batcher.pack", 1_500, 1_800),
              ("batcher.run", 1_800, 3_000),
              ("batcher.blocked", 3_000, 4_500),
              ("batcher.wait", 4_500, 5_000), ("batcher.pack", 5_000, 5_200),
              ("batcher.run", 5_200, 6_500),
              ("batcher.blocked", 6_500, 9_000),
              ("batcher.wait", 9_000, 12_000)]
CALLERS = [("serve.payload", 8, 800, 1_200),
           ("serve.payload", 9, 2_000, 2_100),
           ("serve.respond", 8, 5_000, 5_300),
           ("serve.respond", 9, 10_500, 11_500),
           ("serve.payload", 8, 11_200, 11_400)]
LOG = [(n, 7, s, e) for n, s, e in DISPATCHER] + CALLERS
# by hand: idle while waiting 500 + 500 + 2,000; while packing or running
# 300 + 200 + 200 + 800; while blocked 500 + 2,000 (ns)
WANT = {"idle_launching.serve": 15.0, "idle_waiting.serve": 30.0,
        "idle_blocked.serve": 25.0, "slab_issue_ms.serve": 3_000 / 2 / 1e6,
        "caller_ms.serve": (200 + 100 + 300 + 500) / 2 / 1e6}


def _trace(kernels=KERNELS):
    return Trace(WINDOW, list(kernels), [], [("bench.window", *WINDOW, 1)],
                 [])


@pytest.fixture
def program_log(monkeypatch):
    """The program's span log, replaced by a synthetic one."""
    from autognothi_tpu_torch.utils import tracing

    def use(log, dropped=0, dropped_end_ns=None):
        monkeypatch.setattr(tracing, "snapshot", lambda: tracing.Snapshot(
            list(log), dropped, dropped_end_ns))
    return use


def _read(name, trace):
    return core.reader(name).read({"trace": trace})


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_on_a_synthetic_window(program_log, name):
    program_log(LOG)
    assert _read(name, _trace()) == pytest.approx(WANT[name])


def test_the_idle_readings_add_up_to_the_idle_share(program_log):
    program_log(LOG)
    trace = _trace()
    idle = sum(_read(n, trace) for n in SPAN_METRICS if "idle_" in n)
    assert idle == pytest.approx(_read("idle_share.serve", trace))
    # less the idle under no dispatcher span when the loop is not tiled
    program_log([r for r in LOG if r[2] != 9_000])
    idle = sum(_read(n, trace) for n in SPAN_METRICS if "idle_" in n)
    assert idle == pytest.approx(_read("idle_share.serve", trace) - 20.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_none_where_spans_were_dropped_inside_the_window(program_log, name):
    program_log(LOG, dropped=3, dropped_end_ns=1_500)
    assert _read(name, _trace()) is None
    # spans dropped before the window opened leave it whole
    program_log(LOG, dropped=3, dropped_end_ns=900)
    assert _read(name, _trace()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_none_without_device_activity_or_trace(program_log, name):
    program_log(LOG)
    assert _read(name, _trace(kernels=[])) is None
    assert core.reader(name).read({}) is None
    assert core.reader(name).read({"trace": None}) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_none_without_the_programs_log(monkeypatch, program_log, name):
    import autognothi_tpu_torch.utils as utils
    from autognothi_tpu_torch.utils import tracing

    program_log([])
    assert _read(name, _trace()) is None       # no span in the window
    program_log(LOG)
    # a program without the module, as the parent of the span log
    monkeypatch.setitem(sys.modules, "autognothi_tpu_torch.utils.tracing",
                        None)
    monkeypatch.delattr(utils, "tracing")
    assert _read(name, _trace()) is None
    monkeypatch.undo()
    # or with the module and without its log
    monkeypatch.delattr(tracing, "snapshot")
    assert _read(name, _trace()) is None


def test_interval_helpers():
    assert spans.merge([(5, 7), (1, 3), (2, 4), (9, 9)]) == [(1, 4), (5, 7)]
    assert spans.idle_intervals(_trace()) == [(1_000, 2_000), (4_000, 6_000),
                                              (7_000, 11_000)]
    assert spans.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
