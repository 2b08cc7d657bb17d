"""Inference performance: per-stage latency, GFLOPs and parameter counts
(port of `autognothi_tpu/pipeline/measure_performance.py`).

    python -m autognothi_tpu_torch measure_performance <exp> --device cuda

Four stages at batch 1, each over `eval_performance.loops` passes of the
test set: the classifier's side forward, the surrogate and the explainer
(given the surrogate's values), and the final's explanation forward.  Per
sample, one warm call on a new shape, then the timed call between two
`torch.cuda.synchronize` fences (host clock).  GFLOPs are counted by
`utils/flops.py` on a CPU copy of the same forward (the plain versions of
the kernel ops; the counter cannot see a ctypes launch).  `mem_mib` is the
CUDA allocator's peak over the stage, the stage's model included
(`mem_estimator` "cuda_allocator_peak"); on the CPU there is no device
allocator, and the cell is null with a label that says so, never 0.
With AUTOGNOTHI_PROFILE_DIR set, the final's timed loop runs inside a
`torch.profiler` trace written to `<dir>/fw_final/trace.json`.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..data.loader import DatasetLoader
from ..utils.devices import resolve_device
from ..utils.flops import fn_flops
from ..utils.units import GFLOPS, MParams, Seconds
from .env import ExpEnv
from .resources import get_recipe, load_cfg_dataset, load_epoch_model

MEM_NONE_CPU = "not_measured: the cpu has no device allocator"


@dataclasses.dataclass
class ModelPerformance:
    time: List[Seconds]
    time_avg: Seconds
    time_std: Seconds
    gflops: GFLOPS
    params_all: MParams
    params_trainable: MParams
    # beyond the reference's report: the stage's device memory, labelled
    mem_mib: Optional[float] = None
    mem_estimator: Optional[str] = None


@dataclasses.dataclass
class MeasurePerformanceReport:
    """Requires: classifier [-1], surrogate [-1], explainer [-1], final
    [-1]."""

    classifier: Optional[ModelPerformance]
    surrogate: Optional[ModelPerformance]
    explainer: Optional[ModelPerformance]
    final: Optional[ModelPerformance]


def device_fence(dev: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_call(fn: Callable[[], Any], dev: torch.device) -> float:
    """Seconds of one call, fenced on both sides."""
    device_fence(dev)
    t0 = time.perf_counter_ns()
    fn()
    device_fence(dev)
    return (time.perf_counter_ns() - t0) / 1e9


class AllocatorPeak:
    """The CUDA allocator's peak over a region, in MiB: `start()` resets
    it, `mib()` reads it, whole or (`above_start`) less what was allocated
    when the region began; on the CPU, None, and `estimator` says why."""

    def __init__(self, dev: torch.device, above_start: bool = False):
        self.dev = dev
        self.above_start = above_start
        self.base = 0
        self.estimator = MEM_NONE_CPU if dev.type != "cuda" else (
            "cuda_allocator_peak_delta" if above_start
            else "cuda_allocator_peak")

    def start(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            self.base = (torch.cuda.memory_allocated(self.dev)
                         if self.above_start else 0)
            torch.cuda.reset_peak_memory_stats(self.dev)

    def mib(self) -> Optional[float]:
        if self.dev.type != "cuda":
            return None
        torch.cuda.synchronize(self.dev)
        peak = torch.cuda.max_memory_allocated(self.dev)
        return max(0, peak - self.base) / (1024 * 1024)


class maybe_profile:
    """A `torch.profiler` trace of the region when AUTOGNOTHI_PROFILE_DIR
    is set, written to `<dir>/<tag>/trace.json` (the JAX package writes a
    `jax.profiler` trace to `<dir>/<tag>`)."""

    def __init__(self, tag: str, dev: torch.device):
        self.dir = os.environ.get("AUTOGNOTHI_PROFILE_DIR")
        self.tag = tag
        self.dev = dev
        self.prof = None

    def __enter__(self):
        if self.dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
            out = pathlib.Path(self.dir) / self.tag
            out.mkdir(parents=True, exist_ok=True)
            self.prof.export_chrome_trace(str(out / "trace.json"))


def _count_params(model: torch.nn.Module, trainable: Callable[[str], bool]):
    """(all, trainable) parameters in millions, over the checkpoint's flat
    names (the state dict's keys)."""
    state = model.state_dict()
    p_all = sum(v.numel() for v in state.values())
    p_train = sum(v.numel() for k, v in state.items() if trainable(k))
    return p_all / 1e6, p_train / 1e6


def _stat(times: List[float], gflops: float, params_all: float,
          params_train: float, memory: AllocatorPeak) -> ModelPerformance:
    arr = np.asarray(times)
    std = float(arr.std(ddof=1)) if len(arr) > 1 else 0.0
    return ModelPerformance(
        time=times, time_avg=float(arr.mean()), time_std=std, gflops=gflops,
        params_all=params_all, params_trainable=params_train,
        mem_mib=memory.mib(), mem_estimator=memory.estimator)


def measure_performance(env: ExpEnv,
                        d_loader: Optional[DatasetLoader] = None,
                        device: str = "cuda") -> MeasurePerformanceReport:
    env.log("loading models...")
    config = env.config
    recipe, m_config = get_recipe(config)
    if recipe.measurements is None:
        raise ValueError("unsupported recipe action")
    if config.eval_performance is None:
        raise ValueError("the experiment config has no eval_performance")
    dev = resolve_device(device)
    cpu = torch.device("cpu")

    if d_loader is None:
        env.log("loading dataset...")
        d_loader = load_cfg_dataset(config.eval_performance.dataset
                                    or config.dataset)
    m_misc = (recipe.load_misc(env.model_path, m_config)
              if recipe.load_misc else None)
    n_players = recipe.n_players(m_config)
    gen_input = recipe.gen_input(m_config, m_misc)
    loops = config.eval_performance.loops
    batch_size = 1
    memory = AllocatorPeak(dev)

    def log_results(tag: str, r: ModelPerformance) -> None:
        env.log(f"PERFORMANCE RESULTS for {recipe.id} <{tag}>")
        env.log(f"    params: all {r.params_all:.3f} M, trainable "
                f"{r.params_trainable:.3f} M")
        env.log(f"    flops: {r.gflops:.3f} G")
        env.log(f"    time: mean {r.time_avg * 1e3:.3f} ms, "
                f"std {r.time_std * 1e3:.3f} ms")
        if r.mem_mib is not None:
            env.log(f"    memory: {r.mem_mib:.1f} MiB ({r.mem_estimator})")

    def iterate_samples():
        for _loop in range(loops):
            for _inputs, _targets in d_loader.test(batch_size):
                xs, zs = gen_input(_inputs, _targets)
                yield (torch.from_numpy(xs).to(dev),
                       int(np.asarray(zs).shape[0]))

    def ones(xs: torch.Tensor) -> torch.Tensor:
        return torch.ones((xs.shape[0], n_players), dtype=torch.int32,
                          device=xs.device)

    def load(section: str, on: torch.device) -> torch.nn.Module:
        return load_epoch_model(env, recipe, section, on)[1]

    def gflops(fwd: Callable, sections: tuple, last: torch.Tensor,
               *extra: torch.Tensor) -> float:
        """FLOPs of fwd(*models, xs, *extra) on CPU copies."""
        models = [load(s, cpu) for s in sections]
        return fn_flops(lambda: fwd(*models, last.to(cpu),
                                    *(e.to(cpu) for e in extra))) / 1e9

    results_cls = results_srg = results_exp = results_fin = None
    meas = recipe.measurements

    with torch.no_grad():
        if meas.allow_performance_cls:
            memory.start()
            cls_model = load("classifier", dev)

            def fwd_cls(model, xs, mask):
                return recipe.fw_classifier(m_config, model, xs, mask)[0]

            times, last = [], None
            for xs, size in iterate_samples():
                mask_1 = ones(xs)
                if last is None or last.shape != xs.shape:
                    fwd_cls(cls_model, xs, mask_1)  # warm
                times.append(timed_call(
                    lambda: fwd_cls(cls_model, xs, mask_1), dev) / size)
                last = xs
            results_cls = _stat(
                times, gflops(fwd_cls, ("classifier",), last, ones(last)),
                *_count_params(cls_model, recipe.trainable(m_config,
                                                           "classifier")),
                memory)
            del cls_model
            log_results("cls", results_cls)

        if meas.allow_performance_srg_exp:
            memory.start()
            srg_model = load("surrogate", dev)
            exp_model = load("explainer", dev)
            nil_xs = torch.from_numpy(recipe.gen_null(m_config,
                                                      m_misc)).to(dev)
            surrogate_null, _ = recipe.fw_surrogate(m_config, srg_model,
                                                    nil_xs, ones(nil_xs))

            def fwd_srg(model, xs, mask):
                return recipe.fw_surrogate(m_config, model, xs, mask)[0]

            def fwd_exp(model, xs, mask, grand, null):
                return recipe.fw_explainer(m_config, model, xs, mask, grand,
                                           null)[0]

            t_srg, t_exp, last, grand = [], [], None, None
            for xs, size in iterate_samples():
                mask_1 = ones(xs)
                if last is None or last.shape != xs.shape:
                    g = fwd_srg(srg_model, xs, mask_1)
                    fwd_exp(exp_model, xs, mask_1, g, surrogate_null)
                box = []
                t_srg.append(timed_call(
                    lambda: box.append(fwd_srg(srg_model, xs, mask_1)),
                    dev) / size)
                grand = box[0]
                t_exp.append(timed_call(
                    lambda: fwd_exp(exp_model, xs, mask_1, grand,
                                    surrogate_null), dev) / size)
                last = xs
            results_srg = _stat(
                t_srg, gflops(fwd_srg, ("surrogate",), last, ones(last)),
                *_count_params(srg_model, recipe.trainable(m_config,
                                                           "surrogate")),
                memory)
            results_exp = _stat(
                t_exp, gflops(fwd_exp, ("explainer",), last, ones(last),
                              grand, surrogate_null),
                *_count_params(exp_model, recipe.trainable(m_config,
                                                           "explainer")),
                memory)
            del srg_model, exp_model
            log_results("srg", results_srg)
            log_results("exp", results_exp)

        if meas.allow_performance_fin:
            memory.start()
            fin_model = load("final", dev)

            def fwd_fin(model, xs):
                return recipe.fw_final(m_config, model, xs)

            times, last = [], None
            with maybe_profile("fw_final", dev):
                for xs, size in iterate_samples():
                    if last is None or last.shape != xs.shape:
                        fwd_fin(fin_model, xs)
                    times.append(timed_call(lambda: fwd_fin(fin_model, xs),
                                            dev) / size)
                    last = xs
            results_fin = _stat(
                times, gflops(fwd_fin, ("final",), last),
                *_count_params(fin_model, recipe.trainable(m_config,
                                                           "final")),
                memory)
            del fin_model
            log_results("fin", results_fin)

    return MeasurePerformanceReport(classifier=results_cls,
                                    surrogate=results_srg,
                                    explainer=results_exp, final=results_fin)
