"""Train resources: seconds and device MiB per training step for the
surrogate and the explainer, and the set-up's cost (port of
`autognothi_tpu/pipeline/measure_train_resources.py`).

    python -m autognothi_tpu_torch measure_train_resources <exp> \\
        --device cuda

Set-up: fresh classifier, surrogate and explainer parameters drawn from a
generator seeded with `derive_seed(seed, "measure_train_resources")`, put
on the device, and their AdamW states.  Then up to `max_samples` training
images at `batch_size`: per batch the teacher's forward (the classifier's
trunk probabilities, or the surrogate's coalition and grand values) and
one train step, timed together between `torch.cuda.synchronize` fences
(host clock), per image; the first batch is run once untimed first.  The
steps draw their masks and dropout from one generator on the device.

Memory on the card is the CUDA allocator's peak during the region above
what was allocated when it began (`mem_estimator`
"cuda_allocator_peak_delta"): the step's transient working set.  On the
CPU there is no device allocator: the memory cells are null, labelled so,
never 0.  (The JAX package's schema types those cells as numbers, so it
refuses such a file; a report from the card loads in both.)

The JAX package's documented deviation from the reference is kept: the
explainer's step uses the explainer's own optimizer, where the reference
reuses the surrogate's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..data.loader import DatasetLoader
from ..ops.shapley import (loss_logits_kl_divergence, loss_shapley,
                           mask_purely_uniform, mask_shapley)
from ..params import from_jax_params
from ..utils.devices import resolve_device
from ..utils.seeding import iterative_generator
from ..utils.units import MiBytes, Seconds
from .env import ExpEnv
from .measure_performance import AllocatorPeak, device_fence
from .resources import get_recipe, load_cfg_dataset
from .training import AdamW, make_train_step, ones_mask


def _std1(values: List[float]) -> float:
    return float(np.std(values, ddof=1)) if len(values) > 1 else 0.0


@dataclasses.dataclass
class SecondsStats:
    all: List[Seconds]
    avg: Seconds
    std: Seconds

    @staticmethod
    def from_list(values: List[Seconds]) -> "SecondsStats":
        avg = float(np.mean(values)) if values else 0.0
        return SecondsStats(all=values, avg=avg, std=_std1(values))


@dataclasses.dataclass
class MiBytesStats:
    all: List[MiBytes]
    avg: MiBytes
    std: MiBytes

    @staticmethod
    def from_list(values: List[MiBytes]) -> "MiBytesStats":
        avg = float(np.mean(values)) if values else 0.0
        return MiBytesStats(all=values, avg=avg, std=_std1(values))


@dataclasses.dataclass
class MeasureTrainResourcesReport:
    init_tm: Seconds
    init_mem: Optional[MiBytes]
    srg_tm: SecondsStats
    srg_mem: Optional[MiBytesStats]
    exp_tm: SecondsStats
    exp_mem: Optional[MiBytesStats]
    # which estimator filled the MiB cells, or why they are null
    mem_estimator: str = "cuda_allocator_peak_delta"


def measure_train_resources(env: ExpEnv,
                            d_loader: Optional[DatasetLoader] = None,
                            device: str = "cuda"
                            ) -> MeasureTrainResourcesReport:
    env.log("loading models...")
    config = env.config
    recipe, m_config = get_recipe(config)
    if recipe.measurements is None or \
            not recipe.measurements.allow_train_resources:
        raise ValueError("unsupported recipe action")
    if config.eval_train_resources is None:
        raise ValueError("the experiment config has no eval_train_resources")
    dev = resolve_device(device)

    m_misc = (recipe.load_misc(env.model_path, m_config)
              if recipe.load_misc else None)
    n_players = recipe.n_players(m_config)
    n_mask_samples = config.train_explainer.n_mask_samples
    gen_input = recipe.gen_input(m_config, m_misc)

    if d_loader is None:
        env.log("loading dataset...")
        # the JAX package reads eval_performance's dataset here too
        d_loader = load_cfg_dataset(
            (config.eval_performance.dataset
             if config.eval_performance is not None else None)
            or config.dataset)

    # ---- set-up: fresh parameters and optimizers
    region = AllocatorPeak(dev, above_start=True)
    region.start()
    t0 = time.perf_counter()
    gen_init = iterative_generator(config.seed, "measure_train_resources")
    cls_model = from_jax_params(recipe.init_classifier(m_config, gen_init),
                                m_config, dev, section="classifier")
    srg_model = from_jax_params(recipe.init_surrogate(m_config, gen_init),
                                m_config, dev, section="surrogate")
    exp_model = from_jax_params(recipe.init_explainer(m_config, gen_init),
                                m_config, dev, section="explainer")
    cls_model.requires_grad_(False)
    opts = {}
    for section, model in (("surrogate", srg_model),
                           ("explainer", exp_model)):
        trainable = recipe.trainable(m_config, section)
        for name, p in model.named_parameters():
            p.requires_grad_(trainable(name))
        opts[section] = AdamW(dict(model.named_parameters()), trainable)
    device_fence(dev)
    init_tm = time.perf_counter() - t0
    init_mem = region.mib()
    env.log(f"init: {init_tm:.6f} s" + (
        f", {init_mem:.2f} MB" if init_mem is not None else ""))

    batch_size = config.eval_train_resources.batch_size
    max_samples = config.eval_train_resources.max_samples
    lr_srg = config.train_surrogate.lr
    lr_exp = config.train_explainer.lr
    gen = iterative_generator(config.seed, "measure_train_resources[steps]",
                              dev)

    def ones(b: int) -> torch.Tensor:
        return torch.ones((b, n_players), dtype=torch.int32, device=dev)

    with torch.no_grad():
        nil_xs = torch.from_numpy(recipe.gen_null(m_config, m_misc)).to(dev)
        surrogate_null, _ = recipe.fw_surrogate(m_config, srg_model, nil_xs,
                                                ones(1))

    # ---- surrogate step
    def srg_loss(model, xs, mask, orig, rng):
        adapt, _ = recipe.fw_surrogate(m_config, model, xs, mask,
                                       deterministic=False, rng=rng)
        return loss_logits_kl_divergence(orig, adapt), None

    srg_step = make_train_step(srg_loss)
    srg_update = ones_mask(dict(srg_model.named_parameters()))

    def teacher(xs):
        # the arithmetic AUTOGNOTHI_INT8 picks, not the production
        # trainer's int8 teacher (AUTOGNOTHI_INT8_TEACHER): the JAX rule
        with torch.no_grad():
            return recipe.fw_classifier(m_config, cls_model, xs,
                                        ones(xs.shape[0]))[1]

    def srg_region(xs, mask_rand):
        orig = teacher(xs)
        srg_step(srg_model, opts["surrogate"], lr_srg, srg_update, xs,
                 mask_rand, orig, gen)

    srg_tms: List[float] = []
    srg_mems: List[float] = []
    seen = 0
    for batch_idx, (_inputs, _targets) in enumerate(
            d_loader.train(batch_size)):
        if seen >= max_samples:
            break
        xs, _zs = gen_input(_inputs, _targets)
        xs = torch.from_numpy(xs).to(dev)
        size = xs.shape[0]
        mask_rand = mask_purely_uniform(gen, size, n_players)
        if batch_idx == 0:  # warm outside the timing
            srg_region(xs, mask_rand)
        region.start()
        t0 = time.perf_counter()
        srg_region(xs, mask_rand)
        device_fence(dev)
        srg_tms.append((time.perf_counter() - t0) / size)
        srg_mems.append(region.mib())
        seen += size
    env.log(f"surrogate: {np.mean(srg_tms):.6f} s/sample over {seen} "
            f"samples")

    # ---- explainer step (its own optimizer; see the module docstring)
    def exp_loss(model, xs, masks_bmp, v_0, v_s, v_1, rng):
        phi, _ = recipe.fw_explainer(m_config, model, xs,
                                     ones(masks_bmp.shape[0]), v_1, v_0,
                                     deterministic=False, rng=rng)
        return loss_shapley(masks_bmp, v_0, v_s, v_1, phi), None

    exp_step = make_train_step(exp_loss)
    exp_update = ones_mask(dict(exp_model.named_parameters()))

    def exp_teacher(xs, masks_bmp):
        b = masks_bmp.shape[0]
        with torch.no_grad():
            if recipe.fw_surrogate_coalitions is not None:
                v_s = recipe.fw_surrogate_coalitions(m_config, srg_model, xs,
                                                     masks_bmp)
                v_s = v_s.reshape(b * n_mask_samples, -1)
            else:
                v_s, _ = recipe.fw_surrogate(
                    m_config, srg_model,
                    xs.repeat_interleave(n_mask_samples, dim=0),
                    masks_bmp.reshape(-1, n_players))
            v_1, _ = recipe.fw_surrogate(m_config, srg_model, xs, ones(b))
        return v_s, v_1

    def exp_region(xs, masks):
        v_s, v_1 = exp_teacher(xs, masks)
        exp_step(exp_model, opts["explainer"], lr_exp, exp_update, xs, masks,
                 surrogate_null, v_s, v_1, gen)

    exp_tms: List[float] = []
    exp_mems: List[float] = []
    seen = 0
    for batch_idx, (_inputs, _targets) in enumerate(
            d_loader.train(batch_size)):
        if seen >= max_samples:
            break
        xs, _zs = gen_input(_inputs, _targets)
        xs = torch.from_numpy(xs).to(dev)
        size = xs.shape[0]
        masks = mask_shapley(gen, size * n_mask_samples, n_players).reshape(
            size, n_mask_samples, n_players)
        if batch_idx == 0:  # warm outside the timing
            exp_region(xs, masks)
        region.start()
        t0 = time.perf_counter()
        exp_region(xs, masks)
        device_fence(dev)
        exp_tms.append((time.perf_counter() - t0) / size)
        exp_mems.append(region.mib())
        seen += size
    env.log(f"explainer: {np.mean(exp_tms):.6f} s/sample over {seen} "
            f"samples")

    on_card = dev.type == "cuda"
    return MeasureTrainResourcesReport(
        init_tm=init_tm,
        init_mem=init_mem,
        srg_tm=SecondsStats.from_list(srg_tms),
        srg_mem=MiBytesStats.from_list(srg_mems) if on_card else None,
        exp_tm=SecondsStats.from_list(exp_tms),
        exp_mem=MiBytesStats.from_list(exp_mems) if on_card else None,
        mem_estimator=region.estimator,
    )
