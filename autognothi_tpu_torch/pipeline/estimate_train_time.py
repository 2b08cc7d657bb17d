"""Training-time estimate from the train-resources report (port of
`autognothi_tpu/pipeline/estimate_train_time.py`).

    python -m autognothi_tpu_torch estimate_train_time <experiment_dir> \\
        --device cuda

The report is read from `<exp>/.reports/train_resources.json` where it is
cached, else measured on `--device` and written there.  The surrogate's
time is its stage's and the classifier's (init time per epoch plus the
surrogate step time per sample, each over its epochs); the explainer's
its own.  The train-set size is the dataset block's `train_size`; a
block without one asks for it on the terminal, as the JAX package does.
"""

from __future__ import annotations

from ..utils.units import Seconds
from .env import ExpEnv
from .measure_all import load_or_run_report
from .measure_train_resources import (MeasureTrainResourcesReport,
                                      measure_train_resources)
from .resources import get_recipe


def fmt_tm(tm: Seconds) -> str:
    mins = int(tm // 60) % 60
    hrs = int(tm / 60 / 60)
    if hrs == 0:
        return f"     {mins:02d}m"
    return f"{hrs: 3d}h {mins:02d}m"


def estimate_train_time(env: ExpEnv, device: str = "cuda") -> None:
    env.log("[[[ retrieving training resource report... ]]]")
    config = env.config
    recipe, _ = get_recipe(config)
    if not recipe.measurements.allow_train_resources:
        env.log("[[[ error: cannot measure training speed ]]]")
        raise ValueError("given model does not support measurement")
    report = load_or_run_report(
        env, MeasureTrainResourcesReport, "train_resources.json",
        lambda: measure_train_resources(env, device=device))

    train_size = int(config.dataset.fields.get("train_size", -1)) \
        if config.dataset is not None else -1
    if train_size < 0:
        train_size = int(input(">>> enter train set size: "))
    tm_surrogate = (
        report.init_tm * config.train_classifier.epochs
        + report.init_tm * config.train_surrogate.epochs
        + report.srg_tm.avg * train_size * config.train_classifier.epochs
        + report.srg_tm.avg * train_size * config.train_surrogate.epochs)
    tm_explainer = (
        report.init_tm * config.train_explainer.epochs
        + report.exp_tm.avg * train_size * config.train_explainer.epochs)

    env.log("[[[ estimated training time ]]]")
    env.log(f"> surrogate: {fmt_tm(tm_surrogate)}")
    env.log(f"> explainer: {fmt_tm(tm_explainer)}")
