"""Every report the recipe allows, each cached as JSON (port of
`autognothi_tpu/pipeline/measure_all.py`).

    python -m autognothi_tpu_torch measure_all <exp> --device cuda \\
        [--no-run-faithfulness ...]

A report is read from `<exp>/.reports/<name>.json` where that file exists
(validated by `reports.load_report`, never recomputed), else computed and
written there.  The order is the JAX package's: accuracy, faithfulness,
cls_acc, performance, train_resources, branches_cka, dual-task similarity.
Dual-task similarity is not ported: it runs for no recipe of the port
(their `allow_dual_task_similarity` is False), and a recipe that allowed it
would raise before anything is measured.
"""

from __future__ import annotations

import json
from typing import Callable, Optional, Type, TypeVar

from .env import ExpEnv
from .measure_accuracy import MeasureAccuracyReport, measure_accuracy
from .measure_branches_cka import (MeasureBranchesCkaReport,
                                   measure_branches_cka)
from .measure_cls_acc import MeasureClsAccReport, measure_cls_acc
from .measure_faithfulness import (MeasureFaithfulnessReport,
                                   measure_faithfulness)
from .measure_performance import (MeasurePerformanceReport,
                                  measure_performance)
from .measure_train_resources import (MeasureTrainResourcesReport,
                                      measure_train_resources)
from .reports import dump_report, load_report
from .resources import get_recipe

TReport = TypeVar("TReport")


def load_or_run_report(env: ExpEnv, t_report: Type[TReport], filename: str,
                       run: Callable[[], TReport]) -> TReport:
    """The cached report if `<exp>/.reports/<filename>` exists, else
    `run()`'s, written there (indented JSON, the JAX package's form)."""
    f_path = env.model_path / ".reports" / filename
    if f_path.exists():
        with open(f_path, "r", encoding="utf-8") as f:
            return load_report(t_report, json.load(f))
    report = run()
    f_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = f_path.with_name(f_path.name + ".tmp")
    tmp.write_text(dump_report(report), "utf-8")
    tmp.replace(f_path)
    return report


def measure_all(env: ExpEnv, run_accuracy: bool = True,
                run_faithfulness: bool = True, run_cls_acc: bool = True,
                run_performance: bool = True,
                run_train_resources: bool = True,
                run_branches_cka: bool = True,
                run_dual_task_similarity: bool = True,
                device: str = "cuda") -> None:
    recipe, _ = get_recipe(env.config)
    meas = recipe.measurements
    if meas is None:
        raise NotImplementedError(
            f"recipe {recipe.id!r} has no measurements in the port yet")
    if meas.allow_dual_task_similarity is not False \
            and run_dual_task_similarity:
        raise NotImplementedError(
            "the dual-task similarity report is not ported yet")

    def run_report(t_report: Type[TReport], filename: str,
                   run: Callable[[], TReport], recipe_allow: bool,
                   cli_allow: bool) -> Optional[TReport]:
        name = filename.split(".")[0]
        if recipe_allow:
            if cli_allow:
                env.log(f"[[[ Measuring: {name} ]]]")
                return load_or_run_report(env, t_report, filename, run)
            env.log(f"[[[ skip: {name} ]]]")
        return None

    run_report(MeasureAccuracyReport, "accuracy.json",
               lambda: measure_accuracy(env, device=device),
               meas.allow_accuracy, run_accuracy)
    run_report(MeasureFaithfulnessReport, "faithfulness.json",
               lambda: measure_faithfulness(env, device=device),
               meas.allow_faithfulness, run_faithfulness)
    run_report(MeasureClsAccReport, "cls_acc.json",
               lambda: measure_cls_acc(env, device=device),
               meas.allow_cls_acc, run_cls_acc)
    run_report(MeasurePerformanceReport, "performance.json",
               lambda: measure_performance(env, device=device),
               (meas.allow_performance_cls or meas.allow_performance_srg_exp
                or meas.allow_performance_fin), run_performance)
    run_report(MeasureTrainResourcesReport, "train_resources.json",
               lambda: measure_train_resources(env, device=device),
               meas.allow_train_resources, run_train_resources)
    run_report(MeasureBranchesCkaReport, "branches_cka.json",
               lambda: measure_branches_cka(env, device=device),
               meas.allow_branches_cka, run_branches_cka)
    if meas.allow_dual_task_similarity is not False:
        env.log("[[[ skip: dual_task_similarity ]]]")
    env.log("[[[ done all measurements ]]]")
