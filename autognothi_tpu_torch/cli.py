"""Command shell of the port: the same verbs and flags as
`autognothi_tpu/cli.py`.  `serve`, the seven `train_all` verbs,
`train_all` itself, the six reports of the LTT ViT recipe, `measure_all`
and `run_all` (`train_all`, then `measure_all`) run; the other verbs are
not ported yet and raise.

    python -m autognothi_tpu_torch serve <experiment_dir> --device cuda \\
        --port 8321 --batch-size 8 --window 0.0
    python -m autognothi_tpu_torch train_all <experiment_dir> --device cuda
    python -m autognothi_tpu_torch run_all <experiment_dir> --device cuda
    python -m autognothi_tpu_torch measure_all <experiment_dir> \\
        --device cuda --no-run-performance
    python -m autognothi_tpu_torch measure_faithfulness <experiment_dir> \\
        --device cuda

The training and report verbs take the LTT ViT (`net.kind` "ltt_vit")
only; another net kind raises at them.  A report verb reads its cached
`<exp>/.reports/<name>.json` where there is one (`--resolution` on
`measure_faithfulness` recomputes and writes nothing, as in the JAX
package).  Every verb runs on `--device`, "cuda" by default, which raises
on a host without a card.  A trainer stopped by SIGTERM at a batch
boundary exits with 75.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional

NOT_PORTED = (
    "preload_all", "pretrain_classifier", "estimate_train_time",
    "measure_dual_task_similarity", "run_image_explanation",
    "run_text_explanation", "export_final", "__show_fridge__",
    "__preview_text_shapley__",
)
# the training pipeline's verbs -> (module, function); the trainers run in
# an env forked with their stage's logger block
TRAINING = {
    "conv_pretrained_classifier": ("train_all", None),
    "train_classifier": ("train_classifier", "logger_classifier"),
    "conv_classifier_surrogate": ("train_all", None),
    "train_surrogate": ("train_surrogate", "logger_surrogate"),
    "conv_surrogate_explainer": ("train_all", None),
    "train_explainer": ("train_explainer", "logger_explainer"),
    "conv_explainer_final": ("train_all", None),
    "train_all": ("train_all", None),
}
# the net kinds the training verbs take (LTT BERT training is not ported)
TRAINING_NET_KINDS = ("ltt_vit",)
# the report verbs -> (module, report class, cached file); `measure_all`
# and `run_all` run them all
REPORTS = {
    "measure_accuracy": ("measure_accuracy", "MeasureAccuracyReport",
                         "accuracy.json"),
    "measure_faithfulness": ("measure_faithfulness",
                             "MeasureFaithfulnessReport", "faithfulness.json"),
    "measure_cls_acc": ("measure_cls_acc", "MeasureClsAccReport",
                        "cls_acc.json"),
    "measure_performance": ("measure_performance",
                            "MeasurePerformanceReport", "performance.json"),
    "measure_train_resources": ("measure_train_resources",
                                "MeasureTrainResourcesReport",
                                "train_resources.json"),
    "measure_branches_cka": ("measure_branches_cka",
                             "MeasureBranchesCkaReport", "branches_cka.json"),
}
MEASURE_ALL_FLAGS = ("accuracy", "faithfulness", "cls_acc", "performance",
                     "train_resources", "branches_cka",
                     "dual_task_similarity")
# the net kinds the report verbs take (the LTT BERT recipe has no
# surrogate forward yet)
REPORT_NET_KINDS = ("ltt_vit",)


def _device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default; raises without a card) or cpu")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="autognothi-tpu-torch",
        description="AutoGnothi on PyTorch + CUDA (port in progress)")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in NOT_PORTED:
        p = sub.add_parser(name, help="not ported yet")
        p.add_argument("rest", nargs=argparse.REMAINDER)

    p = sub.add_parser("serve")
    p.add_argument("model_path", type=pathlib.Path)
    _device(p)
    p.add_argument("--host", default="127.0.0.1", type=str)
    p.add_argument("--port", default=8321, type=int)
    p.add_argument("--batch-size", dest="batch_size", default=8, type=int)
    p.add_argument("--window", dest="window_s", default=0.0, type=float,
                   help="max seconds a partial slab waits to coalesce "
                        "concurrent requests (0 = only natural "
                        "backpressure batching)")
    p.add_argument("--u8-scale", dest="u8_scale", default=1.0 / 255.0,
                   type=float, help="device-side dequant scale for "
                                    "images_u8 payloads")
    p.add_argument("--u8-offset", dest="u8_offset", default=0.0,
                   type=float, help="device-side dequant offset for "
                                    "images_u8 payloads")
    p.add_argument("--artifact", default=None, type=pathlib.Path,
                   help="an export artifact (not ported yet)")

    for name in TRAINING:
        p = sub.add_parser(name)
        p.add_argument("model_path", type=pathlib.Path)
        _device(p)

    for name in REPORTS:
        p = sub.add_parser(name)
        p.add_argument("model_path", type=pathlib.Path)
        _device(p)
        p.add_argument("--dataset", default=None, type=str,
                       help="another dataset kind (not ported yet)")
        if name == "measure_faithfulness":
            p.add_argument("--resolution", default=None, type=int)
    p = sub.add_parser("measure_all")
    p.add_argument("model_path", type=pathlib.Path)
    _device(p)
    for flag in MEASURE_ALL_FLAGS:
        p.add_argument(f"--run-{flag.replace('_', '-')}", dest=f"run_{flag}",
                       default=True, action=argparse.BooleanOptionalAction)
    p = sub.add_parser("run_all")
    p.add_argument("model_path", type=pathlib.Path)
    _device(p)
    return parser


def _train(env, command: str, device: str) -> None:
    import importlib

    from .pipeline.training import INTERRUPT_EXIT_CODE, TrainingInterrupted

    if env.config.net.kind not in TRAINING_NET_KINDS:
        raise NotImplementedError(
            f"{command}: training net kind {env.config.net.kind!r} is not "
            f"ported yet (ported: {', '.join(TRAINING_NET_KINDS)})")
    module, logger = TRAINING[command]
    fn = getattr(importlib.import_module(f".pipeline.{module}", __package__),
                 command)
    try:
        if logger is None:
            fn(env, device)
        else:
            with env.fork(lambda ec: getattr(ec, logger)) as stage_env:
                fn(stage_env, device=device)
    except TrainingInterrupted as err:
        print(f"[[[ interrupted: {err} ]]]", file=sys.stderr)
        raise SystemExit(INTERRUPT_EXIT_CODE) from err


def _measure(env, args) -> None:
    """A report verb, `measure_all` or `run_all`: on `--device`, which is
    checked first, so that a cached report is not read on a host without
    the card asked for either."""
    import importlib

    from .utils.devices import resolve_device

    if env.config.net.kind not in REPORT_NET_KINDS:
        raise NotImplementedError(
            f"{args.command}: the reports of net kind "
            f"{env.config.net.kind!r} are not ported yet (ported: "
            f"{', '.join(REPORT_NET_KINDS)})")
    resolve_device(args.device)
    if args.command in ("measure_all", "run_all"):
        from .pipeline.measure_all import measure_all

        if args.command == "run_all":
            _train(env, "train_all", args.device)
            measure_all(env, device=args.device)
            return
        measure_all(env, device=args.device,
                    **{f"run_{f}": getattr(args, f"run_{f}")
                       for f in MEASURE_ALL_FLAGS})
        return
    if args.dataset is not None:
        raise NotImplementedError(
            f"{args.command} --dataset: loading another dataset kind is not "
            f"ported yet")
    from .pipeline.measure_all import load_or_run_report

    module, cls, filename = REPORTS[args.command]
    mod = importlib.import_module(f".pipeline.{module}", __package__)
    fn = getattr(mod, args.command)
    resolution = getattr(args, "resolution", None)
    if resolution is not None:  # a one-off run: not cached
        fn(env, resolution=resolution, device=args.device)
        return
    load_or_run_report(env, getattr(mod, cls), filename,
                       lambda: fn(env, device=args.device))


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.command in NOT_PORTED:
        raise NotImplementedError(
            f"command {args.command!r} is not ported yet")
    from .pipeline.env import ExpEnv

    env = ExpEnv(args.model_path)
    try:
        if args.command in TRAINING:
            _train(env, args.command, args.device)
            return
        if args.command in REPORTS or args.command in ("measure_all",
                                                       "run_all"):
            _measure(env, args)
            return
        from .pipeline.serve import serve

        serve(env, args.host, args.port, args.batch_size,
              window_s=args.window_s,
              u8_dequant=(args.u8_scale, args.u8_offset),
              artifact=args.artifact, device=args.device)
    finally:
        env.close()


if __name__ == "__main__":
    main()
