"""Command shell of the port: the same verbs and flags as
`autognothi_tpu/cli.py`; every verb runs.

    python -m autognothi_tpu_torch serve <experiment_dir> --device cuda \\
        --port 8321 --batch-size 8 --window 0.0
    python -m autognothi_tpu_torch train_all <experiment_dir> --device cuda
    python -m autognothi_tpu_torch run_all <experiment_dir> --device cuda
    python -m autognothi_tpu_torch measure_all <experiment_dir> \\
        --device cuda --no-run-performance
    python -m autognothi_tpu_torch measure_faithfulness <experiment_dir> \\
        --device cuda [--dataset KIND]
    python -m autognothi_tpu_torch run_image_explanation <experiment_dir> \\
        --into out.json [--limit N] [--dataset KIND] --device cuda
    python -m autognothi_tpu_torch run_text_explanation <experiment_dir> \\
        --into out.json [--limit N] [--dataset KIND] --device cuda
    python -m autognothi_tpu_torch __preview_text_shapley__ <experiment_dir>
    python -m autognothi_tpu_torch __show_fridge__ <experiment_dir>
    python -m autognothi_tpu_torch estimate_train_time <experiment_dir>
    python -m autognothi_tpu_torch pretrain_classifier <experiment_dir>
    python -m autognothi_tpu_torch preload_all
    python -m autognothi_tpu_torch export_final <experiment_dir> \\
        --into final.agx --batch-size 8 [--kernels --platforms cuda] \\
        --device cuda
    python -m autognothi_tpu_torch serve <experiment_dir> --device cuda \\
        --artifact final.agx

Every verb takes every net kind of the JAX package (`pipeline/
config.py:NET_KINDS`: the LTT, vanilla, froyo and duo towers of both
families and the KernelSHAP BERT), each as far as its recipe allows (the
dual-task report for the duo kinds, only faithfulness for KernelSHAP).  A
report verb reads its cached `<exp>/.reports/<name>.json` where there is
one; `--resolution` on `measure_faithfulness` and `--dataset` (another
dataset kind, at the JAX package's sizes: `resources.load_id_dataset`)
recompute and write nothing, as in the JAX package.  Every verb that
runs a model (all but `preload_all`, which checks the local caches and
downloads nothing) runs on `--device`, "cuda" by default, which raises on
a host without a card.  A trainer stopped by SIGTERM at a batch boundary
exits with 75.

Several devices take one process each, started with AUTOGNOTHI_DIST_COORD=
host:port, AUTOGNOTHI_DIST_NPROCS=N and AUTOGNOTHI_DIST_PROC_ID=i (or
AUTOGNOTHI_DIST_COORD=auto under torchrun): `main` initializes the
process group first (`parallel/distributed.py`; NCCL for cuda, gloo for
cpu), and `--device cuda` is then the rank's own card.  The trainers and
the reports run data-parallel, `serve` answers on rank 0 with each slab
split over the ranks, `export_final --data-parallel N` writes an artifact
that N ranks serve.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional

NOT_PORTED: tuple = ()
# the demos and the other verbs -> (module, takes --dataset)
DEMOS = {
    "run_image_explanation": ("run_image_explanation", True),
    "run_text_explanation": ("run_text_explanation", True),
    "__preview_text_shapley__": ("preview_text_shapley", True),
    "__show_fridge__": ("show_fridge", False),
    "estimate_train_time": ("estimate_train_time", False),
    "pretrain_classifier": ("pretrain_classifier", False),
}
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
    "measure_dual_task_similarity": ("measure_dual_task_similarity",
                                     "MeasureDualTaskSimilarityReport",
                                     "dual_task_similarity.json"),
}
MEASURE_ALL_FLAGS = ("accuracy", "faithfulness", "cls_acc", "performance",
                     "train_resources", "branches_cka",
                     "dual_task_similarity")


def _device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default; raises without a card) or cpu")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="autognothi-tpu-torch",
        description="AutoGnothi on PyTorch + CUDA: train, serve, measure and "
                    "export self-explaining transformers on NVIDIA GPUs")
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
                   help="serve an export_final artifact (program+weights) "
                        "instead of the experiment's checkpoints; a fixed-"
                        "batch artifact dictates the slab size")

    p = sub.add_parser("export_final")
    p.add_argument("model_path", type=pathlib.Path)
    _device(p)
    p.add_argument("--into", type=pathlib.Path, required=True)
    p.add_argument("--batch-size", dest="batch_size", default=8, type=int,
                   help="0 = batch-polymorphic artifact (one program serves "
                        "any batch; plain path only)")
    p.add_argument("--platforms", default="cuda,cpu", type=str,
                   help="comma list of the devices the artifact runs on "
                        "(default: one file serves cuda AND cpu)")
    p.add_argument("--kernels", action="store_true",
                   help="embed the kernel ops (+int8 when AUTOGNOTHI_INT8=1):"
                        " full serving throughput, but the artifact pins to "
                        "--platforms cuda")

    def _positive(v: str) -> int:
        n = int(v)
        if n < 1:
            raise argparse.ArgumentTypeError(
                f"--data-parallel must be >= 1, got {n}")
        return n

    p.add_argument("--data-parallel", dest="data_parallel", default=1,
                   type=_positive,
                   help="a mesh-sharded artifact: N ranks each run "
                        "batch / N rows of every slab")

    for name in TRAINING:
        p = sub.add_parser(name)
        p.add_argument("model_path", type=pathlib.Path)
        _device(p)

    for name in (*REPORTS, *DEMOS):
        p = sub.add_parser(name)
        p.add_argument("model_path", type=pathlib.Path)
        _device(p)
        if name in REPORTS or DEMOS[name][1]:
            p.add_argument("--dataset", default=None, type=str,
                           help="another dataset kind, at the JAX "
                                "package's sizes (not cached)")
        if name == "measure_faithfulness":
            p.add_argument("--resolution", default=None, type=int)
        if name in ("run_image_explanation", "run_text_explanation"):
            p.add_argument("--into", type=pathlib.Path, required=True)
            p.add_argument("--limit", default=None, type=int)
    sub.add_parser("preload_all")
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
    from .pipeline.measure_all import load_or_run_report

    module, cls, filename = REPORTS[args.command]
    mod = importlib.import_module(f".pipeline.{module}", __package__)
    fn = getattr(mod, args.command)
    loader = _override_loader(args, env.config)
    resolution = getattr(args, "resolution", None)
    kw = {} if resolution is None else {"resolution": resolution}
    if loader is not None or kw:  # a one-off run: not cached
        fn(env, loader, device=args.device, **kw)
        return
    load_or_run_report(env, getattr(mod, cls), filename,
                       lambda: fn(env, device=args.device))


def _override_loader(args, config):
    """`--dataset` -> its DatasetLoader, or None (the config's)."""
    if getattr(args, "dataset", None) is None:
        return None
    from .pipeline.resources import load_id_dataset

    return load_id_dataset(args.dataset,
                           config.net.params.get("img_px_size"))


def _demo(env, args) -> None:
    """A demo or one of the other model verbs, on `--device` (checked
    first, before any file is read).  Each verb's function is its
    module's namesake."""
    import importlib

    from .utils.devices import resolve_device

    resolve_device(args.device)
    module, takes_dataset = DEMOS[args.command]
    fn = getattr(importlib.import_module(f".pipeline.{module}", __package__),
                 module)
    pos = (_override_loader(args, env.config),) if takes_dataset else ()
    if hasattr(args, "into"):
        pos += (args.into, args.limit)
    if module == "show_fridge":  # reads checkpoints only
        fn(env)
    elif module == "pretrain_classifier":
        with env.fork(lambda ec: ec.logger_classifier) as stage_env:
            fn(stage_env, device=args.device)
    else:
        fn(env, *pos, device=args.device)


def preload_all() -> None:
    """Check that every dataset and base model the JAX package would fetch
    is in a local cache; the port downloads nothing, so one FileNotFoundError
    names everything that is missing."""
    from .data.loader import preload_all_datasets
    from .zoo.loader import preload_all_params

    missing = []
    for check in (preload_all_datasets, preload_all_params):
        try:
            check()
        except FileNotFoundError as err:
            missing.append(str(err))
    if missing:
        raise FileNotFoundError("\n".join(missing))


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.command in NOT_PORTED:
        raise NotImplementedError(
            f"command {args.command!r} is not ported yet")
    if args.command == "preload_all":
        preload_all()
        return
    import torch.distributed as dist

    from .parallel.distributed import (distributed_env_configured,
                                       maybe_initialize_distributed,
                                       process_info)

    # before any device is chosen: "cuda" is then the rank's own card; a
    # group the caller initialized stays the caller's to destroy
    owned = not dist.is_initialized()
    engaged = maybe_initialize_distributed(device=args.device) and owned
    if distributed_env_configured():
        print(f"[distributed] {process_info()}", file=sys.stderr)
    from .pipeline.env import ExpEnv

    env = ExpEnv(args.model_path)
    try:
        if args.command in DEMOS:
            _demo(env, args)
            return
        if args.command in TRAINING:
            _train(env, args.command, args.device)
            return
        if args.command in REPORTS or args.command in ("measure_all",
                                                       "run_all"):
            _measure(env, args)
            return
        if args.command == "export_final":
            from .pipeline.export import export_final

            export_final(env, args.into, args.batch_size,
                         platforms=[s for s in args.platforms.split(",")
                                    if s],
                         kernels=args.kernels,
                         data_parallel=args.data_parallel,
                         device=args.device)
            return
        from .pipeline.serve import serve

        serve(env, args.host, args.port, args.batch_size,
              window_s=args.window_s,
              u8_dequant=(args.u8_scale, args.u8_offset),
              artifact=args.artifact, device=args.device)
    finally:
        env.close()
        if engaged:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
