"""Command shell of the port: the same verbs and flags as
`autognothi_tpu/cli.py`.  `serve` and `train_explainer` run; the other
verbs are not ported yet and raise.

    python -m autognothi_tpu_torch serve <experiment_dir> --device cuda \\
        --port 8321 --batch-size 8 --window 0.0
    python -m autognothi_tpu_torch train_explainer <experiment_dir> \\
        --device cuda

A trainer stopped by SIGTERM at a batch boundary exits with 75.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional

NOT_PORTED = (
    "preload_all", "pretrain_classifier", "estimate_train_time",
    "conv_pretrained_classifier", "train_classifier",
    "conv_classifier_surrogate", "train_surrogate",
    "conv_surrogate_explainer", "conv_explainer_final",
    "train_all", "measure_accuracy", "measure_faithfulness",
    "measure_cls_acc", "measure_performance", "measure_train_resources",
    "measure_branches_cka", "measure_dual_task_similarity", "measure_all",
    "run_all", "run_image_explanation", "run_text_explanation",
    "export_final",
)


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
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default; raises without a card) or cpu")
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

    p = sub.add_parser("train_explainer")
    p.add_argument("model_path", type=pathlib.Path)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default; raises without a card) or cpu")
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.command not in ("serve", "train_explainer"):
        raise NotImplementedError(
            f"command {args.command!r} is not ported yet")
    from .pipeline.env import ExpEnv
    from .pipeline.training import INTERRUPT_EXIT_CODE, TrainingInterrupted

    with ExpEnv(args.model_path) as env:
        if args.command == "train_explainer":
            from .pipeline.train_explainer import train_explainer

            try:
                train_explainer(env, device=args.device)
            except TrainingInterrupted as err:
                print(f"[[[ interrupted: {err} ]]]", file=sys.stderr)
                raise SystemExit(INTERRUPT_EXIT_CODE) from err
            return
        from .pipeline.serve import serve

        serve(env, args.host, args.port, args.batch_size,
              window_s=args.window_s,
              u8_dequant=(args.u8_scale, args.u8_offset),
              artifact=args.artifact, device=args.device)


if __name__ == "__main__":
    main()
