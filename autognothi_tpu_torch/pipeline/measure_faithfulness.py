"""Faithfulness report: insertion and deletion AUC of the final model's
explanations (port of `autognothi_tpu/pipeline/measure_faithfulness.py`,
the paper's headline metric).

    python -m autognothi_tpu_torch measure_faithfulness <exp> --device cuda

Per test image (one at a time): the final's attributions <C, P> for every
class; players ranked by attribution, descending (a stable sort, as
`jnp.argsort`, so tied attributions keep their order); at the stops
`np.linspace(0, n_players, min(n_players, resolution), dtype=int64)` the
top-s players flipped from all-off (insertion) or all-on (deletion); every
class x stop coalition evaluated as one batch through the surrogate's
embed-once coalition forward (`surrogate_coalition_values`), and class c's
curve read from class c's probability.  The report keeps every curve
(`data_*`), and the mean and std (ddof 0) per stop over the true classes
and over the others, each with its AUC, the mean of the midpoints of
neighbouring stops (0.0 for a single stop).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.loader import DatasetLoader
from ..parallel.mesh import axis_size, setup_data_parallel, sharded_call
from ..recipes.types import surrogate_coalition_values
from ..utils.devices import resolve_device
from .env import ExpEnv
from .resources import (get_recipe, load_cfg_dataset, load_epoch_model,
                        load_misc)

CurvePoint = Dict[int, Dict[int, float]]  # cls -> stop -> metric


@dataclasses.dataclass
class FaithfulnessCurve:
    auc: float
    avg: Dict[int, float]
    std: Dict[int, float]


@dataclasses.dataclass
class MeasureFaithfulnessReport:
    """Requires: surrogate [-1], final [-1]."""

    insertion: FaithfulnessCurve
    deletion: FaithfulnessCurve
    insertion_non_ok: FaithfulnessCurve
    deletion_non_ok: FaithfulnessCurve
    data_cls: List[int]
    data_ins: List[CurvePoint]
    data_del: List[CurvePoint]


def _auc(curve: Dict[int, float]) -> float:
    vals = np.array(list(curve.values()))
    if len(vals) < 2:  # a single stop: no midpoint to average
        return 0.0
    return float(((vals[1:] + vals[:-1]) / 2).mean())


def _paint_curve(curves: List[Dict[int, float]]) -> FaithfulnessCurve:
    items: Dict[int, List[float]] = {}
    for curve in curves:
        for stop, point in curve.items():
            items.setdefault(stop, []).append(point)
    avg = {stop: float(np.mean(vals)) for stop, vals in items.items()}
    std = {stop: float(np.std(vals)) for stop, vals in items.items()}
    return FaithfulnessCurve(auc=_auc(avg), avg=avg, std=std)


def perturbation_masks(attr: torch.Tensor, stops: torch.Tensor,
                       mask_base: int) -> torch.Tensor:
    """<C, P> attributions + <S> stops -> <C, S, P> int32 masks.

    For each class: rank players by attribution, descending (stable: ties
    keep their player order, as `jnp.argsort`); at stop s the top-s
    players are flipped from `mask_base` (0 = insertion from empty, 1 =
    deletion from full)."""
    order = torch.argsort(-attr, dim=-1, stable=True)  # <C, P> ranking
    position = torch.argsort(order, dim=-1, stable=True)  # player -> rank
    flipped = (position[:, None, :] < stops[None, :, None]).to(torch.int32)
    return flipped ^ int(mask_base)


def measure_faithfulness(env: ExpEnv,
                         d_loader: Optional[DatasetLoader] = None,
                         resolution: Optional[int] = None,
                         device: str = "cuda") -> MeasureFaithfulnessReport:
    env.log("loading final model...")
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.measurements.allow_faithfulness:
        raise ValueError("unsupported recipe action")
    if config.eval_faithfulness is None:
        raise ValueError("the experiment config has no eval_faithfulness")
    dev = resolve_device(device)

    _, srg_model = load_epoch_model(env, recipe, "surrogate", dev)
    _, final_model = load_epoch_model(env, recipe, "final", dev)

    m_misc = load_misc(env, recipe, m_config)
    n_players = recipe.n_players(m_config)
    gen_input = recipe.gen_input(m_config, m_misc)

    if d_loader is None:
        env.log("loading dataset...")
        d_loader = load_cfg_dataset(config.eval_faithfulness.dataset
                                    or config.dataset)
    if resolution is None:
        resolution = config.eval_faithfulness.resolution

    steps = min(n_players, resolution)
    stops_np = np.linspace(0, n_players, steps, dtype=np.int64)
    stops = torch.from_numpy(stops_np).to(dev)

    mesh, place_params, place_batch = setup_data_parallel(dev)
    srg_model = place_params(srg_model)
    final_model = place_params(final_model)
    n_shards = axis_size(mesh, "data") if mesh is not None else 1

    def coalition_values(m, x, f):
        return surrogate_coalition_values(recipe, m_config, m, x, f)

    if mesh is not None:
        # each rank its share of the coalitions, the kernels per rank
        coalition_values = sharded_call(coalition_values, mesh,
                                        in_axes=(None, None, 1), out_axes=0)

    def eval_perturbed(xs: torch.Tensor, attr: torch.Tensor,
                       mask_base: int) -> np.ndarray:
        """xs <1, ...>, attr <C, P> -> <C, S> surrogate value of class c at
        stop s (one coalition batch through the embed-once path, split
        over the data mesh)."""
        n_classes = attr.shape[0]
        masks = perturbation_masks(attr, stops, mask_base)  # <C, S, P>
        total = n_classes * steps
        flat = masks.reshape(1, total, n_players)
        padded = -(-total // n_shards) * n_shards
        if padded != total:
            # edge-pad so the coalitions divide the mesh; the extra rows
            # are recomputed copies, sliced off below
            flat = torch.cat([flat, flat[:, -1:].expand(
                1, padded - total, n_players)], dim=1)
        probs = coalition_values(srg_model, xs, flat)[:total]
        probs = probs.reshape(n_classes, steps, -1)
        cls_idx = torch.arange(n_classes, device=probs.device)
        return probs[cls_idx, :, cls_idx].float().cpu().numpy()  # <C, S>

    env.log("[[[ running measurement... ]]]")
    ok_cls_l: List[int] = []
    ins_curves: List[CurvePoint] = []
    del_curves: List[CurvePoint] = []
    with torch.no_grad():
        for i, (_inputs, _targets) in enumerate(d_loader.test(1)):
            xs, zs = gen_input(_inputs, _targets)
            xs = place_batch(xs[:1])
            ok_cls = int(np.asarray(zs)[0])
            _logits, explanation = recipe.fw_final(m_config, final_model, xs)
            attr = explanation[0]  # <C, P>

            curves = {}
            for direction, mask_base in (("ins", 0), ("del", 1)):
                vals = eval_perturbed(xs, attr, mask_base)
                curves[direction] = {
                    c: {int(stops_np[s]): float(vals[c, s])
                        for s in range(steps)}
                    for c in range(attr.shape[0])
                }
            ok_cls_l.append(ok_cls)
            ins_curves.append(curves["ins"])
            del_curves.append(curves["del"])
            ins_val = [_auc(c) for c in curves["ins"].values()]
            del_val = [_auc(c) for c in curves["del"].values()]
            env.log(f"> sample {i}: ok_cls {ok_cls}, ins^ "
                    f"{ins_val[ok_cls]:.6f}, del^ {del_val[ok_cls]:.6f}")

    cv_ins_ok, cv_del_ok, cv_ins_nok, cv_del_nok = [], [], [], []
    for ok_cls, ins_curve, del_curve in zip(ok_cls_l, ins_curves,
                                            del_curves):
        for cl in ins_curve:
            if cl == ok_cls:
                cv_ins_ok.append(ins_curve[cl])
                cv_del_ok.append(del_curve[cl])
            else:
                cv_ins_nok.append(ins_curve[cl])
                cv_del_nok.append(del_curve[cl])

    st_ins_ok = _paint_curve(cv_ins_ok)
    st_del_ok = _paint_curve(cv_del_ok)
    st_ins_nok = _paint_curve(cv_ins_nok)
    st_del_nok = _paint_curve(cv_del_nok)
    env.log("FINAL RESULTS:\n"
            f"  > insertion: target {st_ins_ok.auc:.6f}, "
            f"non-target {st_ins_nok.auc:.6f}\n"
            f"  > deletion: target {st_del_ok.auc:.6f}, "
            f"non-target {st_del_nok.auc:.6f}")
    return MeasureFaithfulnessReport(
        insertion=st_ins_ok,
        deletion=st_del_ok,
        insertion_non_ok=st_ins_nok,
        deletion_non_ok=st_del_nok,
        data_cls=ok_cls_l,
        data_ins=ins_curves,
        data_del=del_curves,
    )
