"""The experiment configuration (`.hparams.json`), parsed with `json` and
dataclasses.  The port reads `seed`, the `net` block, the `dataset` block
and the `train_explainer` section; the rest of the file is kept as a raw
dict for the stages that are not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

PORTED_NET_KINDS = ("ltt_vit", "ltt_bert")


@dataclasses.dataclass(frozen=True)
class Config_Net:
    kind: str
    version: str
    params: Dict[str, Any]
    base_model: str = ""


@dataclasses.dataclass(frozen=True)
class Config_Dataset:
    """`kind` and its fields; only `cv_samples` is loaded by the port
    (train_size, test_size, img_px_size, num_classes, seed = 1234)."""
    kind: str
    fields: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Config_Train:
    epochs: int
    ckpt_when: str  # cadence DSL, e.g. `<=5:%2==0; <=10:%3==0`
    lr: float
    batch_size: int
    EXPERIMENTAL_progressive_training: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class Config_Train_Explainer(Config_Train):
    n_mask_samples: int = 0
    lambda_efficiency: float = 0.0
    lambda_norm: float = 0.0


@dataclasses.dataclass(frozen=True)
class ExpConfig:
    seed: int
    net: Config_Net
    raw: Dict[str, Any]
    dataset: Optional[Config_Dataset] = None
    train_explainer: Optional[Config_Train_Explainer] = None


def _train_explainer(raw: Dict[str, Any]) -> Config_Train_Explainer:
    """Every field is required but the progressive flag; unknown fields
    are ignored, as the JAX package's schema ignores them."""
    for name in ("epochs", "ckpt_when", "lr", "batch_size",
                 "n_mask_samples", "lambda_efficiency", "lambda_norm"):
        if name not in raw:
            raise KeyError(f"train_explainer.{name}")
    known = {f.name for f in dataclasses.fields(Config_Train_Explainer)}
    return Config_Train_Explainer(**{k: v for k, v in raw.items()
                                     if k in known})


def parse_config(raw: Dict[str, Any]) -> ExpConfig:
    """Validate the fields the port reads; raise on a net kind it cannot
    run yet."""
    try:
        net = raw["net"]
        dataset = raw.get("dataset")
        cfg = ExpConfig(
            seed=int(raw["seed"]),
            net=Config_Net(kind=str(net["kind"]), version=str(net["version"]),
                           params=dict(net["params"]),
                           base_model=str(net.get("base_model", ""))),
            raw=raw,
            dataset=None if dataset is None else Config_Dataset(
                kind=str(dataset["kind"]),
                fields={k: v for k, v in dataset.items() if k != "kind"}),
            train_explainer=None if "train_explainer" not in raw
            else _train_explainer(dict(raw["train_explainer"])))
    except (KeyError, TypeError, ValueError) as err:
        raise ValueError(f"malformed .hparams.json: {err!r}") from err
    if cfg.net.kind not in PORTED_NET_KINDS:
        raise NotImplementedError(
            f"net kind {cfg.net.kind!r} is not ported yet (ported: "
            f"{', '.join(PORTED_NET_KINDS)})")
    return cfg
