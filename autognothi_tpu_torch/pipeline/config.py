"""The experiment configuration (`.hparams.json`), parsed with `json` and
dataclasses.  The port reads `seed`, the `net` block, the `dataset` block,
the three training sections (`train_classifier`, `train_surrogate`,
`train_explainer`, fields and defaults as `autognothi_tpu/pipeline/
config.py:232-246`) and the three optional wandb blocks (`logger_classifier`,
`logger_surrogate`, `logger_explainer`, `:288-325`); the rest of the file
(the eval blocks) is kept as a raw dict for the stages that are not ported
yet."""

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


@dataclasses.dataclass
class Config_Logger:
    """A stage's wandb options; the run id and step are set as it logs."""
    wandb_enabled: bool
    wandb_project: str
    wandb_name: str
    wandb_run_id: Optional[str] = None
    wandb_global_step: Optional[int] = None


LOGGERS = ("logger_classifier", "logger_surrogate", "logger_explainer")


@dataclasses.dataclass(frozen=True)
class ExpConfig:
    seed: int
    net: Config_Net
    raw: Dict[str, Any]
    dataset: Optional[Config_Dataset] = None
    train_classifier: Optional[Config_Train] = None
    train_surrogate: Optional[Config_Train] = None
    train_explainer: Optional[Config_Train_Explainer] = None
    logger_classifier: Optional[Config_Logger] = None
    logger_surrogate: Optional[Config_Logger] = None
    logger_explainer: Optional[Config_Logger] = None


def _section(raw: Dict[str, Any], name: str, cls, required: tuple):
    """Every field of `required` must be there; unknown fields are
    ignored, as the JAX package's schema ignores them."""
    for field in required:
        if field not in raw:
            raise KeyError(f"{name}.{field}")
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in raw.items() if k in known})


# the required fields of each optional block (a training section's are
# all but the progressive flag)
_TRAIN_FIELDS = ("epochs", "ckpt_when", "lr", "batch_size")
_BLOCKS = {
    "train_classifier": (Config_Train, _TRAIN_FIELDS),
    "train_surrogate": (Config_Train, _TRAIN_FIELDS),
    "train_explainer": (Config_Train_Explainer, _TRAIN_FIELDS + (
        "n_mask_samples", "lambda_efficiency", "lambda_norm")),
    **{name: (Config_Logger, ("wandb_enabled", "wandb_project",
                              "wandb_name")) for name in LOGGERS},
}


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
            **{name: None if raw.get(name) is None
               else _section(dict(raw[name]), name, cls, required)
               for name, (cls, required) in _BLOCKS.items()})
    except (KeyError, TypeError, ValueError) as err:
        raise ValueError(f"malformed .hparams.json: {err!r}") from err
    if cfg.net.kind not in PORTED_NET_KINDS:
        raise NotImplementedError(
            f"net kind {cfg.net.kind!r} is not ported yet (ported: "
            f"{', '.join(PORTED_NET_KINDS)})")
    return cfg
