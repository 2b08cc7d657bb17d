"""The experiment configuration (`.hparams.json`), parsed with `json` and
dataclasses.  The port reads `seed`, the `net` block, the `dataset` block,
the three training sections (`train_classifier`, `train_surrogate`,
`train_explainer`, fields and defaults as `autognothi_tpu/pipeline/
config.py:232-246`), the three optional wandb blocks (`logger_classifier`,
`logger_surrogate`, `logger_explainer`, `:288-325`) and the seven eval
blocks of the reports (`eval_accuracy` ... `eval_dual_task_similarity`,
`:249-285`: every field required, `dataset` may be null).  Each block is
None where the file has none; a stage that needs it raises."""

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
class Config_Eval_Accuracy:
    dataset: Optional[Config_Dataset]
    batch_size: int
    resolution: int


@dataclasses.dataclass(frozen=True)
class Config_Eval_Faithfulness:
    dataset: Optional[Config_Dataset]
    batch_size: int
    resolution: int


@dataclasses.dataclass(frozen=True)
class Config_Eval_ClsAcc:
    dataset: Optional[Config_Dataset]
    on_exp_epochs: Optional[str]
    batch_size: int


@dataclasses.dataclass(frozen=True)
class Config_Eval_Performance:
    dataset: Optional[Config_Dataset]
    loops: int


@dataclasses.dataclass(frozen=True)
class Config_Eval_TrainResources:
    dataset: Optional[Config_Dataset]
    batch_size: int
    max_samples: int


@dataclasses.dataclass(frozen=True)
class Config_Eval_BranchesCka:
    dataset: Optional[Config_Dataset]
    batch_size: int


@dataclasses.dataclass(frozen=True)
class Config_Eval_DualTaskSimilarity:
    dataset: Optional[Config_Dataset]
    batch_size: int


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
    eval_accuracy: Optional[Config_Eval_Accuracy] = None
    eval_faithfulness: Optional[Config_Eval_Faithfulness] = None
    eval_cls_acc: Optional[Config_Eval_ClsAcc] = None
    eval_performance: Optional[Config_Eval_Performance] = None
    eval_train_resources: Optional[Config_Eval_TrainResources] = None
    eval_branches_cka: Optional[Config_Eval_BranchesCka] = None
    eval_dual_task_similarity: Optional[Config_Eval_DualTaskSimilarity] = None


def _dataset(raw: Optional[Dict[str, Any]]) -> Optional[Config_Dataset]:
    if raw is None:
        return None
    return Config_Dataset(kind=str(raw["kind"]),
                          fields={k: v for k, v in raw.items() if k != "kind"})


def _section(raw: Dict[str, Any], name: str, cls, required: tuple):
    """Every field of `required` must be there; unknown fields are
    ignored, as the JAX package's schema ignores them."""
    for field in required:
        if field not in raw:
            raise KeyError(f"{name}.{field}")
    known = {f.name for f in dataclasses.fields(cls)}
    if "dataset" in known:  # the eval blocks' own dataset, or null
        raw = dict(raw, dataset=_dataset(raw["dataset"]))
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
    **{name: (cls, tuple(f.name for f in dataclasses.fields(cls)))
       for name, cls in (
           ("eval_accuracy", Config_Eval_Accuracy),
           ("eval_faithfulness", Config_Eval_Faithfulness),
           ("eval_cls_acc", Config_Eval_ClsAcc),
           ("eval_performance", Config_Eval_Performance),
           ("eval_train_resources", Config_Eval_TrainResources),
           ("eval_branches_cka", Config_Eval_BranchesCka),
           ("eval_dual_task_similarity", Config_Eval_DualTaskSimilarity))},
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
            dataset=_dataset(dataset),
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
