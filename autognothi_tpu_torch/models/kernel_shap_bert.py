"""KernelSHAP BERT baseline (port of `autognothi_tpu/models/
kernel_shap_bert.py`): the "explainer" is a stored, k-means-compressed
background token matrix, the integer buffer `Xs_train` <data_size, T>;
the final holds the frozen vanilla BERT classifier under `classifier.`
and that buffer under `explainer.`, and estimates attributions per call
with the WLS KernelSHAP solver (`ops/kernel_shap.py`, in the recipe).

`Xs_train` is int32, as the JAX package holds it (its init writes int32
zeros; its trainer's int64 centres become int32 without x64), so an npz
of either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn

from .bert import BertClassifier, VanillaBertConfig, _flat


@dataclasses.dataclass(frozen=True)
class KernelShapBertConfig(VanillaBertConfig):
    kernel_shap_n_samples: int
    kernel_shap_data_size: int

    def into(self) -> VanillaBertConfig:
        return VanillaBertConfig(**{
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(VanillaBertConfig)})


class KernelShapExplainer(nn.Module):
    """`Xs_train` <kernel_shap_data_size, max_position_embeddings> int32,
    zeros until the trainer stores the centres (`:29-37`)."""

    def __init__(self, cfg: KernelShapBertConfig):
        super().__init__()
        self.register_buffer("Xs_train", torch.zeros(
            (cfg.kernel_shap_data_size, cfg.max_position_embeddings),
            dtype=torch.int32))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.Xs_train.zero_()


class KernelShapFinal(nn.Module):
    """`classifier.*` (the vanilla BERT classifier) and
    `explainer.Xs_train` (`:40-47`)."""

    def __init__(self, cfg: KernelShapBertConfig):
        super().__init__()
        self.classifier = BertClassifier(cfg)
        self.explainer = KernelShapExplainer(cfg)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.classifier.reset_parameters(generator)
        self.explainer.reset_parameters(generator)


SECTIONS = {"classifier": BertClassifier, "surrogate": BertClassifier,
            "explainer": KernelShapExplainer, "final": KernelShapFinal}


def kernel_shap_bert_model(cfg: KernelShapBertConfig,
                           section: str = "final") -> nn.Module:
    """A checkpoint section's module, created empty."""
    if section not in SECTIONS:
        raise ValueError(f"unknown KernelSHAP BERT section {section!r}")
    return SECTIONS[section](cfg)


def init_kernel_shap_explainer(cfg: KernelShapBertConfig,
                               generator: torch.Generator
                               ) -> Dict[str, np.ndarray]:
    """Only the stored background rows, int32 zeros."""
    return _flat(KernelShapExplainer(cfg), generator)


def init_kernel_shap_final(cfg: KernelShapBertConfig,
                           generator: torch.Generator
                           ) -> Dict[str, np.ndarray]:
    return _flat(KernelShapFinal(cfg), generator)
