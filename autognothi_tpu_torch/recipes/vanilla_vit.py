"""Recipe: vanilla ViT, the part the LTT ViT recipe builds on (port of
`autognothi_tpu/recipes/vanilla_vit.py:44-86`): a pretrained classifier
bundle -> the classifier layout, from the port's own layout or from the
Hugging Face ViTForImageClassification one (`HF_VIT_RULES`)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models.vit import VanillaViTConfig, init_vit_classifier
from ..utils.surgery import New, merge_param_dicts


# HF transformers ViTForImageClassification layout -> ours
HF_VIT_RULES = {
    "vit.embeddings.cls_token": ...,
    "vit.embeddings.position_embeddings": ...,
    "vit.embeddings.patch_embeddings.projection.{wb}": ...,
    "vit.encoder.layer.{i}.attention.attention.query.{wb}":
        "vit.encoder.layers.{i}.attention.self.query.{wb}",
    "vit.encoder.layer.{i}.attention.attention.key.{wb}":
        "vit.encoder.layers.{i}.attention.self.key.{wb}",
    "vit.encoder.layer.{i}.attention.attention.value.{wb}":
        "vit.encoder.layers.{i}.attention.self.value.{wb}",
    "vit.encoder.layer.{i}.attention.output.dense.{wb}":
        "vit.encoder.layers.{i}.attention.output.dense.{wb}",
    "vit.encoder.layer.{i}.intermediate.dense.{wb}":
        "vit.encoder.layers.{i}.intermediate.dense.{wb}",
    "vit.encoder.layer.{i}.output.dense.{wb}":
        "vit.encoder.layers.{i}.output.dense.{wb}",
    "vit.encoder.layer.{i}.layernorm_before.{wb}":
        "vit.encoder.layers.{i}.layernorm_before.{wb}",
    "vit.encoder.layer.{i}.layernorm_after.{wb}":
        "vit.encoder.layers.{i}.layernorm_after.{wb}",
    "vit.layernorm.{wb}": ...,
}


def conv_pretrained_classifier(cfg: VanillaViTConfig, bundle: Any,
                               generator: torch.Generator
                               ) -> Dict[str, np.ndarray]:
    """`bundle` is a flat name -> np.ndarray dict, either already in the
    classifier layout or an HF ViTForImageClassification state dict; the
    parameters it lacks (an HF head of another width) are drawn from
    `generator`."""
    dst = init_vit_classifier(cfg, generator)
    if "vit.encoder.layers.0.attention.self.query.weight" in bundle:
        return merge_param_dicts(({"{_}": ...}, bundle), into=dst)
    if "vit.encoder.layer.0.attention.attention.query.weight" in bundle:
        rules = dict(HF_VIT_RULES)
        num_labels_match = (
            "classifier.weight" in bundle
            and bundle["classifier.weight"].shape[0] == cfg.num_labels
        )
        if num_labels_match:
            rules["classifier.{wb}"] = ...
        else:
            rules["classifier.{wb}"] = None
            rules[New()] = "classifier.{wb}"
        return merge_param_dicts((rules, bundle), into=dst)
    raise ValueError("unrecognized pretrained ViT bundle layout")
