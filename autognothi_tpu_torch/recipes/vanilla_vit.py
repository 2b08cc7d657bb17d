"""Recipe: vanilla ViT (port of `autognothi_tpu/recipes/vanilla_vit.py`):
the inits, the four conversions of the training pipeline (a pretrained
classifier bundle, from the port's own layout or from the Hugging Face
ViTForImageClassification one, `HF_VIT_RULES`), the forward adapters and
their representation observers, the data adapters and the freeze rules
(the classifier trains nothing; in the final, everything but the
classifier tower trains).  The LTT ViT and froyo ViT recipes build on it.
JAX's `id="vanilla_vit"` is kept."""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .. import RECIPE_VERSION
from ..models.vit import (VanillaViTConfig, init_vit_classifier,
                          init_vit_explainer, init_vit_final,
                          vit_classifier_fwd, vit_explainer_fwd,
                          vit_final_fwd, vit_surrogate_coalitions_fwd,
                          vit_surrogate_fwd)
from ..utils.surgery import New, merge_param_dicts
from .types import (Flat, ModelRecipe, ModelRecipe_Measurements,
                    ModelRecipe_Training, null_values)


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


def n_players(cfg: VanillaViTConfig) -> int:
    return (cfg.img_px_size // cfg.img_patch_size) ** 2


def conv_classifier_surrogate(cfg: VanillaViTConfig, _misc, classifier: Flat,
                              generator: torch.Generator) -> Flat:
    """Every parameter copied: the surrogate starts as the classifier
    (`:89-95`)."""
    dst = init_vit_classifier(cfg, generator)
    rules = {"vit.{_}": ..., "classifier.{_}": ...}
    return merge_param_dicts((rules, classifier), into=dst)


def conv_surrogate_explainer(cfg: VanillaViTConfig, _misc, surrogate: Flat,
                             generator: torch.Generator) -> Flat:
    """The surrogate's backbone copied, its head dropped, fresh explainer
    layers and head (`:98-106`)."""
    dst = init_vit_explainer(cfg, generator)
    rules = {
        "vit.{_}": ...,
        "classifier.{_}": None,
        New(): "explainer_attn.{rest}",
        New(): "explainer_mlp.{rest}",
    }
    return merge_param_dicts((rules, surrogate), into=dst)


def _np_null(cfg: VanillaViTConfig) -> np.ndarray:
    """The null input: a black image <1, C, H, W> (`:109-112`)."""
    return np.zeros((1, cfg.img_channels, cfg.img_px_size, cfg.img_px_size),
                    dtype=np.float32)


def fw_xs_preprocess(xs: torch.Tensor, mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prepend the always-on CLS column to the player mask (`:115-119`)."""
    cls_col = torch.ones((mask.shape[0], 1), dtype=mask.dtype,
                         device=mask.device)
    return xs, torch.cat([cls_col, mask], dim=1)


def fw_classifier(cfg: VanillaViTConfig, model, xs: torch.Tensor,
                  mask: torch.Tensor, **kw):
    """-> (probabilities, probabilities): the classifier is its own
    teacher (`:122-125`)."""
    probs, _ = vit_classifier_fwd(model, cfg, *fw_xs_preprocess(xs, mask),
                                  **kw)
    return probs, probs


def fw_surrogate(cfg: VanillaViTConfig, model, xs: torch.Tensor,
                 mask: torch.Tensor, **kw):
    probs, _ = vit_surrogate_fwd(model, cfg, *fw_xs_preprocess(xs, mask),
                                 **kw)
    return probs, None


def fw_explainer(cfg: VanillaViTConfig, model, xs: torch.Tensor,
                 mask: torch.Tensor, grand: torch.Tensor, null: torch.Tensor,
                 **kw):
    attr, _ = vit_explainer_fwd(model, cfg, *fw_xs_preprocess(xs, mask),
                                grand, null, **kw)
    return attr, None


def fw_final(cfg: VanillaViTConfig, model,
             xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """All players on: the mask is ones over CLS + every patch."""
    mask = torch.ones((xs.shape[0], 1 + n_players(cfg)), dtype=torch.int32,
                      device=xs.device)
    probs, attr, _ = vit_final_fwd(model, cfg, xs, mask)
    return probs, attr


def fw_classifier_repr(cfg: VanillaViTConfig, model, xs: torch.Tensor,
                       mask: torch.Tensor, **kw):
    """-> (probabilities, the backbone's hidden states) (`:147-150`)."""
    probs, obs = vit_classifier_fwd(model, cfg, *fw_xs_preprocess(xs, mask),
                                    **kw)
    return probs, obs["repr_cls"]


def fw_explainer_repr(cfg: VanillaViTConfig, model, xs: torch.Tensor,
                      mask: torch.Tensor, grand: torch.Tensor,
                      null: torch.Tensor, **kw):
    """-> (attributions, the backbone's hidden states) (`:153-156`)."""
    attr, obs = vit_explainer_fwd(model, cfg, *fw_xs_preprocess(xs, mask),
                                  grand, null, **kw)
    return attr, obs["repr_exp"]


def fw_surrogate_coalitions(cfg: VanillaViTConfig, model, xs: torch.Tensor,
                            masks: torch.Tensor, **kw) -> torch.Tensor:
    """masks <B, M, n_players> (no CLS column) -> <B, M, n_classes>."""
    b, m = masks.shape[:2]
    cls_col = torch.ones((b, m, 1), dtype=masks.dtype, device=masks.device)
    return vit_surrogate_coalitions_fwd(
        model, cfg, xs, torch.cat([cls_col, masks], dim=-1), **kw)


def conv_explainer_final(cfg: VanillaViTConfig, _misc, classifier: Flat,
                         surrogate: Flat, explainer: Flat,
                         generator: torch.Generator,
                         device: torch.device) -> Flat:
    """The three towers under their prefixes and `surrogate_null`
    (`:167-181`)."""
    dst = init_vit_final(cfg, generator)
    return merge_param_dicts(
        ({"{_}": "classifier.{_}"}, classifier),
        ({"{_}": "surrogate.{_}"}, surrogate),
        ({"{_}": "explainer.{_}"}, explainer),
        ({"surrogate_null": ...},
         {"surrogate_null": null_values(fw_surrogate, cfg, surrogate,
                                        _np_null(cfg), n_players(cfg),
                                        device)}),
        into=dst,
    )


def gen_input(cfg: VanillaViTConfig, misc=None):
    def collate(raw_xs, raw_ys) -> Tuple[np.ndarray, np.ndarray]:
        xs = np.stack([np.asarray(x, dtype=np.float32) for x in raw_xs])
        return xs, np.asarray(raw_ys, dtype=np.int64)

    return collate


def trainable(cfg: VanillaViTConfig, section: str) -> Callable[[str], bool]:
    """The black-box classifier is frozen; in the final only the
    classifier tower is (`:193-200`)."""
    if section == "classifier":
        return lambda name: False
    if section == "final":
        return lambda name: not name.startswith("classifier.")
    return lambda name: True


MEASUREMENTS = ModelRecipe_Measurements(
    verify_final_coherency=True,
    allow_accuracy=True,
    allow_faithfulness=True,
    allow_cls_acc=True,
    allow_performance_cls=True,
    allow_performance_srg_exp=True,
    allow_performance_fin=True,
    allow_train_resources=True,
    allow_dual_task_similarity=False,
    allow_branches_cka=True,
)
TRAINING = ModelRecipe_Training(
    support_classifier=True, support_surrogate=True, support_explainer=True,
    exp_variant_duo=False, exp_variant_kernel_shap=False)


def vanilla_vit_recipe() -> ModelRecipe:
    return ModelRecipe(
        id="vanilla_vit",
        version=RECIPE_VERSION,
        t_config=VanillaViTConfig,
        n_players=n_players,
        gen_input=gen_input,
        gen_null=lambda cfg, misc=None: _np_null(cfg),
        training=TRAINING,
        fw_surrogate=fw_surrogate,
        fw_explainer=fw_explainer,
        fw_final=fw_final,
        fw_surrogate_coalitions=fw_surrogate_coalitions,
        trainable=trainable,
        init_classifier=init_vit_classifier,
        init_surrogate=init_vit_classifier,
        init_explainer=init_vit_explainer,
        init_final=init_vit_final,
        conv_pretrained_classifier=conv_pretrained_classifier,
        conv_classifier_surrogate=conv_classifier_surrogate,
        conv_surrogate_explainer=conv_surrogate_explainer,
        conv_explainer_final=conv_explainer_final,
        fw_classifier=fw_classifier,
        measurements=MEASUREMENTS,
        fw_classifier_repr=fw_classifier_repr,
        fw_explainer_repr=fw_explainer_repr,
    )
