"""Recipe: froyo ViT (port of `autognothi_tpu/recipes/froyo_vit.py`): the
vanilla ViT recipe's stage layouts, conversions and forwards, with the
froyo freeze rules and the single-trunk final."""

from __future__ import annotations

from typing import Tuple

import torch

from .. import RECIPE_VERSION
from ..models.froyo_vit import (FroyoViTConfig, froyo_vit_final_fwd,
                                froyo_vit_trainable, init_froyo_vit_final)
from ..models.vit import init_vit_classifier, init_vit_explainer
from ..utils.surgery import merge_param_dicts
from . import vanilla_vit as vv
from .types import Flat, ModelRecipe, null_values


def conv_explainer_final(cfg: FroyoViTConfig, _misc, classifier: Flat,
                         surrogate: Flat, explainer: Flat,
                         generator: torch.Generator,
                         device: torch.device) -> Flat:
    """The classifier's trunk and head, the surrogate's head as
    `srg_classifier`, the explainer's layers and head, and
    `surrogate_null` (`:33-48`): the three stages share one frozen trunk,
    so the surrogate's and the explainer's copies of it are dropped."""
    dst = init_froyo_vit_final(cfg, generator)
    return merge_param_dicts(
        ({"vit.{_}": ..., "classifier.{_}": ...}, classifier),
        ({"vit.{_}": None, "classifier.{_}": "srg_classifier.{_}"},
         surrogate),
        ({"vit.{_}": None, "explainer_attn.{_}": ...,
          "explainer_mlp.{_}": ...}, explainer),
        ({"surrogate_null": ...},
         {"surrogate_null": null_values(vv.fw_surrogate, cfg, surrogate,
                                        vv._np_null(cfg), vv.n_players(cfg),
                                        device)}),
        into=dst,
    )


def fw_final(cfg: FroyoViTConfig, model,
             xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """All players on: the mask is ones over CLS + every patch."""
    mask = torch.ones((xs.shape[0], 1 + vv.n_players(cfg)),
                      dtype=torch.int32, device=xs.device)
    probs, attr, _ = froyo_vit_final_fwd(model, cfg, xs, mask)
    return probs, attr


def froyo_vit_recipe() -> ModelRecipe:
    return ModelRecipe(
        id="froyo_vit",
        version=RECIPE_VERSION,
        t_config=FroyoViTConfig,
        n_players=vv.n_players,
        gen_input=vv.gen_input,
        gen_null=lambda cfg, misc=None: vv._np_null(cfg),
        training=vv.TRAINING,
        fw_surrogate=vv.fw_surrogate,
        fw_explainer=vv.fw_explainer,
        fw_final=fw_final,
        fw_surrogate_coalitions=vv.fw_surrogate_coalitions,
        trainable=froyo_vit_trainable,
        init_classifier=init_vit_classifier,
        init_surrogate=init_vit_classifier,
        init_explainer=init_vit_explainer,
        init_final=init_froyo_vit_final,
        conv_pretrained_classifier=vv.conv_pretrained_classifier,
        conv_classifier_surrogate=vv.conv_classifier_surrogate,
        conv_surrogate_explainer=vv.conv_surrogate_explainer,
        conv_explainer_final=conv_explainer_final,
        fw_classifier=vv.fw_classifier,
        measurements=vv.MEASUREMENTS,
        fw_classifier_repr=vv.fw_classifier_repr,
        fw_explainer_repr=vv.fw_explainer_repr,
    )
