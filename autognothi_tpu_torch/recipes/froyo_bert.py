"""Recipe: froyo BERT (port of `autognothi_tpu/recipes/froyo_bert.py`):
the vanilla BERT recipe's tokenizer, stage layouts, conversions and
forwards, with the froyo freeze rules and the single-trunk final."""

from __future__ import annotations

from typing import Tuple

import torch

from .. import RECIPE_VERSION
from ..models.bert import init_bert_classifier, init_bert_explainer
from ..models.froyo_bert import (FroyoBertConfig, froyo_bert_final_fwd,
                                 froyo_bert_trainable, init_froyo_bert_final)
from ..utils.surgery import merge_param_dicts
from . import vanilla_bert as vb
from . import vanilla_vit as vv
from .types import Flat, ModelRecipe, null_values


def conv_explainer_final(cfg: FroyoBertConfig, misc: vb.BertMisc,
                         classifier: Flat, surrogate: Flat, explainer: Flat,
                         generator: torch.Generator,
                         device: torch.device) -> Flat:
    """The classifier's trunk, pooler and head, the surrogate's pooler and
    head as `srg_bert_pooler` and `srg_classifier`, the explainer's layers
    and head, and `surrogate_null` (`:37-56`)."""
    dst = init_froyo_bert_final(cfg, generator)
    return merge_param_dicts(
        ({"bert.{_}": ..., "bert_pooler.{_}": ..., "classifier.{_}": ...},
         classifier),
        ({"bert.{_}": None, "bert_pooler.{_}": "srg_bert_pooler.{_}",
          "classifier.{_}": "srg_classifier.{_}"}, surrogate),
        ({"bert.{_}": None, "explainer_attn.{_}": ...,
          "explainer_mlp.{_}": ...}, explainer),
        ({"surrogate_null": ...},
         {"surrogate_null": null_values(vb.fw_surrogate, cfg, surrogate,
                                        vb.null_ids(cfg, misc),
                                        vb.n_players(cfg), device)}),
        into=dst,
    )


def fw_final(cfg: FroyoBertConfig, model,
             xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every token on: an all-ones attention mask and zero token types."""
    probs, attr, _ = froyo_bert_final_fwd(model, cfg, xs, torch.ones_like(xs),
                                          torch.zeros_like(xs))
    return probs, attr


def froyo_bert_recipe() -> ModelRecipe:
    return ModelRecipe(
        id="froyo_bert",
        version=RECIPE_VERSION,
        t_config=FroyoBertConfig,
        n_players=vb.n_players,
        gen_input=vb.gen_input,
        gen_null=vb.null_ids,
        training=vv.TRAINING,
        fw_surrogate=vb.fw_surrogate,
        fw_explainer=vb.fw_explainer,
        fw_final=fw_final,
        fw_surrogate_coalitions=vb.fw_surrogate_coalitions,
        trainable=froyo_bert_trainable,
        load_misc=vb.load_misc,
        init_classifier=init_bert_classifier,
        init_surrogate=init_bert_classifier,
        init_explainer=init_bert_explainer,
        init_final=init_froyo_bert_final,
        conv_pretrained_classifier=vb.conv_pretrained_classifier,
        conv_classifier_surrogate=vb.conv_classifier_surrogate,
        conv_surrogate_explainer=vb.conv_surrogate_explainer,
        conv_explainer_final=conv_explainer_final,
        fw_classifier=vb.fw_classifier,
        measurements=vv.MEASUREMENTS,
        fw_classifier_repr=vb.fw_classifier_repr,
        fw_explainer_repr=vb.fw_explainer_repr,
    )
