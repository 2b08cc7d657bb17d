"""Recipe: duo vanilla BERT (port of `autognothi_tpu/recipes/
duo_vanilla_bert.py`): the vanilla BERT's tokenizer, data adapters,
classifier and surrogate stages, the duo explainer and its final, the
forward adapters (`fw_explainer` returns (attributions, raw logits)),
the dual-task gradient probe and the freeze rules of the duo ViT.  The
final carries the surrogate and the explainer only, so `train_all`
checks no coherency (`:75` of the JAX recipe)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import RECIPE_VERSION
from ..models.bert import bert_embeddings, init_bert_classifier
from ..models.duo_bert import (DuoVanillaBertConfig,
                               duo_bert_explainer_from_emb,
                               duo_bert_explainer_fwd, duo_bert_final_fwd,
                               init_duo_bert_explainer, init_duo_bert_final)
from ..utils.surgery import New, merge_param_dicts
from . import duo_vanilla_vit as dv
from . import vanilla_bert as vb
from .types import (Flat, ModelRecipe,
                    ModelRecipe_Measurements_DualTaskSimilarity, null_values)


def conv_surrogate_explainer(cfg: DuoVanillaBertConfig, _misc,
                             surrogate: Flat,
                             generator: torch.Generator) -> Flat:
    """The surrogate's encoder, pooler and head copied, fresh explainer
    layers and head (`:50-59`)."""
    dst = init_duo_bert_explainer(cfg, generator)
    rules = {
        "bert.{_}": ...,
        "bert_pooler.{_}": ...,
        "classifier.{_}": ...,
        New(): "explainer_attn.{rest}",
        New(): "explainer_mlp.{rest}",
    }
    return merge_param_dicts((rules, surrogate), into=dst)


def conv_explainer_final(cfg: DuoVanillaBertConfig, misc: vb.BertMisc,
                         classifier: Flat, surrogate: Flat, explainer: Flat,
                         generator: torch.Generator,
                         device: torch.device) -> Flat:
    """The surrogate and the duo explainer under their prefixes and
    `surrogate_null`; the classifier is not part of it (`:62-75`)."""
    dst = init_duo_bert_final(cfg, generator)
    return merge_param_dicts(
        ({"{_}": "surrogate.{_}"}, surrogate),
        ({"{_}": "explainer.{_}"}, explainer),
        ({"surrogate_null": ...},
         {"surrogate_null": null_values(vb.fw_surrogate, cfg, surrogate,
                                        vb.null_ids(cfg, misc),
                                        vb.n_players(cfg), device)}),
        into=dst,
    )


def fw_explainer(cfg: DuoVanillaBertConfig, model, xs: torch.Tensor,
                 mask: torch.Tensor, grand: torch.Tensor, null: torch.Tensor,
                 **kw):
    """-> (attributions, the explainer's raw logits)."""
    logits, attr, _ = duo_bert_explainer_fwd(
        model, cfg, *vb.fw_xs_preprocess(xs, mask), grand, null, **kw)
    return attr, logits


def fw_final(cfg: DuoVanillaBertConfig, model,
             xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every token on -> (raw logits, attributions) (`:86-90`)."""
    logits, attr, _ = duo_bert_final_fwd(model, cfg, xs, torch.ones_like(xs),
                                         torch.zeros_like(xs))
    return logits, attr


def fw_explainer_repr(cfg: DuoVanillaBertConfig, model, xs: torch.Tensor,
                      mask: torch.Tensor, grand: torch.Tensor,
                      null: torch.Tensor, **kw):
    """-> (attributions, the encoder's hidden states) (`:93-98`)."""
    _, attr, obs = duo_bert_explainer_fwd(
        model, cfg, *vb.fw_xs_preprocess(xs, mask), grand, null, **kw)
    return attr, obs["repr_exp"]


def grad_probe(cfg: DuoVanillaBertConfig, model, xs: torch.Tensor,
               mask: torch.Tensor, grand: torch.Tensor, null: torch.Tensor,
               zs: torch.Tensor, masks_bmp: torch.Tensor, v_0: torch.Tensor,
               v_s: torch.Tensor, v_1: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedding-output gradients <B, T, H> of the cross-entropy on the
    raw logits and of the Shapley loss (`:101-120`)."""
    ids, mask_full, ttype = vb.fw_xs_preprocess(xs, mask)
    with torch.no_grad():
        emb = bert_embeddings(model.bert.embeddings, cfg, ids, ttype)
    return dv.dual_task_grads(
        emb, lambda e: duo_bert_explainer_from_emb(model, cfg, e, mask_full,
                                                   grand, null),
        zs, masks_bmp, v_0, v_s, v_1)


# the duo ViT's measurements with this recipe's probe
MEASUREMENTS = dataclasses.replace(
    dv.MEASUREMENTS,
    allow_dual_task_similarity=ModelRecipe_Measurements_DualTaskSimilarity(
        allow=True, grad_probe=grad_probe))


def duo_vanilla_bert_recipe() -> ModelRecipe:
    return ModelRecipe(
        id="duo_vanilla_bert",
        version=RECIPE_VERSION,
        t_config=DuoVanillaBertConfig,
        n_players=vb.n_players,
        gen_input=vb.gen_input,
        gen_null=vb.null_ids,
        training=dv.TRAINING,
        fw_surrogate=vb.fw_surrogate,
        fw_explainer=fw_explainer,
        fw_final=fw_final,
        fw_surrogate_coalitions=vb.fw_surrogate_coalitions,
        trainable=dv.trainable,
        load_misc=vb.load_misc,
        init_classifier=init_bert_classifier,
        init_surrogate=init_bert_classifier,
        init_explainer=init_duo_bert_explainer,
        init_final=init_duo_bert_final,
        conv_pretrained_classifier=vb.conv_pretrained_classifier,
        conv_classifier_surrogate=vb.conv_classifier_surrogate,
        conv_surrogate_explainer=conv_surrogate_explainer,
        conv_explainer_final=conv_explainer_final,
        fw_classifier=vb.fw_classifier,
        measurements=MEASUREMENTS,
        fw_classifier_repr=vb.fw_classifier_repr,
        fw_explainer_repr=fw_explainer_repr,
    )
