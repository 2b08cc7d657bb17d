"""Recipe: LTT BERT (port of `autognothi_tpu/recipes/ltt_bert.py`): the
inits and the four conversions of the training pipeline, the forward
adapters, the data adapters and the freeze rules.

The conversions are the JAX recipe's surgery rules (`utils/surgery.py`) on
flat dicts of numpy arrays: copied parameters are the source's arrays,
`New()` ones come from a fresh init drawn from the caller's generator.
The classifier and the surrogate share one layout; the explainer inherits
the surrogate's trained branch-0 ladder; the final merges three sources,
the explainer's ladder renamed to branch 1 (`:46-134`)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import RECIPE_VERSION
from ..models.ltt_bert import (LttBert, LttBertConfig, init_ltt_bert,
                               ltt_bert_explainer_fwd, ltt_bert_final_fwd,
                               ltt_bert_progressive,
                               ltt_bert_surrogate_coalitions_fwd,
                               ltt_bert_surrogate_fwd, ltt_bert_trainable)
from ..params import to_flat
from ..utils.surgery import New, merge_param_dicts
from . import vanilla_bert as vb
from . import vanilla_vit as vv
from .types import Flat, ModelRecipe, null_values


def n_players(cfg: LttBertConfig) -> int:
    return cfg.max_position_embeddings - 1


# ------------------------------------------------------------ inits


def _init(section: str):
    def init(cfg: LttBertConfig, generator: torch.Generator) -> Flat:
        return to_flat(init_ltt_bert(cfg, section, generator))
    return init


init_surrogate = _init("surrogate")
init_classifier = init_surrogate  # the classifier has the surrogate layout
init_explainer = _init("explainer")
init_final = _init("final")


# ------------------------------------------------------- conversions


def conv_pretrained_classifier(cfg: LttBertConfig, bundle: Dict,
                               generator: torch.Generator) -> Flat:
    """A base classifier bundle -> the classifier: its trunk, pooler and
    head copied, a fresh branch-0 ladder, side pooler and side classifier
    (`:46-60`)."""
    v_classifier = vb.conv_pretrained_classifier(cfg.into(), bundle,
                                                 generator)
    dst = init_classifier(cfg, generator)
    rules = {
        "bert.embeddings.{_}": ...,
        "bert.encoder.layers.{_}": ...,
        "bert_pooler.dense.{wb}": ...,
        "classifier.{wb}": ...,
        New(): "bert.encoder.s_attn_maps.0_{rest}",
        New(): "bert.encoder.s_attn_layers.0_{rest}",
        New(): "bert_s_attn_pooler.dense.{wb}",
        New(): "s_attn_classifier.{wb}",
    }
    return merge_param_dicts((rules, v_classifier), into=dst)


def conv_classifier_surrogate(cfg: LttBertConfig, _misc, classifier: Flat,
                              generator: torch.Generator) -> Flat:
    """Every parameter copied (`:63-72`)."""
    dst = init_surrogate(cfg, generator)
    rules = {
        "bert.{_}": ...,
        "bert_pooler.{_}": ...,
        "classifier.{_}": ...,
        "bert_s_attn_pooler.{_}": ...,
        "s_attn_classifier.{_}": ...,
    }
    return merge_param_dicts((rules, classifier), into=dst)


def conv_surrogate_explainer(cfg: LttBertConfig, _misc, surrogate: Flat,
                             generator: torch.Generator) -> Flat:
    """The trunk and the trained branch-0 ladder copied, the side pooler
    and side classifier dropped, a fresh explainer side layer and head
    (`:75-86`)."""
    dst = init_explainer(cfg, generator)
    rules = {
        "bert.{_}": ...,  # incl. the trained branch-0 ladder
        "bert_pooler.{_}": ...,
        "bert_s_attn_pooler.{_}": None,
        "classifier.{_}": ...,
        "s_attn_classifier.{wb}": None,
        New(): "s_attn_attention_layers.{rest}",
        New(): "s_attn_explainer.{rest}",
    }
    return merge_param_dicts((rules, surrogate), into=dst)


def conv_explainer_final(cfg: LttBertConfig, misc: vb.BertMisc,
                         classifier: Flat, surrogate: Flat, explainer: Flat,
                         generator: torch.Generator,
                         device: torch.device) -> Flat:
    """The final: the classifier's trunk, the surrogate's branch 0 with its
    side pooler and classifier, the explainer's branch 0 as branch 1 with
    its side layer and head, and `surrogate_null`, the surrogate on the
    null ids with every player on (`:89-134`).  The JAX package runs this
    on the host; the port runs the surrogate forward on `device`, the rest
    is surgery on the host."""
    rules_cls = {
        "bert.embeddings.{_}": ...,
        "bert.encoder.layers.{_}": ...,
        "bert_pooler.dense.{wb}": ...,
        "classifier.{wb}": ...,
        "bert.encoder.s_attn_maps.0_{rest}": None,
        "bert.encoder.s_attn_layers.0_{rest}": None,
        "bert_s_attn_pooler.dense.{wb}": None,
        "s_attn_classifier.{wb}": None,
    }
    rules_srg = {
        "bert.embeddings.{_}": None,
        "bert.encoder.layers.{_}": None,
        "bert_pooler.{_}": None,
        "classifier.{_}": None,
        "bert.encoder.s_attn_maps.0_{rest}": ...,
        "bert.encoder.s_attn_layers.0_{rest}": ...,
        "bert_s_attn_pooler.dense.{wb}": ...,
        "s_attn_classifier.{wb}": ...,
    }
    rules_exp = {
        "bert.embeddings.{_}": None,
        "bert.encoder.layers.{_}": None,
        "bert_pooler.{_}": None,
        "classifier.{_}": None,
        "bert.encoder.s_attn_maps.0_{rest}":
            "bert.encoder.s_attn_maps.1_{rest}",
        "bert.encoder.s_attn_layers.0_{rest}":
            "bert.encoder.s_attn_layers.1_{rest}",
        "s_attn_attention_layers.{_}": ...,
        "s_attn_explainer.{_}": ...,
    }
    dst = init_final(cfg, generator)
    return merge_param_dicts(
        (rules_cls, classifier),
        (rules_srg, surrogate),
        (rules_exp, explainer),
        ({"surrogate_null": ...},
         {"surrogate_null": null_values(fw_surrogate, cfg, surrogate,
                                        vb.null_ids(cfg, misc), n_players(cfg),
                                        device)}),
        into=dst,
    )


# -------------------------------------------------- forward adapters


def fw_classifier(cfg: LttBertConfig, model: LttBert, xs: torch.Tensor,
                  mask: torch.Tensor, **kw
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (the side branch-0 probabilities, the trunk probabilities): the
    classifier stage trains on the first, the surrogate's teacher is the
    second (`:137-142`)."""
    srg, cls, _ = ltt_bert_surrogate_fwd(model, cfg,
                                         *vb.fw_xs_preprocess(xs, mask), **kw)
    return srg, cls


def fw_surrogate(cfg: LttBertConfig, model: LttBert, xs: torch.Tensor,
                 mask: torch.Tensor, **kw):
    srg, cls, _ = ltt_bert_surrogate_fwd(model, cfg,
                                         *vb.fw_xs_preprocess(xs, mask), **kw)
    return srg, cls


def fw_explainer(cfg: LttBertConfig, model: LttBert, xs: torch.Tensor,
                 mask: torch.Tensor, grand: torch.Tensor, null: torch.Tensor,
                 **kw):
    attr, cls, _ = ltt_bert_explainer_fwd(
        model, cfg, *vb.fw_xs_preprocess(xs, mask), grand, null, **kw)
    return attr, cls


def fw_final(cfg: LttBertConfig, model: LttBert,
             xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every token on: an all-ones attention mask and zero token types
    (`:161-165`), so the additive bias is zero."""
    mask = torch.ones_like(xs)
    return ltt_bert_final_fwd(model, cfg, xs, mask, torch.zeros_like(xs))


def fw_surrogate_coalitions(cfg: LttBertConfig, model: LttBert,
                            xs: torch.Tensor, masks: torch.Tensor, **kw
                            ) -> torch.Tensor:
    """masks <B, M, T - 1> (no CLS column) -> <B, M, n_classes>: the CLS
    column is prepended here (`:168-173`)."""
    b, m = masks.shape[:2]
    cls_col = torch.ones((b, m, 1), dtype=masks.dtype, device=masks.device)
    return ltt_bert_surrogate_coalitions_fwd(
        model, cfg, xs, torch.cat([cls_col, masks], dim=-1),
        torch.zeros_like(xs), **kw)


def fw_classifier_repr(cfg: LttBertConfig, model: LttBert, xs: torch.Tensor,
                       mask: torch.Tensor, **kw):
    """-> (side probabilities, the trunk's hidden states) (`:176-181`)."""
    srg, _, obs = ltt_bert_surrogate_fwd(model, cfg,
                                         *vb.fw_xs_preprocess(xs, mask), **kw)
    return srg, obs["repr_cls"]


def fw_explainer_repr(cfg: LttBertConfig, model: LttBert, xs: torch.Tensor,
                      mask: torch.Tensor, grand: torch.Tensor,
                      null: torch.Tensor, **kw):
    """-> (attributions, branch 0's side states) (`:184-189`)."""
    attr, _, obs = ltt_bert_explainer_fwd(
        model, cfg, *vb.fw_xs_preprocess(xs, mask), grand, null, **kw)
    return attr, obs["repr_exp"]


def ltt_bert_recipe() -> ModelRecipe:
    return ModelRecipe(
        id="ltt_bert",
        version=RECIPE_VERSION,
        t_config=LttBertConfig,
        n_players=n_players,
        gen_input=vb.gen_input,
        gen_null=vb.null_ids,
        training=vv.TRAINING,
        fw_surrogate=fw_surrogate,
        fw_explainer=fw_explainer,
        fw_final=fw_final,
        fw_surrogate_coalitions=fw_surrogate_coalitions,
        trainable=ltt_bert_trainable,
        progressive_trainable=ltt_bert_progressive,
        load_misc=vb.load_misc,
        init_classifier=init_classifier,
        init_surrogate=init_surrogate,
        init_explainer=init_explainer,
        init_final=init_final,
        conv_pretrained_classifier=conv_pretrained_classifier,
        conv_classifier_surrogate=conv_classifier_surrogate,
        conv_surrogate_explainer=conv_surrogate_explainer,
        conv_explainer_final=conv_explainer_final,
        fw_classifier=fw_classifier,
        measurements=vv.MEASUREMENTS,
        fw_classifier_repr=fw_classifier_repr,
        fw_explainer_repr=fw_explainer_repr,
    )
