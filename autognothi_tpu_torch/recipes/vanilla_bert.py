"""Recipe: vanilla BERT (port of `autognothi_tpu/recipes/vanilla_bert.py`):
the tokenizer `misc` and the data adapters (`null_ids`, `gen_input`,
`fw_xs_preprocess`), the inits and the four conversions (a pretrained
classifier bundle from the port's own layout or from Hugging Face's
BertForSequenceClassification or bare BertModel layouts, `:50-108`), the
forward adapters and their representation observers, and the freeze
rules (the classifier trains nothing; in the final, everything but the
classifier tower trains).  The LTT BERT and froyo BERT recipes build on
it."""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from .. import RECIPE_VERSION
from ..data.tokenizer import encode_batch, load_tokenizer
from ..models.bert import (VanillaBertConfig, bert_classifier_fwd,
                           bert_explainer_fwd, bert_final_fwd,
                           bert_surrogate_coalitions_fwd, bert_surrogate_fwd,
                           init_bert_classifier, init_bert_explainer,
                           init_bert_final)
from ..utils.surgery import New, merge_param_dicts
from .types import Flat, ModelRecipe, null_values
from .vanilla_vit import MEASUREMENTS, TRAINING


@dataclasses.dataclass
class BertMisc:
    tokenizer: Any


def load_misc(m_path: pathlib.Path, cfg: Any) -> BertMisc:
    """The experiment's WordPiece vocabulary, `<exp>/tokenizer/vocab.txt`."""
    return BertMisc(tokenizer=load_tokenizer(pathlib.Path(m_path)
                                             / "tokenizer"))


def null_ids(cfg: Any, misc: BertMisc) -> np.ndarray:
    """Token ids of the empty string, padded to the model's length: <1, T>
    (`:132-135`)."""
    return encode_batch(misc.tokenizer, [""], cfg.max_position_embeddings)


def gen_input(cfg: Any, misc: BertMisc):
    """-> collate(raw_xs, raw_ys): texts -> int64 ids <B, T>, labels
    (`:210-216`)."""
    def collate(raw_xs, raw_ys) -> Tuple[np.ndarray, np.ndarray]:
        ids = encode_batch(misc.tokenizer, list(raw_xs),
                           cfg.max_position_embeddings)
        return ids, np.asarray(raw_ys, dtype=np.int64)

    return collate


def fw_xs_preprocess(xs: torch.Tensor, mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ids, a <B, T - 1> player mask -> (ids, the attention mask with the
    always-on CLS column prepended <B, T>, zero token types) (`:138-144`)."""
    cls_col = torch.ones((mask.shape[0], 1), dtype=mask.dtype,
                         device=mask.device)
    return xs, torch.cat([cls_col, mask], dim=1), torch.zeros_like(xs)


# HF BertForSequenceClassification layout -> ours
HF_BERT_SEQCLS_RULES = {
    "bert.embeddings.word_embeddings.weight": ...,
    "bert.embeddings.position_embeddings.weight": ...,
    "bert.embeddings.token_type_embeddings.weight": ...,
    "bert.embeddings.LayerNorm.{wb}": ...,
    "bert.encoder.layer.{i}.attention.self.{qkv}.{wb}":
        "bert.encoder.layers.{i}.attention.self.{qkv}.{wb}",
    "bert.encoder.layer.{i}.attention.output.{mod}.{wb}":
        "bert.encoder.layers.{i}.attention.output.{mod}.{wb}",
    "bert.encoder.layer.{i}.intermediate.dense.{wb}":
        "bert.encoder.layers.{i}.intermediate.dense.{wb}",
    "bert.encoder.layer.{i}.output.{mod}.{wb}":
        "bert.encoder.layers.{i}.output.{mod}.{wb}",
    "bert.pooler.dense.{wb}": "bert_pooler.dense.{wb}",
    "classifier.{wb}": ...,
}

# bare HF BertModel layout -> ours (the classifier head drawn anew)
HF_BERT_BARE_RULES = {
    "embeddings.word_embeddings.weight":
        "bert.embeddings.word_embeddings.weight",
    "embeddings.position_embeddings.weight":
        "bert.embeddings.position_embeddings.weight",
    "embeddings.token_type_embeddings.weight":
        "bert.embeddings.token_type_embeddings.weight",
    "embeddings.LayerNorm.{wb}": "bert.embeddings.LayerNorm.{wb}",
    "encoder.layer.{i}.attention.self.{qkv}.{wb}":
        "bert.encoder.layers.{i}.attention.self.{qkv}.{wb}",
    "encoder.layer.{i}.attention.output.{mod}.{wb}":
        "bert.encoder.layers.{i}.attention.output.{mod}.{wb}",
    "encoder.layer.{i}.intermediate.dense.{wb}":
        "bert.encoder.layers.{i}.intermediate.dense.{wb}",
    "encoder.layer.{i}.output.{mod}.{wb}":
        "bert.encoder.layers.{i}.output.{mod}.{wb}",
    "pooler.dense.{wb}": "bert_pooler.dense.{wb}",
}


def conv_pretrained_classifier(cfg: VanillaBertConfig, bundle: Any,
                               generator: torch.Generator
                               ) -> Dict[str, np.ndarray]:
    """`bundle` is a flat name -> np.ndarray dict in the classifier layout,
    an HF BertForSequenceClassification state dict or a bare HF BertModel
    one (whose classifier head is drawn from `generator`); HF's
    `position_ids` buffers are dropped."""
    dst = init_bert_classifier(cfg, generator)
    if "bert.encoder.layers.0.attention.self.query.weight" in bundle:
        return merge_param_dicts(({"{_}": ...}, bundle), into=dst)
    if "bert.encoder.layer.0.attention.self.query.weight" in bundle:
        rules = dict(HF_BERT_SEQCLS_RULES)
        rules.update({k: None for k in bundle
                      if k.startswith("bert.embeddings.position_ids")})
        return merge_param_dicts((rules, bundle), into=dst)
    if "encoder.layer.0.attention.self.query.weight" in bundle:
        rules = dict(HF_BERT_BARE_RULES)
        rules[New()] = "classifier.{wb}"
        rules.update({k: None for k in bundle
                      if k.startswith("embeddings.position_ids")})
        return merge_param_dicts((rules, bundle), into=dst)
    raise ValueError("unrecognized pretrained BERT bundle layout")


def n_players(cfg: VanillaBertConfig) -> int:
    """Every token but CLS (`:55`)."""
    return cfg.max_position_embeddings - 1


def conv_classifier_surrogate(cfg: VanillaBertConfig, _misc,
                              classifier: Flat,
                              generator: torch.Generator) -> Flat:
    """Every parameter copied: the surrogate starts as the classifier
    (`:110-117`)."""
    dst = init_bert_classifier(cfg, generator)
    rules = {"bert.{_}": ..., "bert_pooler.{_}": ..., "classifier.{_}": ...}
    return merge_param_dicts((rules, classifier), into=dst)


def conv_surrogate_explainer(cfg: VanillaBertConfig, _misc, surrogate: Flat,
                             generator: torch.Generator) -> Flat:
    """The surrogate's backbone copied, its pooler and head dropped, fresh
    explainer layers and head (`:120-129`)."""
    dst = init_bert_explainer(cfg, generator)
    rules = {
        "bert.{_}": ...,
        "bert_pooler.{_}": None,
        "classifier.{_}": None,
        New(): "explainer_attn.{rest}",
        New(): "explainer_mlp.{rest}",
    }
    return merge_param_dicts((rules, surrogate), into=dst)


def fw_classifier(cfg: VanillaBertConfig, model, xs: torch.Tensor,
                  mask: torch.Tensor, **kw):
    """-> (probabilities, probabilities): the classifier is its own
    teacher (`:147-150`)."""
    probs, _ = bert_classifier_fwd(model, cfg, *fw_xs_preprocess(xs, mask),
                                   **kw)
    return probs, probs


def fw_surrogate(cfg: VanillaBertConfig, model, xs: torch.Tensor,
                 mask: torch.Tensor, **kw):
    probs, _ = bert_surrogate_fwd(model, cfg, *fw_xs_preprocess(xs, mask),
                                  **kw)
    return probs, None


def fw_explainer(cfg: VanillaBertConfig, model, xs: torch.Tensor,
                 mask: torch.Tensor, grand: torch.Tensor, null: torch.Tensor,
                 **kw):
    ids, attn_mask, ttype = fw_xs_preprocess(xs, mask)
    attr, _ = bert_explainer_fwd(model, cfg, ids, attn_mask, ttype, grand,
                                 null, **kw)
    return attr, None


def fw_final(cfg: VanillaBertConfig, model,
             xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every token on: an all-ones attention mask and zero token types
    (`:165-169`)."""
    probs, attr, _ = bert_final_fwd(model, cfg, xs, torch.ones_like(xs),
                                    torch.zeros_like(xs))
    return probs, attr


def fw_classifier_repr(cfg: VanillaBertConfig, model, xs: torch.Tensor,
                       mask: torch.Tensor, **kw):
    """-> (probabilities, the encoder's hidden states) (`:172-175`)."""
    probs, obs = bert_classifier_fwd(model, cfg,
                                     *fw_xs_preprocess(xs, mask), **kw)
    return probs, obs["repr_cls"]


def fw_explainer_repr(cfg: VanillaBertConfig, model, xs: torch.Tensor,
                      mask: torch.Tensor, grand: torch.Tensor,
                      null: torch.Tensor, **kw):
    """-> (attributions, the encoder's hidden states) (`:178-183`)."""
    ids, attn_mask, ttype = fw_xs_preprocess(xs, mask)
    attr, obs = bert_explainer_fwd(model, cfg, ids, attn_mask, ttype, grand,
                                   null, **kw)
    return attr, obs["repr_exp"]


def fw_surrogate_coalitions(cfg: VanillaBertConfig, model, xs: torch.Tensor,
                            masks: torch.Tensor, **kw) -> torch.Tensor:
    """masks <B, M, T - 1> (no CLS column) -> <B, M, n_classes>
    (`:186-191`)."""
    b, m = masks.shape[:2]
    cls_col = torch.ones((b, m, 1), dtype=masks.dtype, device=masks.device)
    return bert_surrogate_coalitions_fwd(
        model, cfg, xs, torch.cat([cls_col, masks], dim=-1),
        torch.zeros_like(xs), **kw)


def conv_explainer_final(cfg: VanillaBertConfig, misc: BertMisc,
                         classifier: Flat, surrogate: Flat, explainer: Flat,
                         generator: torch.Generator,
                         device: torch.device) -> Flat:
    """The three towers under their prefixes and `surrogate_null`
    (`:194-207`)."""
    dst = init_bert_final(cfg, generator)
    return merge_param_dicts(
        ({"{_}": "classifier.{_}"}, classifier),
        ({"{_}": "surrogate.{_}"}, surrogate),
        ({"{_}": "explainer.{_}"}, explainer),
        ({"surrogate_null": ...},
         {"surrogate_null": null_values(fw_surrogate, cfg, surrogate,
                                        null_ids(cfg, misc), n_players(cfg),
                                        device)}),
        into=dst,
    )


def trainable(cfg: VanillaBertConfig, section: str) -> Callable[[str], bool]:
    """The black-box classifier is frozen; in the final only the
    classifier tower is (`:219-224`)."""
    if section == "classifier":
        return lambda name: False
    if section == "final":
        return lambda name: not name.startswith("classifier.")
    return lambda name: True


def vanilla_bert_recipe() -> ModelRecipe:
    return ModelRecipe(
        id="vanilla_bert",
        version=RECIPE_VERSION,
        t_config=VanillaBertConfig,
        n_players=n_players,
        gen_input=gen_input,
        gen_null=null_ids,
        training=TRAINING,
        fw_surrogate=fw_surrogate,
        fw_explainer=fw_explainer,
        fw_final=fw_final,
        fw_surrogate_coalitions=fw_surrogate_coalitions,
        trainable=trainable,
        load_misc=load_misc,
        init_classifier=init_bert_classifier,
        init_surrogate=init_bert_classifier,
        init_explainer=init_bert_explainer,
        init_final=init_bert_final,
        conv_pretrained_classifier=conv_pretrained_classifier,
        conv_classifier_surrogate=conv_classifier_surrogate,
        conv_surrogate_explainer=conv_surrogate_explainer,
        conv_explainer_final=conv_explainer_final,
        fw_classifier=fw_classifier,
        measurements=MEASUREMENTS,
        fw_classifier_repr=fw_classifier_repr,
        fw_explainer_repr=fw_explainer_repr,
    )
