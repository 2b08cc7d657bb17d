"""Vanilla BERT, the parts the LTT BERT recipe builds on (port of
`autognothi_tpu/recipes/vanilla_bert.py`): the data adapters (`_null_ids`,
`_gen_input`, `fw_xs_preprocess`) and a pretrained classifier bundle ->
the classifier layout, from the port's own layout or from Hugging Face's
BertForSequenceClassification or bare BertModel layouts (`:50-108`).
The vanilla BERT towers themselves are not ported yet."""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..data.tokenizer import encode_batch, load_tokenizer
from ..models.bert import VanillaBertConfig, init_bert_classifier
from ..utils.surgery import New, merge_param_dicts


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
