"""Duo vanilla BERT (port of `autognothi_tpu/models/duo_bert.py`): one
network trained on classification and explanation at once.  The
classifier and surrogate sections are the vanilla BERT classifier; the
duo explainer is a vanilla BERT classifier (`bert.*`, `bert_pooler.*`,
`classifier.*`) with the vanilla explainer's layers and head
(`explainer_attn.{i}.*`, `explainer_mlp.{0,2,4}.*`) on the same encoder;
the final holds the surrogate and the duo explainer under `surrogate.`
and `explainer.`, and `surrogate_null`.

Quirks kept from the JAX package:
- the duo explainer's classification head gives RAW logits, no softmax
  (`:91-92`), unlike every other classifier head;
- the pooler's dropout (fold 30 of the JAX key, `:86-89`; drawn from
  `rng` in order here);
- the final has no classifier section: (logits, attributions) and
  `repr_cls` come from the explainer (`:153-156`), so the recipe checks
  no final coherency.

`duo_bert_explainer_from_emb` starts from the embedding output: the
boundary the dual-task gradient probe differentiates at.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .bert import (BertBackbone, BertClassifier, VanillaBertConfig, _flat,
                   bert_embeddings, bert_encoder, bert_explainer_head,
                   bert_surrogate_fwd, explainer_layers,
                   explainer_mlp_module, fill_bert_backbone,
                   fill_explainer_head)
from .common import additive_mask_bias, dense, dropout
from .vit import fill_linear, linear


@dataclasses.dataclass(frozen=True)
class DuoVanillaBertConfig(VanillaBertConfig):
    """The vanilla BERT's hyperparameters."""

    def into(self) -> VanillaBertConfig:
        return VanillaBertConfig(**dataclasses.asdict(self))


class DuoBertExplainer(nn.Module):
    """The duo explainer (`init_duo_bert_explainer`): `bert.*`,
    `bert_pooler.dense.*`, `classifier.*` (the raw-logit head),
    `explainer_attn.{i}.*` and `explainer_mlp.{0,2,4}.*`."""

    def __init__(self, cfg: VanillaBertConfig):
        super().__init__()
        self.bert = BertBackbone(cfg)
        self.bert_pooler = nn.Module()
        self.bert_pooler.dense = linear(cfg.hidden_size, cfg.hidden_size)
        self.classifier = linear(cfg.num_labels, cfg.hidden_size)
        self.explainer_attn = explainer_layers(cfg)
        self.explainer_mlp = explainer_mlp_module(
            cfg.hidden_size, cfg.explainer_head_hidden_size, cfg.num_labels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        fill_bert_backbone(self.bert, generator)
        fill_linear(self.bert_pooler.dense, generator)
        fill_linear(self.classifier, generator)
        fill_explainer_head(self.explainer_attn, self.explainer_mlp,
                            generator)


class DuoBertFinal(nn.Module):
    """The duo final (`init_duo_bert_final`): `surrogate.*` (a vanilla
    classifier), `explainer.*` (the duo explainer) and `surrogate_null`."""

    def __init__(self, cfg: VanillaBertConfig):
        super().__init__()
        self.surrogate = BertClassifier(cfg)
        self.explainer = DuoBertExplainer(cfg)
        self.register_buffer("surrogate_null", torch.zeros(1, cfg.num_labels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.surrogate.reset_parameters(generator)
        self.explainer.reset_parameters(generator)
        with torch.no_grad():
            self.surrogate_null.zero_()


SECTIONS = {"classifier": BertClassifier, "surrogate": BertClassifier,
            "explainer": DuoBertExplainer, "final": DuoBertFinal}


def duo_bert_model(cfg: DuoVanillaBertConfig,
                   section: str = "final") -> nn.Module:
    """A checkpoint section's module, created empty."""
    if section not in SECTIONS:
        raise ValueError(f"unknown duo BERT section {section!r}")
    return SECTIONS[section](cfg)


def init_duo_bert_explainer(cfg: DuoVanillaBertConfig,
                            generator: torch.Generator
                            ) -> Dict[str, np.ndarray]:
    return _flat(DuoBertExplainer(cfg), generator)


def init_duo_bert_final(cfg: DuoVanillaBertConfig,
                        generator: torch.Generator) -> Dict[str, np.ndarray]:
    return _flat(DuoBertFinal(cfg), generator)


def duo_bert_explainer_from_emb(model: DuoBertExplainer,
                                cfg: DuoVanillaBertConfig,
                                emb: torch.Tensor,
                                attention_mask: torch.Tensor,
                                grand: torch.Tensor, null: torch.Tensor, *,
                                deterministic: bool = True,
                                rng: Optional[torch.Generator] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """From the embedding output <B, T, H>: the encoder, the tanh pooler,
    dropout, the raw-logit head and the explainer's layers and head ->
    (raw logits, attributions, {"repr_cls", "repr_exp": the encoder's
    hidden states}) (`:61-95`)."""
    bias = additive_mask_bias(attention_mask, emb.dtype)
    h = bert_encoder(model.bert, cfg, emb, bias, deterministic=deterministic,
                     rng=rng)
    pooler = model.bert_pooler.dense
    pooled = torch.tanh(dense(h[:, 0, :], pooler.weight.to(h.dtype),
                              pooler.bias.to(h.dtype)))
    pooled = dropout(rng, pooled, cfg.hidden_dropout_prob, deterministic)
    logits = dense(pooled, model.classifier.weight.to(h.dtype),
                   model.classifier.bias.to(h.dtype))  # RAW, no softmax
    attr = bert_explainer_head(model, cfg, h, attention_mask, grand, null,
                               deterministic=deterministic, rng=rng)
    return logits, attr, {"repr_cls": h, "repr_exp": h}


def duo_bert_explainer_fwd(model: DuoBertExplainer,
                           cfg: DuoVanillaBertConfig,
                           input_ids: torch.Tensor,
                           attention_mask: torch.Tensor,
                           token_type_ids: torch.Tensor, grand: torch.Tensor,
                           null: torch.Tensor, *, deterministic: bool = True,
                           rng: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """ids <B, T> -> (raw logits, attributions, representations)
    (`:98-118`)."""
    emb = bert_embeddings(model.bert.embeddings, cfg, input_ids,
                          token_type_ids, deterministic=deterministic,
                          rng=rng)
    return duo_bert_explainer_from_emb(model, cfg, emb, attention_mask,
                                       grand, null,
                                       deterministic=deterministic, rng=rng)


def duo_bert_final_fwd(model: DuoBertFinal, cfg: DuoVanillaBertConfig,
                       input_ids: torch.Tensor, attention_mask: torch.Tensor,
                       token_type_ids: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """-> (the explainer's raw logits, attributions, representations, with
    `repr_cls` the explainer's) (`:121-157`)."""
    args = (input_ids, attention_mask, token_type_ids)
    obs = {}
    if cfg.explainer_normalize:
        grand, obs_s = bert_surrogate_fwd(model.surrogate, cfg, *args)
        obs["repr_srg"] = obs_s["repr_cls"]
    else:
        grand = torch.zeros((input_ids.shape[0], cfg.num_labels),
                            device=input_ids.device)
    logits, attr, obs_e = duo_bert_explainer_fwd(
        model.explainer, cfg, *args, grand, model.surrogate_null)
    obs["repr_cls"] = obs_e["repr_cls"]
    obs["repr_exp"] = obs_e["repr_exp"]
    return logits, attr, obs
