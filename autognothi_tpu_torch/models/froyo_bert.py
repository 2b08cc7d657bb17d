"""Froyo BERT (port of `autognothi_tpu/models/froyo_bert.py`): the vanilla
BERT with a frozen backbone.  The classifier, surrogate and explainer
sections are the vanilla ones and run the vanilla forwards; the variant
changes the trainable sets (the `bert.` trunk trains in no stage) and the
final, which runs one `bert.` trunk and feeds the classifier's pooler and
head, the surrogate's (`srg_bert_pooler`, `srg_classifier`) and the
explainer's layers and head from the same hidden states."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from .bert import (BertBackbone, VanillaBertConfig, _cls_head,
                   bert_backbone, bert_explainer_head, explainer_layers,
                   explainer_mlp_module, fill_bert_backbone,
                   fill_explainer_head, pooled_probs, vanilla_bert_model)
from .vit import fill_linear, linear


@dataclasses.dataclass(frozen=True)
class FroyoBertConfig(VanillaBertConfig):
    """The vanilla BERT's hyperparameters."""

    def into(self) -> VanillaBertConfig:
        return VanillaBertConfig(**dataclasses.asdict(self))


class FroyoBertFinal(nn.Module):
    """The froyo final (`init_froyo_bert_final`): `bert.*`,
    `bert_pooler.dense.*`, `classifier.*`, `srg_bert_pooler.dense.*`,
    `srg_classifier.*`, `surrogate_null`, `explainer_attn.{i}.*` and
    `explainer_mlp.{0,2,4}.*`."""

    def __init__(self, cfg: VanillaBertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.bert = BertBackbone(cfg)
        self.bert_pooler = nn.Module()
        self.bert_pooler.dense = linear(h, h)
        self.classifier = linear(cfg.num_labels, h)
        self.srg_bert_pooler = nn.Module()
        self.srg_bert_pooler.dense = linear(h, h)
        self.srg_classifier = linear(cfg.num_labels, h)
        self.register_buffer("surrogate_null", torch.zeros(1, cfg.num_labels))
        self.explainer_attn = explainer_layers(cfg)
        self.explainer_mlp = explainer_mlp_module(
            h, cfg.explainer_head_hidden_size, cfg.num_labels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        fill_bert_backbone(self.bert, generator)
        for m in (self.bert_pooler.dense, self.classifier,
                  self.srg_bert_pooler.dense, self.srg_classifier):
            fill_linear(m, generator)
        with torch.no_grad():
            self.surrogate_null.zero_()
        fill_explainer_head(self.explainer_attn, self.explainer_mlp,
                            generator)


def froyo_bert_model(cfg: FroyoBertConfig,
                     section: str = "final") -> nn.Module:
    """A checkpoint section's module, created empty: the vanilla layouts
    but for the final."""
    return FroyoBertFinal(cfg) if section == "final" \
        else vanilla_bert_model(cfg, section)


def init_froyo_bert_final(cfg: FroyoBertConfig, generator: torch.Generator
                          ) -> Dict[str, np.ndarray]:
    model = FroyoBertFinal(cfg)
    model.reset_parameters(generator)
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def froyo_bert_final_fwd(model: FroyoBertFinal, cfg: FroyoBertConfig,
                         input_ids: torch.Tensor,
                         attention_mask: torch.Tensor,
                         token_type_ids: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """One trunk traversal -> (class probabilities, attributions, the
    representations, all the trunk's) (`:59-100`)."""
    h = bert_backbone(model.bert, cfg, input_ids, attention_mask,
                      token_type_ids)
    probs = _cls_head(model, h, cfg)
    grand = (pooled_probs(model.srg_bert_pooler.dense, model.srg_classifier,
                          h, cfg)
             if cfg.explainer_normalize else torch.zeros_like(probs))
    attr = bert_explainer_head(model, cfg, h, attention_mask, grand,
                               model.surrogate_null)
    return probs, attr, {"repr_cls": h, "repr_srg": h, "repr_exp": h}


def froyo_bert_trainable(cfg: FroyoBertConfig,
                         section: str) -> Callable[[str], bool]:
    """The froyo freeze policy (`:103-115`): the classifier trains nothing;
    the surrogate and the explainer train everything but the `bert.` trunk;
    the final neither the trunk nor the classifier's pooler and head."""
    if section == "classifier":
        return lambda name: False
    if section in ("surrogate", "explainer"):
        return lambda name: not name.startswith("bert.")
    if section == "final":
        return lambda name: not name.startswith(
            ("bert.", "bert_pooler.", "classifier."))
    return lambda name: True
