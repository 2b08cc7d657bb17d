"""Froyo ViT (port of `autognothi_tpu/models/froyo_vit.py`): the vanilla
ViT with a frozen backbone.  The classifier, surrogate and explainer
sections are the vanilla ones and run the vanilla forwards; the variant
changes the trainable sets (the `vit.` trunk trains in no stage) and the
final, which runs one `vit.` trunk and feeds the classifier head, the
surrogate's head (`srg_classifier`) and the explainer's layers and head
from the same hidden states."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from .vit import (VanillaViTConfig, ViTBackbone, _cls_probs,
                  explainer_layers, explainer_mlp_head_module,
                  fill_explainer_head, fill_linear, linear,
                  vanilla_vit_model, vit_backbone, vit_explainer_head)


@dataclasses.dataclass(frozen=True)
class FroyoViTConfig(VanillaViTConfig):
    """The vanilla ViT's hyperparameters."""

    def into(self) -> VanillaViTConfig:
        return VanillaViTConfig(**dataclasses.asdict(self))


class FroyoViTFinal(nn.Module):
    """The froyo final (`init_froyo_vit_final`): `vit.*`, `classifier.*`,
    `srg_classifier.*`, `surrogate_null`, `explainer_attn.{i}.*` and
    `explainer_mlp.*`."""

    def __init__(self, cfg: VanillaViTConfig):
        super().__init__()
        self.vit = ViTBackbone(cfg)
        self.classifier = linear(cfg.num_labels, cfg.hidden_size)
        self.srg_classifier = linear(cfg.num_labels, cfg.hidden_size)
        self.register_buffer("surrogate_null", torch.zeros(1, cfg.num_labels))
        self.explainer_attn = explainer_layers(cfg)
        self.explainer_mlp = explainer_mlp_head_module(
            cfg.hidden_size, cfg.explainer_head_hidden_size, cfg.num_labels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.vit.reset_parameters(generator)
        fill_linear(self.classifier, generator)
        fill_linear(self.srg_classifier, generator)
        with torch.no_grad():
            self.surrogate_null.zero_()
        fill_explainer_head(self.explainer_attn, self.explainer_mlp,
                            generator)


def froyo_vit_model(cfg: FroyoViTConfig, section: str = "final") -> nn.Module:
    """A checkpoint section's module, created empty: the vanilla layouts
    but for the final."""
    return FroyoViTFinal(cfg) if section == "final" \
        else vanilla_vit_model(cfg, section)


def init_froyo_vit_final(cfg: FroyoViTConfig, generator: torch.Generator
                         ) -> Dict[str, np.ndarray]:
    model = FroyoViTFinal(cfg)
    model.reset_parameters(generator)
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def froyo_vit_final_fwd(model: FroyoViTFinal, cfg: FroyoViTConfig,
                        pixels: torch.Tensor, mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """One trunk traversal -> (class probabilities, attributions, the
    representations, all the trunk's) (`:44-76`)."""
    h = vit_backbone(model.vit, cfg, pixels, mask)
    probs = _cls_probs(model.classifier, h)
    grand = _cls_probs(model.srg_classifier, h) if cfg.explainer_normalize \
        else torch.zeros_like(probs)
    attr = vit_explainer_head(model, cfg, h, mask, grand,
                              model.surrogate_null)
    return probs, attr, {"repr_cls": h, "repr_srg": h, "repr_exp": h}


def froyo_vit_trainable(cfg: FroyoViTConfig,
                        section: str) -> Callable[[str], bool]:
    """The froyo freeze policy (`:79-86`): the classifier trains nothing;
    the surrogate and the explainer train everything but the `vit.` trunk;
    the final neither the trunk nor the classifier head."""
    if section == "classifier":
        return lambda name: False
    if section in ("surrogate", "explainer"):
        return lambda name: not name.startswith("vit.")
    if section == "final":
        return lambda name: not name.startswith(("vit.", "classifier."))
    return lambda name: True
