"""Duo vanilla ViT (port of `autognothi_tpu/models/duo_vit.py`): one
network trained on classification and explanation at once.  The
classifier and surrogate sections are the vanilla ViT classifier; the
duo explainer is a vanilla ViT classifier (`vit.*`, `classifier.*`) with
the vanilla explainer's layers and head (`explainer_attn.{i}.*`,
`explainer_mlp.*`) on the same backbone; the final holds the surrogate
and the duo explainer under `surrogate.` and `explainer.`, and
`surrogate_null`: it has no classifier tower, its class probabilities
come from the explainer.

Unlike the duo BERT, the duo ViT explainer's classification head applies
softmax (`:77-81`).  `duo_vit_explainer_from_emb` starts from the
embedding output: the boundary the dual-task gradient probe
differentiates at.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .common import layer_norm
from .vit import (VanillaViTConfig, ViTBackbone, ViTClassifier, _cls_probs,
                  _flat, explainer_layers, explainer_mlp_head_module,
                  fill_explainer_head, fill_linear, linear, vit_embeddings,
                  vit_encoder, vit_explainer_head, vit_patch_extract,
                  vit_surrogate_fwd)


@dataclasses.dataclass(frozen=True)
class DuoVanillaViTConfig(VanillaViTConfig):
    """The vanilla ViT's hyperparameters."""

    def into(self) -> VanillaViTConfig:
        return VanillaViTConfig(**dataclasses.asdict(self))


class DuoViTExplainer(nn.Module):
    """The duo explainer (`init_duo_vit_explainer`): `vit.*`,
    `classifier.*`, `explainer_attn.{i}.*` and `explainer_mlp.*`."""

    def __init__(self, cfg: VanillaViTConfig):
        super().__init__()
        self.vit = ViTBackbone(cfg)
        self.classifier = linear(cfg.num_labels, cfg.hidden_size)
        self.explainer_attn = explainer_layers(cfg)
        self.explainer_mlp = explainer_mlp_head_module(
            cfg.hidden_size, cfg.explainer_head_hidden_size, cfg.num_labels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.vit.reset_parameters(generator)
        fill_linear(self.classifier, generator)
        fill_explainer_head(self.explainer_attn, self.explainer_mlp,
                            generator)


class DuoViTFinal(nn.Module):
    """The duo final (`init_duo_vit_final`): `surrogate.*` (a vanilla
    classifier), `explainer.*` (the duo explainer) and `surrogate_null`."""

    def __init__(self, cfg: VanillaViTConfig):
        super().__init__()
        self.surrogate = ViTClassifier(cfg)
        self.explainer = DuoViTExplainer(cfg)
        self.register_buffer("surrogate_null", torch.zeros(1, cfg.num_labels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.surrogate.reset_parameters(generator)
        self.explainer.reset_parameters(generator)
        with torch.no_grad():
            self.surrogate_null.zero_()


SECTIONS = {"classifier": ViTClassifier, "surrogate": ViTClassifier,
            "explainer": DuoViTExplainer, "final": DuoViTFinal}


def duo_vit_model(cfg: DuoVanillaViTConfig,
                  section: str = "final") -> nn.Module:
    """A checkpoint section's module, created empty."""
    if section not in SECTIONS:
        raise ValueError(f"unknown duo ViT section {section!r}")
    return SECTIONS[section](cfg)


def init_duo_vit_explainer(cfg: DuoVanillaViTConfig,
                           generator: torch.Generator
                           ) -> Dict[str, np.ndarray]:
    return _flat(DuoViTExplainer(cfg), generator)


def init_duo_vit_final(cfg: DuoVanillaViTConfig, generator: torch.Generator
                       ) -> Dict[str, np.ndarray]:
    return _flat(DuoViTFinal(cfg), generator)


def duo_vit_explainer_from_emb(model: DuoViTExplainer,
                               cfg: DuoVanillaViTConfig, emb: torch.Tensor,
                               mask: torch.Tensor, grand: torch.Tensor,
                               null: torch.Tensor, *,
                               deterministic: bool = True,
                               rng: Optional[torch.Generator] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """From the embedding output <B, T, H>: the encoder, the final
    LayerNorm, the softmax classification head and the explainer's layers
    and head -> (probabilities, attributions, {"repr_cls", "repr_exp": the
    backbone's hidden states}) (`:56-82`)."""
    vit = model.vit
    h = vit_encoder(vit, cfg, emb, mask, deterministic=deterministic,
                    rng=rng)
    h = layer_norm(h, vit.layernorm.weight, vit.layernorm.bias,
                   cfg.layer_norm_eps)
    probs = _cls_probs(model.classifier, h)
    attr = vit_explainer_head(model, cfg, h, mask, grand, null,
                              deterministic=deterministic, rng=rng)
    return probs, attr, {"repr_cls": h, "repr_exp": h}


def duo_vit_explainer_fwd(model: DuoViTExplainer, cfg: DuoVanillaViTConfig,
                          pixels: torch.Tensor, mask: torch.Tensor,
                          grand: torch.Tensor, null: torch.Tensor, *,
                          deterministic: bool = True,
                          rng: Optional[torch.Generator] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Pixels <B, C, H, W> or patches -> (probabilities, attributions,
    representations) (`:85-104`)."""
    emb = vit_embeddings(model.vit.embeddings, cfg, pixels,
                         deterministic=deterministic, rng=rng)
    return duo_vit_explainer_from_emb(model, cfg, emb, mask, grand, null,
                                      deterministic=deterministic, rng=rng)


def duo_vit_final_fwd(model: DuoViTFinal, cfg: DuoVanillaViTConfig,
                      pixels: torch.Tensor, mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """-> (the explainer's class probabilities, attributions,
    representations) (`:107-143`): the surrogate's grand coalition
    normalises the attributions; the patch rearrange is shared."""
    patches = vit_patch_extract(cfg, pixels) if pixels.dim() == 4 \
        else pixels
    obs = {}
    if cfg.explainer_normalize:
        grand, obs_s = vit_surrogate_fwd(model.surrogate, cfg, patches, mask)
        obs["repr_srg"] = obs_s["repr_cls"]
    else:
        grand = torch.zeros((pixels.shape[0], cfg.num_labels),
                            device=pixels.device)
    probs, attr, obs_e = duo_vit_explainer_fwd(
        model.explainer, cfg, patches, mask, grand, model.surrogate_null)
    obs["repr_cls"] = obs_e["repr_cls"]
    obs["repr_exp"] = obs_e["repr_exp"]
    return probs, attr, obs
