"""Recipe: LTT ViT (port of the forward adapters, data adapters and freeze
rules of `autognothi_tpu/recipes/ltt_vit.py`)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import RECIPE_VERSION
from ..models.ltt_vit import (LttViT, LttViTConfig, ltt_vit_explainer_fwd,
                              ltt_vit_final_fwd, ltt_vit_progressive,
                              ltt_vit_surrogate_coalitions_fwd,
                              ltt_vit_surrogate_fwd, ltt_vit_trainable)
from .types import ModelRecipe, ModelRecipe_Training


def n_players(cfg: LttViTConfig) -> int:
    return (cfg.img_px_size // cfg.img_patch_size) ** 2


def fw_xs_preprocess(xs: torch.Tensor, mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prepend the always-on CLS column to the player mask
    (`recipes/vanilla_vit.py:115-119`)."""
    cls_col = torch.ones((mask.shape[0], 1), dtype=mask.dtype,
                         device=mask.device)
    return xs, torch.cat([cls_col, mask], dim=1)


def fw_surrogate(cfg: LttViTConfig, model: LttViT, xs: torch.Tensor,
                 mask: torch.Tensor, **kw):
    xs, mask = fw_xs_preprocess(xs, mask)
    return ltt_vit_surrogate_fwd(model, cfg, xs, mask, **kw)


def fw_explainer(cfg: LttViTConfig, model: LttViT, xs: torch.Tensor,
                 mask: torch.Tensor, grand: torch.Tensor, null: torch.Tensor,
                 **kw):
    xs, mask = fw_xs_preprocess(xs, mask)
    return ltt_vit_explainer_fwd(model, cfg, xs, mask, grand, null, **kw)


def fw_final(cfg: LttViTConfig, model: LttViT,
             xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """All players on: the mask is ones over CLS + every patch."""
    mask = torch.ones((xs.shape[0], 1 + n_players(cfg)), device=xs.device)
    return ltt_vit_final_fwd(model, cfg, xs, mask)


def fw_surrogate_coalitions(cfg: LttViTConfig, model: LttViT,
                            xs: torch.Tensor, masks: torch.Tensor, **kw
                            ) -> torch.Tensor:
    """masks <B, M, n_players> (no CLS column) -> <B, M, n_classes>."""
    b, m = masks.shape[:2]
    cls_col = torch.ones((b, m, 1), dtype=masks.dtype, device=masks.device)
    return ltt_vit_surrogate_coalitions_fwd(
        model, cfg, xs, torch.cat([cls_col, masks], dim=-1), **kw)


def gen_null(cfg: LttViTConfig, misc=None) -> np.ndarray:
    return np.zeros((1, cfg.img_channels, cfg.img_px_size, cfg.img_px_size),
                    dtype=np.float32)


def gen_input(cfg: LttViTConfig, misc=None):
    def collate(raw_xs, raw_ys) -> Tuple[np.ndarray, np.ndarray]:
        xs = np.stack([np.asarray(x, dtype=np.float32) for x in raw_xs])
        return xs, np.asarray(raw_ys, dtype=np.int64)

    return collate


def ltt_vit_recipe() -> ModelRecipe:
    return ModelRecipe(
        id="ltt_vit",
        version=RECIPE_VERSION,
        t_config=LttViTConfig,
        n_players=n_players,
        gen_input=gen_input,
        gen_null=gen_null,
        training=ModelRecipe_Training(
            support_classifier=True, support_surrogate=True,
            support_explainer=True, exp_variant_duo=False,
            exp_variant_kernel_shap=False),
        fw_surrogate=fw_surrogate,
        fw_explainer=fw_explainer,
        fw_final=fw_final,
        fw_surrogate_coalitions=fw_surrogate_coalitions,
        trainable=ltt_vit_trainable,
        progressive_trainable=ltt_vit_progressive,
    )
