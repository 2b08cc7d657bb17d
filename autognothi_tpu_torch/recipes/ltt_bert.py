"""Recipe: LTT BERT (port of the final-model parts of
`autognothi_tpu/recipes/ltt_bert.py`: `fw_final`, the data adapters and
`load_misc`).  The surrogate and explainer forwards, the coalition path
and the training rules are not ported yet (`None` / raising)."""

from __future__ import annotations

from typing import Tuple

import torch

from .. import RECIPE_VERSION
from ..models.ltt_bert import LttBert, LttBertConfig, ltt_bert_final_fwd
from . import vanilla_bert as vb
from .types import ModelRecipe, ModelRecipe_Training


def fw_final(cfg: LttBertConfig, model: LttBert,
             xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every token on: an all-ones attention mask and zero token types
    (`:161-165`), so the additive bias is zero."""
    mask = torch.ones_like(xs)
    return ltt_bert_final_fwd(model, cfg, xs, mask, torch.zeros_like(xs))


def _not_ported(*_args, **_kw):
    raise NotImplementedError(
        "training LTT BERT is not ported yet (the port serves its final)")


def ltt_bert_recipe() -> ModelRecipe:
    return ModelRecipe(
        id="ltt_bert",
        version=RECIPE_VERSION,
        t_config=LttBertConfig,
        n_players=lambda cfg: cfg.max_position_embeddings - 1,
        gen_input=vb.gen_input,
        gen_null=vb.null_ids,
        training=ModelRecipe_Training(
            support_classifier=True, support_surrogate=True,
            support_explainer=True, exp_variant_duo=False,
            exp_variant_kernel_shap=False),
        fw_surrogate=_not_ported,
        fw_explainer=_not_ported,
        fw_final=fw_final,
        fw_surrogate_coalitions=None,
        trainable=_not_ported,
        load_misc=vb.load_misc,
    )
