"""Recipe: LTT ViT (port of `autognothi_tpu/recipes/ltt_vit.py`): the
inits and the four conversions of the training pipeline, the forward
adapters, the data adapters and the freeze rules.

The conversions are the JAX recipe's surgery rules (`utils/surgery.py`) on
flat dicts of numpy arrays: copied parameters are the source's arrays,
`New()` ones come from a fresh init drawn from the caller's generator."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import RECIPE_VERSION
from ..models.ltt_vit import (LttViT, LttViTConfig, init_ltt_vit,
                              ltt_vit_explainer_fwd, ltt_vit_final_fwd,
                              ltt_vit_progressive,
                              ltt_vit_surrogate_coalitions_fwd,
                              ltt_vit_surrogate_fwd, ltt_vit_trainable)
from ..params import from_jax_params, to_flat
from ..utils.surgery import New, merge_param_dicts
from . import vanilla_vit as vv
from .types import (Flat, ModelRecipe, ModelRecipe_Measurements,
                    ModelRecipe_Training)


def n_players(cfg: LttViTConfig) -> int:
    return (cfg.img_px_size // cfg.img_patch_size) ** 2


def fw_xs_preprocess(xs: torch.Tensor, mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prepend the always-on CLS column to the player mask
    (`recipes/vanilla_vit.py:115-119`)."""
    cls_col = torch.ones((mask.shape[0], 1), dtype=mask.dtype,
                         device=mask.device)
    return xs, torch.cat([cls_col, mask], dim=1)


# ------------------------------------------------------------ inits


def _init(section: str):
    def init(cfg: LttViTConfig, generator: torch.Generator) -> Flat:
        return to_flat(init_ltt_vit(cfg, section, generator))
    return init


init_surrogate = _init("surrogate")
init_classifier = init_surrogate  # the classifier has the surrogate layout
init_explainer = _init("explainer")
init_final = _init("final")


# ------------------------------------------------------- conversions


def conv_pretrained_classifier(cfg: LttViTConfig, bundle: Dict,
                               generator: torch.Generator) -> Flat:
    """A base classifier bundle -> the classifier: its trunk and head
    copied, a fresh branch-0 ladder and side classifier (`:39-53`)."""
    v_classifier = vv.conv_pretrained_classifier(cfg.into(), bundle,
                                                 generator)
    dst = init_classifier(cfg, generator)
    rules = {
        "vit.embeddings.{_}": ...,
        "vit.encoder.layers.{_}": ...,
        "vit.layernorm.{wb}": ...,
        "classifier.{wb}": ...,
        New(): "vit.encoder.s_attn_maps.0_{rest}",
        New(): "vit.encoder.s_attn_layers.0_{rest}",
        New(): "vit.s_attn_layernorm.0.{wb}",
        New(): "s_attn_classifier.{wb}",
    }
    return merge_param_dicts((rules, v_classifier), into=dst)


def conv_classifier_surrogate(cfg: LttViTConfig, _misc, classifier: Flat,
                              generator: torch.Generator) -> Flat:
    """Every parameter copied (`:56-63`)."""
    dst = init_surrogate(cfg, generator)
    rules = {
        "vit.{_}": ...,
        "classifier.{_}": ...,
        "s_attn_classifier.{_}": ...,
    }
    return merge_param_dicts((rules, classifier), into=dst)


def conv_surrogate_explainer(cfg: LttViTConfig, _misc, surrogate: Flat,
                             generator: torch.Generator) -> Flat:
    """The trunk and the trained branch-0 ladder copied, the side
    classifier dropped, a fresh explainer side layer and head
    (`:66-75`)."""
    dst = init_explainer(cfg, generator)
    rules = {
        "vit.{_}": ...,  # incl. the trained branch-0 ladder + its layernorm
        "classifier.{_}": ...,
        "s_attn_classifier.{wb}": None,
        New(): "s_explainer_attn.{rest}",
        New(): "s_explainer_mlp.{rest}",
    }
    return merge_param_dicts((rules, surrogate), into=dst)


def conv_explainer_final(cfg: LttViTConfig, _misc, classifier: Flat,
                         surrogate: Flat, explainer: Flat,
                         generator: torch.Generator,
                         device: torch.device) -> Flat:
    """The final: the classifier's trunk, the surrogate's branch 0, the
    explainer's branch 0 as branch 1 with its side layer and head, and
    `surrogate_null`, the surrogate on the all-on null input (`:78-123`).
    The JAX package runs this on the host; the port runs the surrogate
    forward on `device`, the rest is surgery on the host."""
    srg = from_jax_params(surrogate, cfg, device, section="surrogate")
    with torch.no_grad():
        nil_xs = torch.from_numpy(gen_null(cfg)).to(device)
        surrogate_null, _ = fw_surrogate(
            cfg, srg, nil_xs, torch.ones((1, n_players(cfg)),
                                         dtype=torch.int32, device=device))
    rules_cls = {
        "vit.embeddings.{_}": ...,
        "vit.encoder.layers.{_}": ...,
        "vit.layernorm.{wb}": ...,
        "classifier.{wb}": ...,
        "vit.encoder.s_attn_maps.0_{rest}": None,
        "vit.encoder.s_attn_layers.0_{rest}": None,
        "vit.s_attn_layernorm.0.{wb}": None,
        "s_attn_classifier.{wb}": None,
    }
    rules_srg = {
        "vit.embeddings.{_}": None,
        "vit.encoder.layers.{_}": None,
        "vit.layernorm.{wb}": None,
        "classifier.{_}": None,
        "vit.encoder.s_attn_maps.0_{rest}": ...,
        "vit.encoder.s_attn_layers.0_{rest}": ...,
        "vit.s_attn_layernorm.0.{wb}": ...,
        "s_attn_classifier.{wb}": ...,
    }
    rules_exp = {
        "vit.embeddings.{_}": None,
        "vit.encoder.layers.{_}": None,
        "vit.layernorm.{wb}": None,
        "classifier.{_}": None,
        "vit.encoder.s_attn_maps.0_{rest}": "vit.encoder.s_attn_maps.1_{rest}",
        "vit.encoder.s_attn_layers.0_{rest}":
            "vit.encoder.s_attn_layers.1_{rest}",
        "vit.s_attn_layernorm.0.{wb}": "vit.s_attn_layernorm.1.{wb}",
        "s_explainer_attn.{_}": ...,
        "s_explainer_mlp.{_}": ...,
    }
    dst = init_final(cfg, generator)
    return merge_param_dicts(
        (rules_cls, classifier),
        (rules_srg, surrogate),
        (rules_exp, explainer),
        ({"surrogate_null": ...},
         {"surrogate_null": surrogate_null.float().cpu().numpy()}),
        into=dst,
    )


# -------------------------------------------------- forward adapters


def fw_classifier(cfg: LttViTConfig, model: LttViT, xs: torch.Tensor,
                  mask: torch.Tensor, **kw
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (the side branch-0 probabilities, the trunk probabilities): the
    classifier stage trains on the first, the surrogate's teacher is the
    second (`:126-129`)."""
    srg, cls, _ = ltt_vit_surrogate_fwd(model, cfg,
                                        *fw_xs_preprocess(xs, mask), **kw)
    return srg, cls


def fw_surrogate(cfg: LttViTConfig, model: LttViT, xs: torch.Tensor,
                 mask: torch.Tensor, **kw):
    srg, cls, _ = ltt_vit_surrogate_fwd(model, cfg,
                                        *fw_xs_preprocess(xs, mask), **kw)
    return srg, cls


def fw_explainer(cfg: LttViTConfig, model: LttViT, xs: torch.Tensor,
                 mask: torch.Tensor, grand: torch.Tensor, null: torch.Tensor,
                 **kw):
    attr, cls, _ = ltt_vit_explainer_fwd(model, cfg,
                                         *fw_xs_preprocess(xs, mask), grand,
                                         null, **kw)
    return attr, cls


def fw_classifier_repr(cfg: LttViTConfig, model: LttViT, xs: torch.Tensor,
                       mask: torch.Tensor, **kw):
    """-> (side probabilities, the trunk's hidden states) (`:158-161`)."""
    srg, _, obs = ltt_vit_surrogate_fwd(model, cfg,
                                        *fw_xs_preprocess(xs, mask), **kw)
    return srg, obs["repr_cls"]


def fw_explainer_repr(cfg: LttViTConfig, model: LttViT, xs: torch.Tensor,
                      mask: torch.Tensor, grand: torch.Tensor,
                      null: torch.Tensor, **kw):
    """-> (attributions, branch 0's side states) (`:164-171`)."""
    attr, _, obs = ltt_vit_explainer_fwd(model, cfg,
                                         *fw_xs_preprocess(xs, mask), grand,
                                         null, **kw)
    return attr, obs["repr_exp"]


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
        init_classifier=init_classifier,
        init_surrogate=init_surrogate,
        init_explainer=init_explainer,
        init_final=init_final,
        conv_pretrained_classifier=conv_pretrained_classifier,
        conv_classifier_surrogate=conv_classifier_surrogate,
        conv_surrogate_explainer=conv_surrogate_explainer,
        conv_explainer_final=conv_explainer_final,
        fw_classifier=fw_classifier,
        measurements=ModelRecipe_Measurements(
            verify_final_coherency=True,
            allow_accuracy=True,
            allow_faithfulness=True,
            allow_cls_acc=True,
            allow_performance_cls=True,
            allow_performance_srg_exp=True,
            allow_performance_fin=True,
            allow_train_resources=True,
            allow_dual_task_similarity=False,
            allow_branches_cka=True,
        ),
        fw_classifier_repr=fw_classifier_repr,
        fw_explainer_repr=fw_explainer_repr,
    )
