"""Recipe: duo vanilla ViT (port of `autognothi_tpu/recipes/
duo_vanilla_vit.py`): the vanilla ViT's classifier and surrogate stages,
the duo explainer (a classifier that also explains) and its final, the
forward adapters (`fw_explainer` returns (attributions, probabilities)),
the dual-task gradient probe and the freeze rules (the classifier trains
nothing; every other section everything).  The final has no classifier
tower, so `train_all` checks no coherency (`verify_final_coherency` is
False, as in the JAX recipe)."""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .. import RECIPE_VERSION
from ..models.duo_vit import (DuoVanillaViTConfig, duo_vit_explainer_from_emb,
                              duo_vit_explainer_fwd, duo_vit_final_fwd,
                              init_duo_vit_explainer, init_duo_vit_final)
from ..models.vit import init_vit_classifier, vit_embeddings
from ..ops.shapley import loss_shapley
from ..pipeline.training import cross_entropy_on_probs
from ..utils.surgery import New, merge_param_dicts
from . import vanilla_vit as vv
from .types import (Flat, ModelRecipe, ModelRecipe_Measurements,
                    ModelRecipe_Measurements_DualTaskSimilarity,
                    ModelRecipe_Training, null_values)


def conv_surrogate_explainer(cfg: DuoVanillaViTConfig, _misc,
                             surrogate: Flat,
                             generator: torch.Generator) -> Flat:
    """The surrogate's backbone and classification head copied, fresh
    explainer layers and head (`:45-53`)."""
    dst = init_duo_vit_explainer(cfg, generator)
    rules = {
        "vit.{_}": ...,
        "classifier.{_}": ...,
        New(): "explainer_attn.{rest}",
        New(): "explainer_mlp.{rest}",
    }
    return merge_param_dicts((rules, surrogate), into=dst)


def conv_explainer_final(cfg: DuoVanillaViTConfig, _misc, classifier: Flat,
                         surrogate: Flat, explainer: Flat,
                         generator: torch.Generator,
                         device: torch.device) -> Flat:
    """The surrogate and the duo explainer under their prefixes and
    `surrogate_null`; the classifier is not part of it (`:56-69`)."""
    dst = init_duo_vit_final(cfg, generator)
    return merge_param_dicts(
        ({"{_}": "surrogate.{_}"}, surrogate),
        ({"{_}": "explainer.{_}"}, explainer),
        ({"surrogate_null": ...},
         {"surrogate_null": null_values(vv.fw_surrogate, cfg, surrogate,
                                        vv._np_null(cfg), vv.n_players(cfg),
                                        device)}),
        into=dst,
    )


def fw_explainer(cfg: DuoVanillaViTConfig, model, xs: torch.Tensor,
                 mask: torch.Tensor, grand: torch.Tensor, null: torch.Tensor,
                 **kw):
    """-> (attributions, the explainer's class probabilities)."""
    probs, attr, _ = duo_vit_explainer_fwd(
        model, cfg, *vv.fw_xs_preprocess(xs, mask), grand, null, **kw)
    return attr, probs


def fw_final(cfg: DuoVanillaViTConfig, model,
             xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """All players on: the mask is ones over CLS + every patch."""
    mask = torch.ones((xs.shape[0], 1 + vv.n_players(cfg)),
                      dtype=torch.int32, device=xs.device)
    probs, attr, _ = duo_vit_final_fwd(model, cfg, xs, mask)
    return probs, attr


def fw_explainer_repr(cfg: DuoVanillaViTConfig, model, xs: torch.Tensor,
                      mask: torch.Tensor, grand: torch.Tensor,
                      null: torch.Tensor, **kw):
    """-> (attributions, the backbone's hidden states) (`:87-92`)."""
    _, attr, obs = duo_vit_explainer_fwd(
        model, cfg, *vv.fw_xs_preprocess(xs, mask), grand, null, **kw)
    return attr, obs["repr_exp"]


def dual_task_grads(emb: torch.Tensor,
                    forward: Callable[[torch.Tensor], tuple],
                    zs: torch.Tensor, masks_bmp: torch.Tensor,
                    v_0: torch.Tensor, v_s: torch.Tensor, v_1: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of the classification loss (cross-entropy on the
    head's outputs) and of the Shapley loss with respect to the embedding
    output `emb`, by two `torch.autograd.grad` calls over one forward
    (`forward(emb)` -> (head outputs, attributions, ...)); the JAX
    package's two `jax.grad` calls each run the same forward."""
    emb = emb.detach().requires_grad_(True)
    with torch.enable_grad():
        out, attr, _ = forward(emb)
        loss_cls = cross_entropy_on_probs(out, zs)
        loss_exp = loss_shapley(masks_bmp, v_0, v_s, v_1, attr)
        g_cls, = torch.autograd.grad(loss_cls, emb, retain_graph=True)
        g_exp, = torch.autograd.grad(loss_exp, emb)
    return g_cls, g_exp


def grad_probe(cfg: DuoVanillaViTConfig, model, xs: torch.Tensor,
               mask: torch.Tensor, grand: torch.Tensor, null: torch.Tensor,
               zs: torch.Tensor, masks_bmp: torch.Tensor, v_0: torch.Tensor,
               v_s: torch.Tensor, v_1: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedding-output gradients <B, T, H> of the cross-entropy and of
    the Shapley loss (`:95-113`)."""
    xs, mask_full = vv.fw_xs_preprocess(xs, mask)
    with torch.no_grad():
        emb = vit_embeddings(model.vit.embeddings, cfg, xs)
    return dual_task_grads(
        emb, lambda e: duo_vit_explainer_from_emb(model, cfg, e, mask_full,
                                                  grand, null),
        zs, masks_bmp, v_0, v_s, v_1)


def trainable(cfg: DuoVanillaViTConfig,
              section: str) -> Callable[[str], bool]:
    """The classifier is frozen; every other section trains everything
    (`:116-119`)."""
    if section == "classifier":
        return lambda name: False
    return lambda name: True


MEASUREMENTS = ModelRecipe_Measurements(
    verify_final_coherency=False,
    allow_accuracy=True,
    allow_faithfulness=True,
    allow_cls_acc=True,
    allow_performance_cls=True,
    allow_performance_srg_exp=True,
    allow_performance_fin=True,
    allow_train_resources=True,
    allow_dual_task_similarity=ModelRecipe_Measurements_DualTaskSimilarity(
        allow=True, grad_probe=grad_probe),
    allow_branches_cka=True,
)
TRAINING = ModelRecipe_Training(
    support_classifier=True, support_surrogate=True, support_explainer=True,
    exp_variant_duo=True, exp_variant_kernel_shap=False)


def duo_vanilla_vit_recipe() -> ModelRecipe:
    return ModelRecipe(
        id="duo_vanilla_vit",
        version=RECIPE_VERSION,
        t_config=DuoVanillaViTConfig,
        n_players=vv.n_players,
        gen_input=vv.gen_input,
        gen_null=lambda cfg, misc=None: vv._np_null(cfg),
        training=TRAINING,
        fw_surrogate=vv.fw_surrogate,
        fw_explainer=fw_explainer,
        fw_final=fw_final,
        fw_surrogate_coalitions=vv.fw_surrogate_coalitions,
        trainable=trainable,
        init_classifier=init_vit_classifier,
        init_surrogate=init_vit_classifier,
        init_explainer=init_duo_vit_explainer,
        init_final=init_duo_vit_final,
        conv_pretrained_classifier=vv.conv_pretrained_classifier,
        conv_classifier_surrogate=vv.conv_classifier_surrogate,
        conv_surrogate_explainer=conv_surrogate_explainer,
        conv_explainer_final=conv_explainer_final,
        fw_classifier=vv.fw_classifier,
        measurements=MEASUREMENTS,
        fw_classifier_repr=vv.fw_classifier_repr,
        fw_explainer_repr=fw_explainer_repr,
    )
