"""The per-architecture recipe contract (the ported subset of
`autognothi_tpu/recipes/types.py:ModelRecipe`): the interface the pipeline
uses to touch models.  A model is an `nn.Module` whose state-dict keys are
the JAX flat parameter names; the inits and conversions work on flat dicts
of numpy arrays on the host, and draw the parameters they make anew
(`New()`) from a `torch.Generator`."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Type

import numpy as np
import torch

Model = torch.nn.Module
Flat = Dict[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class ModelRecipe_Training:
    support_classifier: bool
    support_surrogate: bool
    support_explainer: bool
    exp_variant_duo: bool
    exp_variant_kernel_shap: bool


@dataclasses.dataclass(frozen=True)
class ModelRecipe_Measurements:
    """Whether `train_all` checks the final's coherency, and which reports
    `measure_all` runs (`autognothi_tpu/recipes/types.py:59-70`).
    `allow_dual_task_similarity` is False or, in the JAX package, the duo
    recipes' gradient probe; the port's recipes set it False."""
    verify_final_coherency: bool
    allow_accuracy: bool = False
    allow_faithfulness: bool = False
    allow_cls_acc: bool = False
    allow_performance_cls: bool = False
    allow_performance_srg_exp: bool = False
    allow_performance_fin: bool = False
    allow_train_resources: bool = False
    allow_dual_task_similarity: Any = False
    allow_branches_cka: bool = False


@dataclasses.dataclass(frozen=True)
class ModelRecipe:
    id: str
    version: str
    t_config: Type[Any]  # the model's config dataclass
    n_players: Callable[[Any], int]
    # (cfg, misc) -> callable(raw_xs, raw_ys) -> (np Xs, np Ys)
    gen_input: Callable[[Any, Any], Callable[..., Tuple[np.ndarray,
                                                        np.ndarray]]]
    # (cfg, misc) -> np Xs <1, ...>, the null input
    gen_null: Callable[[Any, Any], np.ndarray]
    training: ModelRecipe_Training
    # (cfg, model, xs, mask <B, P>, **kw) -> (Ys, extra)
    fw_surrogate: Callable[..., Tuple[torch.Tensor, Any]]
    # (cfg, model, xs, mask <B, P>, grand, null, **kw) -> (shap, extra)
    fw_explainer: Callable[..., Tuple[torch.Tensor, Any]]
    # (cfg, model, xs) -> (class probabilities, attributions)
    fw_final: Callable[[Any, Model, torch.Tensor],
                       Tuple[torch.Tensor, torch.Tensor]]
    # (cfg, model, xs, masks <B, M, P>) -> <B, M, n_classes>; None ->
    # replicate the inputs along the coalition axis
    fw_surrogate_coalitions: Optional[Callable[..., torch.Tensor]]
    # (cfg, section) -> name -> bool: which parameters a section trains
    trainable: Callable[[Any, str], Callable[[str], bool]]
    # LTT progressive training: (cfg, section, unfrozen) -> name filter
    progressive_trainable: Optional[
        Callable[[Any, str, int], Callable[[str], bool]]] = None
    # (experiment dir, cfg) -> the `misc` the data adapters take (the BERT
    # tokenizer); None -> misc is None
    load_misc: Optional[Callable[[Any, Any], Any]] = None
    # the training stages; None where the recipe does not train yet.
    # fresh layouts :: (cfg, generator) -> Flat
    init_classifier: Optional[Callable[[Any, torch.Generator], Flat]] = None
    init_surrogate: Optional[Callable[[Any, torch.Generator], Flat]] = None
    init_explainer: Optional[Callable[[Any, torch.Generator], Flat]] = None
    init_final: Optional[Callable[[Any, torch.Generator], Flat]] = None
    # the conversion chain; `generator` draws the New() parameters:
    #   (cfg, bundle, generator) -> Flat
    conv_pretrained_classifier: Optional[Callable[..., Flat]] = None
    #   (cfg, misc, classifier, generator) -> Flat
    conv_classifier_surrogate: Optional[Callable[..., Flat]] = None
    #   (cfg, misc, surrogate, generator) -> Flat
    conv_surrogate_explainer: Optional[Callable[..., Flat]] = None
    #   (cfg, misc, classifier, surrogate, explainer, generator, device)
    #   -> Flat; `device` runs its surrogate forward of the null input
    conv_explainer_final: Optional[Callable[..., Flat]] = None
    # (cfg, model, xs, mask <B, P>, **kw) -> (side probabilities, trunk
    # probabilities)
    fw_classifier: Optional[Callable[..., Tuple[torch.Tensor,
                                                torch.Tensor]]] = None
    measurements: Optional[ModelRecipe_Measurements] = None
    # representation observers (the CKA report):
    # (cfg, model, xs, mask[, grand, null]) -> (out, hidden <B, T, H>)
    fw_classifier_repr: Optional[Callable[..., Tuple[torch.Tensor,
                                                     torch.Tensor]]] = None
    fw_explainer_repr: Optional[Callable[..., Tuple[torch.Tensor,
                                                    torch.Tensor]]] = None


def surrogate_coalition_values(recipe: ModelRecipe, m_config: Any,
                               srg_model: Model, xs: torch.Tensor,
                               masks_bmp: torch.Tensor) -> torch.Tensor:
    """<B, M, P> coalition masks -> <B*M, C> masked surrogate values: the
    recipe's embed-once `fw_surrogate_coalitions` where it has one, else
    the inputs replicated along the coalition axis (`:142-162`)."""
    b, m, p = masks_bmp.shape
    if recipe.fw_surrogate_coalitions is not None:
        v_s = recipe.fw_surrogate_coalitions(m_config, srg_model, xs,
                                             masks_bmp)
        return v_s.reshape(b * m, -1)
    v_s, _ = recipe.fw_surrogate(m_config, srg_model,
                                 xs.repeat_interleave(m, dim=0),
                                 masks_bmp.reshape(b * m, p))
    return v_s
