"""Recipe: KernelSHAP BERT baseline (port of `autognothi_tpu/recipes/
kernel_shap_bert.py`).  The stages are the vanilla BERT's, but only the
explainer "trains" (k-means over the training rows, stored as
`Xs_train`); `fw_final` runs on the host (`fw_final_host=True`): the
classifier's probabilities, then per input row the WLS KernelSHAP
estimate (`ops/kernel_shap.py`) over every token column, the CLS column
dropped at the end.  Its model callback sweeps the composed rows through
the frozen classifier on the model's device, in fixed slabs of
CLASSIFIER_SLAB rows, on whichever arithmetic path the JAX gates pick
(fp32, W8A8 under AUTOGNOTHI_INT8=1, ...).  The background weights are
uniform (`:108`), not k-means' cluster sizes, and every call solves with
`seed=0`, as in the JAX recipe.  Only the faithfulness report runs.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .. import RECIPE_VERSION
from ..models.bert import bert_classifier_fwd, init_bert_classifier
from ..models.kernel_shap_bert import (KernelShapBertConfig,
                                       init_kernel_shap_explainer,
                                       init_kernel_shap_final)
from ..ops.kernel_shap import kernel_shap
from ..utils.functional import iter_fixed_batches
from ..utils.surgery import New, merge_param_dicts
from . import vanilla_bert as vb
from .types import (Flat, ModelRecipe, ModelRecipe_Measurements,
                    ModelRecipe_Training)

# rows per classifier call of the sweep (`iter_fixed_batches`, `:84-95`)
CLASSIFIER_SLAB = 64


def conv_surrogate_explainer(cfg: KernelShapBertConfig, _misc,
                             surrogate: Flat,
                             generator: torch.Generator) -> Flat:
    """Nothing of the surrogate: a zero `Xs_train` (`:41-45`)."""
    dst = init_kernel_shap_explainer(cfg, generator)
    return merge_param_dicts(({"{_}": None, New(): "Xs_train"}, surrogate),
                             into=dst)


def conv_explainer_final(cfg: KernelShapBertConfig, _misc, classifier: Flat,
                         _surrogate: Flat, explainer: Flat,
                         generator: torch.Generator,
                         device: torch.device) -> Flat:
    """The classifier under `classifier.` and the stored background
    (`:48-54`)."""
    dst = init_kernel_shap_final(cfg, generator)
    return merge_param_dicts(
        ({"{_}": "classifier.{_}"}, classifier),
        ({"Xs_train": "explainer.Xs_train"}, explainer),
        into=dst,
    )


def fw_explainer(cfg: KernelShapBertConfig, model, xs, mask, grand, null,
                 **kw):
    raise NotImplementedError("explainer model not available for KernelSHAP")


def classifier_on_rows(cfg: KernelShapBertConfig, classifier: torch.nn.Module
                       ) -> Callable[[np.ndarray], np.ndarray]:
    """-> fn(token rows <n, T>) -> probabilities <n, C> fp32 numpy: every
    token on, in fixed slabs of CLASSIFIER_SLAB rows (the last one padded
    with edge repeats) on the classifier's device, copied to the host
    once."""
    device = next(classifier.parameters()).device

    def fn(rows_np: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows_np, dtype=np.int64)
        outs = []
        with torch.no_grad():
            for (part,), real in iter_fixed_batches([rows], CLASSIFIER_SLAB):
                x = torch.from_numpy(part).to(device)
                probs, _ = bert_classifier_fwd(classifier, cfg, x,
                                               torch.ones_like(x),
                                               torch.zeros_like(x))
                outs.append(probs[:real])
        return torch.cat(outs).float().cpu().numpy()

    return fn


def fw_final(cfg: KernelShapBertConfig, model,
             xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host final (`:98-116`): ids <B, T> -> (probabilities <B, C>,
    attributions <B, C, T - 1>), both fp32 on xs's device."""
    fn = classifier_on_rows(cfg, model.classifier)
    rows = xs.cpu().numpy().astype(np.int64)
    probs = fn(rows)
    background = model.explainer.Xs_train.cpu().numpy().astype(np.int64)
    bg_weights = np.ones(background.shape[0])
    attrs = [kernel_shap(fn, background, bg_weights, row,
                         n_samples=cfg.kernel_shap_n_samples)[:, 1:]
             for row in rows]  # <C, T> each, the CLS column dropped
    return (torch.from_numpy(probs).to(xs.device),
            torch.from_numpy(np.stack(attrs).astype(np.float32)).to(
                xs.device))


MEASUREMENTS = ModelRecipe_Measurements(
    verify_final_coherency=False, allow_faithfulness=True)
TRAINING = ModelRecipe_Training(
    support_classifier=False, support_surrogate=False,
    support_explainer=True, exp_variant_duo=False,
    exp_variant_kernel_shap=True)


def kernel_shap_bert_recipe() -> ModelRecipe:
    return ModelRecipe(
        id="kernel_shap_bert",
        version=RECIPE_VERSION,
        t_config=KernelShapBertConfig,
        n_players=vb.n_players,
        gen_input=vb.gen_input,
        gen_null=vb.null_ids,
        training=TRAINING,
        fw_surrogate=vb.fw_surrogate,
        fw_explainer=fw_explainer,
        fw_final=fw_final,
        fw_final_host=True,
        fw_surrogate_coalitions=vb.fw_surrogate_coalitions,
        trainable=lambda cfg, section: (lambda name: False),
        load_misc=vb.load_misc,
        init_classifier=init_bert_classifier,
        init_surrogate=init_bert_classifier,
        init_explainer=init_kernel_shap_explainer,
        init_final=init_kernel_shap_final,
        conv_pretrained_classifier=vb.conv_pretrained_classifier,
        conv_classifier_surrogate=vb.conv_classifier_surrogate,
        conv_surrogate_explainer=conv_surrogate_explainer,
        conv_explainer_final=conv_explainer_final,
        fw_classifier=vb.fw_classifier,
        measurements=MEASUREMENTS,
    )
