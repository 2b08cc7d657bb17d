"""Fine-tune a base model and export it to the zoo store (port of
`autognothi_tpu/pipeline/pretrain_classifier.py`).

    python -m autognothi_tpu_torch pretrain_classifier <experiment_dir> \\
        --device cuda

For the vanilla ViT and vanilla BERT only: the classifier is converted
from the experiment's base model where it has no checkpoint yet, trained
with every parameter unfrozen for its epochs, then written to the store
as the `ft_<experiment dir name>` base (`zoo/loader.py:save_local_ft`:
`params.npz`, the tokenizer's `tokenizer/`, and `model.json`, the model
config as the JAX package writes it).  A later experiment names it as
its `base_model`; either package loads it.
"""

from __future__ import annotations

import json

from ..zoo.loader import save_local_ft
from .env import ExpEnv
from .reports import to_json
from .resources import get_recipe, latest_epoch, load_epoch_params, load_misc
from .train_all import conv_pretrained_classifier
from .train_classifier import train_classifier


def pretrain_classifier(env: ExpEnv, device: str = "cuda") -> None:
    env.log("[[[ fine-tune pretrained model ]]]")
    config = env.config
    recipe, m_config = get_recipe(config)
    if not recipe.training.support_classifier:
        raise ValueError("cannot fine-tune model: classification not "
                         "supported")
    if config.net.kind not in ("vanilla_bert", "vanilla_vit"):
        raise ValueError(f"unsupported model kind: {config.net.kind}")

    epochs = config.train_classifier.epochs
    epoch_cls = latest_epoch(env.model_path, "classifier", epochs)
    if epoch_cls is None:
        env.log(":: initializing ft model")
        conv_pretrained_classifier(env, device)
        epoch_cls = 0
    if epoch_cls < epochs:
        env.log(f":: training ft model from epoch {epoch_cls}")
        train_classifier(env, device=device, unfreeze_all=True)

    m_misc = load_misc(env, recipe, m_config)
    epoch_cls, cls_params = load_epoch_params(env, "classifier")
    if epoch_cls < epochs:
        raise ValueError("classifier not fully trained")

    dest = save_local_ft(env.model_path.name, cls_params,
                         getattr(m_misc, "tokenizer", None))
    with open(dest / "model.json", "w", encoding="utf-8") as f:
        f.write(json.dumps(to_json(m_config), indent=2))
    env.log(f"[[[ fine-tuning complete -> {dest} ]]]")
