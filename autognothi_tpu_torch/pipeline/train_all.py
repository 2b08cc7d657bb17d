"""The seven-stage training pipeline (port of `autognothi_tpu/pipeline/
train_all.py` for one device), resumable by stage detection, ending in the
final-coherency check.

    python -m autognothi_tpu_torch train_all <experiment_dir> --device cuda

Stages: 0) base model -> classifier-epoch-0, 1) train the classifier,
2) -> surrogate-epoch-0, 3) train the surrogate, 4) -> explainer-epoch-0,
5) train the explainer, 6) -> final-epoch-0, written only after the final
reproduces the classifier's and the explainer's outputs on the null input
within COHERENCY_EPS.  The conversions are surgery on flat numpy dicts on
the host (`recipes/*.py:conv_*`); the JAX package runs the whole of them
and the check on the host, the port runs their tensor math (the
surrogate's null forward of `conv_explainer_final`, the check's five
forwards) on `device`.  Each conversion draws its new parameters from a
generator seeded with `derive_seed(seed, "<conversion name>")`.
"""

from __future__ import annotations

import torch

from ..params import from_jax_params
from ..utils.devices import resolve_device
from ..utils.seeding import iterative_generator
from .config import Config_Train
from .env import ExpEnv
from .resources import (get_recipe, latest_epoch, load_epoch_params,
                        load_misc, save_epoch_ckpt)
from .train_classifier import train_classifier
from .train_explainer import train_explainer
from .train_surrogate import train_surrogate

_STAGE0_TRAIN_CFG = Config_Train(epochs=0, ckpt_when="_:%1==0", lr=0.0,
                                 batch_size=1)

COHERENCY_EPS = 1e-5


def detect_stage(env: ExpEnv) -> int:
    """The first stage still to run, from the checkpoints present
    (existence probes only; the JAX package's rule, `:36-54`)."""
    config, path = env.config, env.model_path
    if latest_epoch(path, "final", 0) is not None:
        return 7
    epoch_exp = latest_epoch(path, "explainer", config.train_explainer.epochs)
    if epoch_exp is not None:
        return 6 if epoch_exp == config.train_explainer.epochs else 5
    epoch_srg = latest_epoch(path, "surrogate", config.train_surrogate.epochs)
    if epoch_srg is not None:
        return 4 if epoch_srg == config.train_surrogate.epochs else 3
    epoch_cls = latest_epoch(path, "classifier", 0)
    if epoch_cls is not None:
        return 2 if epoch_cls == config.train_classifier.epochs else 1
    return 0


def train_all(env: ExpEnv, device: str = "cuda") -> None:
    stage = detect_stage(env)
    env.log(f"[[[ current stage: {stage} / 7 ]]]")
    if stage < 1:
        conv_pretrained_classifier(env, device)
    if stage < 2:
        with env.fork(lambda ec: ec.logger_classifier) as cl_env:
            train_classifier(cl_env, device=device)
    if stage < 3:
        conv_classifier_surrogate(env, device)
    if stage < 4:
        with env.fork(lambda ec: ec.logger_surrogate) as sg_env:
            train_surrogate(sg_env, device=device)
    if stage < 5:
        conv_surrogate_explainer(env, device)
    if stage < 6:
        with env.fork(lambda ec: ec.logger_explainer) as ex_env:
            train_explainer(ex_env, device=device)
    if stage < 7:
        conv_explainer_final(env, device)
    env.log("[[[ all stages ok ]]]")


def _load_trained(env: ExpEnv, section: str):
    """-> (epoch, flat params) of the newest checkpoint, which must have
    finished its stage's training."""
    epoch, params = load_epoch_params(env, section)
    if epoch < getattr(env.config, f"train_{section}").epochs:
        raise ValueError(f"under-trained {section}")
    return epoch, params


def conv_pretrained_classifier(env: ExpEnv, device: str = "cuda") -> None:
    from ..zoo.loader import load_params

    resolve_device(device)
    env.log("[[[ loading base params... ]]]")
    config = env.config
    recipe, m_config = get_recipe(config)
    bundle, tokenizer = load_params(config.net.base_model,
                                    num_labels=m_config.num_labels)
    env.log("[[[ converting base -> classifier {0}... ]]]")
    gen = iterative_generator(config.seed, "conv_pretrained_classifier")
    if bundle is None:  # random_init
        params = recipe.init_classifier(m_config, gen)
    else:
        params = recipe.conv_pretrained_classifier(m_config, bundle, gen)
    save_epoch_ckpt(env.model_path, "classifier", _STAGE0_TRAIN_CFG, 0,
                    params)
    if tokenizer is not None:
        env.log("[[[ converting base tokenizer... ]]]")
        tokenizer.save(env.model_path / "tokenizer")
    else:
        env.log("[[[ skipped base misc ]]]")
    env.log("[[[ convert base -> classifier {0} ok ]]]")


def conv_classifier_surrogate(env: ExpEnv, device: str = "cuda") -> None:
    resolve_device(device)
    env.log("[[[ loading classifier params... ]]]")
    config = env.config
    recipe, m_config = get_recipe(config)
    epoch_cls, cls_params = _load_trained(env, "classifier")
    env.log(f"[[[ converting classifier {epoch_cls} -> surrogate 0... ]]]")
    gen = iterative_generator(config.seed, "conv_classifier_surrogate")
    params = recipe.conv_classifier_surrogate(
        m_config, load_misc(env, recipe, m_config), cls_params, gen)
    save_epoch_ckpt(env.model_path, "surrogate", config.train_surrogate, 0,
                    params)
    env.log(f"[[[ convert classifier {epoch_cls} -> surrogate 0 ok ]]]")


def conv_surrogate_explainer(env: ExpEnv, device: str = "cuda") -> None:
    resolve_device(device)
    env.log("[[[ loading surrogate params... ]]]")
    config = env.config
    recipe, m_config = get_recipe(config)
    epoch_srg, srg_params = _load_trained(env, "surrogate")
    env.log(f"[[[ converting surrogate {epoch_srg} -> explainer 0... ]]]")
    gen = iterative_generator(config.seed, "conv_surrogate_explainer")
    params = recipe.conv_surrogate_explainer(
        m_config, load_misc(env, recipe, m_config), srg_params, gen)
    save_epoch_ckpt(env.model_path, "explainer", config.train_explainer, 0,
                    params)
    env.log(f"[[[ convert surrogate {epoch_srg} -> explainer 0 ok ]]]")


def conv_explainer_final(env: ExpEnv, device: str = "cuda") -> None:
    dev = resolve_device(device)
    env.log("[[[ loading all params... ]]]")
    config = env.config
    recipe, m_config = get_recipe(config)
    _, cls_params = _load_trained(env, "classifier")
    _, srg_params = _load_trained(env, "surrogate")
    _, exp_params = _load_trained(env, "explainer")
    env.log("[[[ converting models -> final 0... ]]]")
    gen = iterative_generator(config.seed, "conv_explainer_final")
    final_params = recipe.conv_explainer_final(
        m_config, load_misc(env, recipe, m_config), cls_params, srg_params,
        exp_params, gen, dev)
    if not verify_final_coherency(env, final_params, cls_params, srg_params,
                                  exp_params, dev):
        raise ValueError("cannot save final model due to non-coherency")
    save_epoch_ckpt(env.model_path, "final", _STAGE0_TRAIN_CFG, 0,
                    final_params)
    env.log("[[[ convert models -> final 0 ok ]]]")


def verify_final_coherency(env: ExpEnv, final_params, cls_params, srg_params,
                           exp_params, device: torch.device) -> bool:
    """The merged final reproduces the classifier's trunk probabilities and
    the explainer's attributions on the null input within COHERENCY_EPS
    (`:166-205`), its forwards run on `device`; raises ValueError where it
    does not."""
    env.log("[[[ verifying final model coherency... ]]]")
    recipe, m_config = get_recipe(env.config)
    if not recipe.measurements.verify_final_coherency:
        env.log("[[[ skipped: net recipe does not support this ]]]")
        return True
    env.log("judging...")

    def model(params, section):
        return from_jax_params(params, m_config, device, section=section)

    nil_xs = torch.from_numpy(recipe.gen_null(
        m_config, load_misc(env, recipe, m_config))).to(device)
    nil_mask = torch.ones((1, recipe.n_players(m_config)), dtype=torch.int32,
                          device=device)
    with torch.no_grad():
        _, cls_ref = recipe.fw_classifier(
            m_config, model(cls_params, "classifier"), nil_xs, nil_mask)
        srg_ref, _ = recipe.fw_surrogate(
            m_config, model(srg_params, "surrogate"), nil_xs, nil_mask)
        exp_ref, _ = recipe.fw_explainer(
            m_config, model(exp_params, "explainer"), nil_xs, nil_mask,
            srg_ref, srg_ref)
        cls_out, exp_out = recipe.fw_final(
            m_config, model(final_params, "final"), nil_xs)
    cls_diff = (cls_ref - cls_out).abs().max().item()
    exp_diff = (exp_ref - exp_out).abs().max().item()
    env.log(f"cls_diff: {cls_diff}, exp_diff: {exp_diff}")
    if not (cls_diff <= COHERENCY_EPS and exp_diff <= COHERENCY_EPS):  # NaN too
        env.log("[[[ !!! final is not coherent !!! ]]]")
        raise ValueError("final model is not coherent")
    env.log("[[[ verified final model is coherent ]]]")
    return True
