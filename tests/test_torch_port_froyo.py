"""Port parity, the froyo towers of both families (the vanilla stages with
a frozen backbone and a single-trunk final): the final's init, the freeze
rules, the final's forward in each arithmetic, the final's conversion and
a mini `run_all` of a froyo ViT through the port's CLI, against the JAX
package on the same numpy inputs and parameters (the mini vanilla
experiments of tests/test_torch_port_vanilla.py, net kind "froyo_*";
its tolerances).  Also the point of the frozen trunk: in an explainer
train step no trunk op takes the autograd path (on the card, that path's
backward recomputes the op's plain version), only the explainer layers'.
"""

import numpy as np
import pytest
import torch

import jax
from autognothi_tpu.recipes import froyo_bert as j_fb
from autognothi_tpu.recipes import froyo_vit as j_fv
from autognothi_tpu_torch.kernels import primitives
from autognothi_tpu_torch.params import from_jax_params
from autognothi_tpu_torch.recipes import froyo_bert as p_fb
from autognothi_tpu_torch.recipes import froyo_vit as p_fv
from tests.test_torch_port_bert import int8_codes  # noqa: F401 (fixture)
from tests.test_torch_port_vanilla import (B, CPU, SETTINGS, TOL_FLIPPED,
                                           Family, _codes_agree, _env, _jp,
                                           _np, _within, bert_hparams,
                                           check_conv, run_all_and_check,
                                           stage_params, vit_hparams,
                                           write_exp)


def _froyo(hp: dict) -> dict:
    hp["net"]["kind"] = hp["net"]["kind"].replace("vanilla", "froyo")
    return hp


FAMILIES = {
    "vit": lambda: Family("froyo_vit", j_fv, p_fv, _froyo(vit_hparams())),
    "bert": lambda: Family("froyo_bert", j_fb, p_fb, _froyo(bert_hparams())),
}


def final_params(fam: Family, seed=4):
    flat = _np(fam.j_recipe.init_final(jax.random.PRNGKey(seed), fam.jcfg))
    flat["surrogate_null"] = np.linspace(
        0.1, 0.2, fam.jcfg.num_labels, dtype=np.float32)[None]
    return flat


@pytest.mark.parametrize("family", list(FAMILIES))
def test_final_init_matches_jax_layout(family):
    fam = FAMILIES[family]()
    want = final_params(fam)
    got = fam.p_recipe.init_final(fam.pcfg, torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    model = from_jax_params(want, fam.pcfg, CPU)
    assert type(model).__name__.startswith("Froyo")
    for section in ("classifier", "surrogate", "explainer"):
        assert type(from_jax_params(
            getattr(fam.p_recipe, f"init_{section}")(fam.pcfg,
                                                     torch.Generator()),
            fam.pcfg, CPU, section=section)).__name__.startswith(
                ("ViT", "Bert"))


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("section", ["classifier", "surrogate", "explainer",
                                     "final"])
def test_freeze_rules_match_jax(family, section):
    fam = FAMILIES[family]()
    names = list(getattr(fam.j_recipe, f"init_{section}")(
        jax.random.PRNGKey(0), fam.jcfg))
    jtrain = fam.j_recipe.trainable(fam.jcfg, section)
    train = fam.p_recipe.trainable(fam.pcfg, section)
    assert [train(k) for k in names] == [jtrain(k) for k in names]
    trunk = "bert." if fam.text else "vit."
    assert not any(train(k) for k in names if k.startswith(trunk))


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_final_forward_matches_jax(family, setting, int8_codes):
    fam = FAMILIES[family]()
    jax_env, port_env, tol = SETTINGS[setting]
    flat = final_params(fam)
    xs = fam.xs(np.random.RandomState(6))
    with _env(jax_env):
        want = fam.j_recipe.fw_final(fam.jcfg, _jp(flat),
                                     jax.numpy.asarray(xs))
    with _env(port_env), torch.no_grad():
        got = fam.p_recipe.fw_final(fam.pcfg,
                                    from_jax_params(flat, fam.pcfg, CPU),
                                    torch.from_numpy(xs))
    if setting == "mode2_int8" and not _codes_agree():
        tol = TOL_FLIPPED
    assert got[1].shape == (B, fam.pcfg.num_labels, fam.n_players())
    for i, (g, w) in enumerate(zip(got, want)):
        _within(g.numpy(), w, tol, f"final[{i}]")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_final_conversion_matches_jax(family):
    fam = FAMILIES[family]()
    cls, srg, exp, _, _ = stage_params(fam)
    with _env({"AUTOGNOTHI_PALLAS": "0"}):
        got = fam.p_recipe.conv_explainer_final(
            fam.pcfg, fam.p_misc(), cls, srg, exp,
            torch.Generator().manual_seed(0), CPU)
        want = _np(fam.j_recipe.conv_explainer_final(
            fam.jcfg, fam.j_misc(), _jp(cls), _jp(srg), _jp(exp),
            jax.random.PRNGKey(1)))
    np.testing.assert_allclose(got.pop("surrogate_null"),
                               want.pop("surrogate_null"), atol=1e-6)
    check_conv(got, want, ())
    np.testing.assert_array_equal(got["srg_classifier.weight"],
                                  srg["classifier.weight"])


def _grad_calls(monkeypatch):
    """Records, per op, the calls that took the autograd path: on the card
    each runs the kernel forward and recomputes the plain version in its
    backward (`primitives._KernelFn`, counted by `RECOMPUTES`)."""
    from autognothi_tpu_torch.ops import attention_block, head_block
    from autognothi_tpu_torch.ops import mlp_block

    calls = {}

    def spy(launch, plain, counter, tensors, static, grad=None):
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            calls[counter.name] = calls.get(counter.name, 0) + 1
        return primitives.dispatch(launch, plain, counter, tensors, static,
                                   grad)

    for mod in (attention_block, mlp_block, head_block):
        monkeypatch.setattr(mod, "dispatch", spy)
    return calls


@pytest.mark.parametrize("kind", ["froyo_vit", "vanilla_vit"])
def test_explainer_step_differentiates_no_frozen_trunk_op(kind, monkeypatch):
    """One explainer train step (pallas mode "2", fused ops): froyo's
    trunk takes no op through the autograd path, only its explainer layer
    does (1 attention block, 1 MLP block); the vanilla explainer's trunk
    trains, so its 2 trunk layers do too."""
    from autognothi_tpu_torch.parallel.train_step import \
        make_explainer_train_step
    from autognothi_tpu_torch.pipeline.training import AdamW
    from tests.test_torch_port_vanilla import FAMILIES as VANILLA

    fam = FAMILIES["vit"]() if kind == "froyo_vit" else VANILLA["vit"]()
    _, srg, exp, _, null = stage_params(fam)
    calls = _grad_calls(monkeypatch)
    pr, pc = fam.p_recipe, fam.pcfg
    with _env({}):
        srg_model = from_jax_params(srg, pc, CPU, section="surrogate")
        model = from_jax_params(exp, pc, CPU, section="explainer")
        trainable = pr.trainable(pc, "explainer")
        for name, p in model.named_parameters():
            p.requires_grad_(trainable(name))
        opt = AdamW(dict(model.named_parameters()), trainable)
        step = make_explainer_train_step(pr, pc, fam.n_players(), 2)
        before = {k: v.detach().clone() for k, v in model.state_dict().items()}
        loss = step(model, opt, srg_model, torch.from_numpy(null),
                    torch.from_numpy(fam.xs(np.random.RandomState(2))),
                    torch.Generator().manual_seed(0), 1e-3,
                    {k: 1.0 for k, _ in model.named_parameters()}, None)
    assert torch.isfinite(loss)
    layers = 1 if kind == "froyo_vit" else 1 + pc.num_hidden_layers
    assert calls == {"attention_block": layers, "mlp_block": layers}
    after = model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert moved and all(trainable(k) for k in moved)
    if kind == "froyo_vit":
        assert not any(k.startswith("vit.") for k in moved)


def test_run_all_cli_on_the_cpu(tmp_path):
    fam = FAMILIES["vit"]()
    exp = write_exp(tmp_path, "froyo_vit", fam.hparams)
    run_all_and_check(fam, exp)
    # the frozen trunk: every stage holds the classifier's `vit.` weights
    cls = np.load(exp / "classifier-epoch-1.ckpt")
    for stage in ("surrogate-epoch-1", "explainer-epoch-2"):
        other = np.load(exp / f"{stage}.ckpt")
        for k in cls.files:
            if k.startswith("vit."):
                np.testing.assert_array_equal(cls[k], other[k],
                                              err_msg=f"{stage} {k}")
