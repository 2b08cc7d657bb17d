"""Port parity, LTT BERT training and reports: the inits and freeze rules,
the recipe's forwards, the four conversions, one classifier, surrogate and
explainer train step, the text loaders, `train_all` and `run_all` through
`python -m autognothi_tpu_torch`, one trainer epoch and `measure_all`,
against the JAX package on the same numpy inputs and parameters (a mini
LTT BERT as in tests/test_ltt_e2e.py: hidden 32, 2 layers, 4 heads, side
16, T = 16, 15 players, dropout 0, on the bundled `nlp_samples`).  The
JAX kernels run in interpret mode; parameters cross over with
`params.from_jax_params`.

Tolerances, x max(1, max|ref|), those of tests/test_torch_port_bert.py:
1e-5 fp32 against the XLA math (mode "0"), 1e-4 against the interpreted
kernels (modes "2" and "1"), int8 2e-5, or 1e-2 where a per-token int8
code differs between the packages (the `int8_codes` recorder).  The train
steps hold the loss (relative), each trainable gradient (within tol x the
largest) and the updated parameters as tests/test_torch_port_stages.py
does; a gradient below 1e-4 of the largest is 0 by structure (a key bias
adds a per-query constant the softmax ignores; the explainer head's last
bias a per-class constant the efficiency normalisation removes) and both
packages' values are held below that instead.  Coalition masks are drawn
once with numpy and handed to both packages.  The JAX `train_all` runs
once for the module (`jax_trained`); each package measures its own copy
of that experiment (`measured`), the port on the CPU.
"""

import contextlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autognothi_tpu.data import loader as j_loader
from autognothi_tpu.data import tokenizer as j_tok
from autognothi_tpu.models import bert as j_bert
from autognothi_tpu.models import ltt_bert as j_ltt
from autognothi_tpu.models.common import quant_override as jax_quant_override
from autognothi_tpu.ops.shapley import \
    loss_logits_kl_divergence as jax_kl
from autognothi_tpu.ops import shapley as jax_shapley
from autognothi_tpu.parallel.train_step import _make_teacher
from autognothi_tpu.parallel.train_step import \
    make_explainer_train_step as jax_make_explainer_step
from autognothi_tpu.pipeline import training as jax_training
from autognothi_tpu.recipes import ltt_bert as j_rec
from autognothi_tpu_torch.data import loader as p_loader
from autognothi_tpu_torch.data import tokenizer as p_tok
from autognothi_tpu_torch.models.ltt_bert import (LttBert,
                                                  ltt_bert_progressive,
                                                  ltt_bert_trainable)
from autognothi_tpu_torch.parallel.train_step import make_explainer_train_step
from autognothi_tpu_torch.params import from_jax_params
from autognothi_tpu_torch.pipeline.train_classifier import classifier_loss
from autognothi_tpu_torch.pipeline.train_surrogate import (surrogate_loss,
                                                           surrogate_teacher)
from autognothi_tpu_torch.pipeline.training import AdamW, make_train_step
from autognothi_tpu_torch.recipes import ltt_bert as p_rec
from autognothi_tpu_torch.recipes import vanilla_bert as p_vb
from tests.test_bert_e2e import make_bert_hparams
from tests.test_torch_port_bert import _recorded_codes
from tests.test_torch_port_bert import int8_codes  # noqa: F401 (fixture)
from tests.test_torch_port_reports import (NAMES, _clean_env, _close,
                                           _report, _shared_masks)

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
B, M, LR = 4, 2, 1e-3
TOL_FP32, TOL_INTERPRET, TOL_INT8, TOL_FLIPPED = 1e-5, 1e-4, 2e-5, 1e-2
ENV_KEYS = ("AUTOGNOTHI_PALLAS", "AUTOGNOTHI_PALLAS_INTERPRET",
            "AUTOGNOTHI_INT8", "AUTOGNOTHI_INT8_TEACHER",
            "AUTOGNOTHI_CKPT_OPT", "AUTOGNOTHI_PROFILE_DIR")
TRUNK = ("bert.embeddings.", "bert.encoder.layers.", "bert_pooler.",
         "classifier.")
INTERPRET = {"AUTOGNOTHI_PALLAS_INTERPRET": "1"}
# (JAX env, port env, fp32 tolerance) of each arithmetic
SETTINGS = {
    "mode0": ({"AUTOGNOTHI_PALLAS": "0"}, {"AUTOGNOTHI_PALLAS": "0"},
              TOL_FP32),
    "mode2": ({"AUTOGNOTHI_PALLAS": "2", **INTERPRET}, {}, TOL_INTERPRET),
    "mode2_int8": ({"AUTOGNOTHI_PALLAS": "2", "AUTOGNOTHI_INT8": "1",
                    **INTERPRET}, {"AUTOGNOTHI_INT8": "1"}, TOL_INT8),
    "mode1": ({"AUTOGNOTHI_PALLAS": "1", **INTERPRET},
              {"AUTOGNOTHI_PALLAS": "1"}, TOL_INTERPRET),
}


def _corpus():
    return [s["inputs"] for s in json.loads(
        (REPO / "autognothi_tpu_torch/data/nlp_samples.json").read_text())]


VOCAB = p_tok.build_vocab(_corpus(), max_size=400)


def ltt_bert_hparams() -> dict:
    """The mini LTT BERT experiment of tests/test_ltt_e2e.py, with one
    classifier epoch, a progressive surrogate of two, and every eval
    block."""
    hp = make_bert_hparams(len(VOCAB))
    hp["net"]["kind"] = "ltt_bert"
    params = hp["net"]["params"]
    params.pop("explainer_attn_num_layers")
    params.pop("explainer_head_hidden_size")
    params.update(explainer_s_attn_num_layers=1,
                  explainer_s_head_hidden_size=16, s_attn_hidden_size=16,
                  s_attn_intermediate_size=32)
    hp["train_classifier"]["epochs"] = 1
    hp["train_surrogate"].update(epochs=2,
                                 EXPERIMENTAL_progressive_training=True)
    hp["eval_branches_cka"] = {"dataset": None, "batch_size": 8}
    return hp


MINI = ltt_bert_hparams()["net"]["params"]
T = MINI["max_position_embeddings"]
P = T - 1


@contextlib.contextmanager
def _env(values):
    saved = {k: os.environ.pop(k) for k in ENV_KEYS if k in os.environ}
    try:
        with mock.patch.dict(os.environ, values):
            yield
    finally:
        os.environ.update(saved)


def _np(p):
    return {k: np.asarray(v) for k, v in p.items()}


def _jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _cfgs():
    return j_ltt.LttBertConfig(**MINI), \
        p_rec.ltt_bert_recipe().t_config(**MINI)


def _ids(rng, b=B):
    ids = rng.randint(5, len(VOCAB), (b, T)).astype(np.int64)
    ids[:, 0] = VOCAB.index("[CLS]")
    return ids


def _within(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _codes_agree() -> bool:
    """Whether every per-token int8 code row one package computed is one
    the other computed too (as sets: a JAX step runs its teacher twice)."""
    port, jax_ = _recorded_codes()
    rows = [{r.tobytes() for c in codes for r in c} for codes in (port,
                                                                 jax_)]
    return rows[0] == rows[1]


# ------------------------------------------------- inits and freeze rules


def _law(name, got, want, layout):
    """A parameter drawn anew: its shape, and the JAX init's law -
    LayerNorms exactly ones / zeros; embedding tables N(0, 1) with the
    padding row of the word table zero; every linear weight and bias
    U(+-1/sqrt(fan_in)), fan_in read from its weight in `layout`.  A
    tensor of 256 values or more also has the law's standard deviation
    (within 10%) and mean (within 4 standard errors)."""
    assert got.shape == want.shape, name
    if ".LayerNorm." in name:
        ref = np.ones_like(want) if name.endswith(".weight") \
            else np.zeros_like(want)
        np.testing.assert_array_equal(got, ref, err_msg=name)
        np.testing.assert_array_equal(want, ref, err_msg=name)
        return
    if name.endswith("_embeddings.weight"):
        bound, std = np.inf, 1.0
        if "word_" in name:
            for x in (got, want):
                assert not x[MINI["pad_token_id"]].any(), name
    else:
        fan_in = layout[name.rsplit(".", 1)[0] + ".weight"].shape[1]
        bound = 1.0 / np.sqrt(fan_in)
        std = bound / np.sqrt(3.0)
    for x in (got, want):
        assert np.abs(x).max() <= bound, name
        if x.size >= 256:
            assert abs(x.std() - std) <= 0.1 * std, name
            assert abs(x.mean()) <= 4 * std / np.sqrt(x.size), name


def test_inits_match_jax_layouts_and_laws():
    cfg, pcfg = _cfgs()
    recipe = p_rec.ltt_bert_recipe()
    for port_init, jax_init in (
            (recipe.init_classifier, j_rec.ltt_bert_recipe().init_classifier),
            (recipe.init_surrogate, j_ltt.init_ltt_bert_surrogate),
            (recipe.init_explainer, j_ltt.init_ltt_bert_explainer),
            (recipe.init_final, j_ltt.init_ltt_bert_final)):
        got = port_init(pcfg, torch.Generator().manual_seed(0))
        want = _np(jax_init(jax.random.PRNGKey(0), cfg))
        assert set(got) == set(want)
        for k in want:
            if k == "surrogate_null":
                np.testing.assert_array_equal(got[k], want[k])
            else:
                _law(k, got[k], want[k], want)


@pytest.mark.parametrize("section", ["classifier", "surrogate", "explainer",
                                     "final"])
def test_freeze_rules_match_jax_over_every_full_width_name(section):
    """`ltt_bert_trainable` and `ltt_bert_progressive` against JAX's over
    every parameter name of the BERT-base@512 section (shapes only: the
    JAX init under `jax.eval_shape`, the port's module on the meta
    device)."""
    params = json.loads((REPO / "experiments" / "bert_base_tayp_ltt"
                         / ".hparams.json").read_text())["net"]["params"]
    cfg = j_ltt.LttBertConfig(**params)
    pcfg = p_rec.ltt_bert_recipe().t_config(**params)
    init = {"classifier": j_ltt.init_ltt_bert_surrogate,
            "surrogate": j_ltt.init_ltt_bert_surrogate,
            "explainer": j_ltt.init_ltt_bert_explainer,
            "final": j_ltt.init_ltt_bert_final}[section]
    want = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))
    with torch.device("meta"):
        got = LttBert(pcfg, section).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    names = sorted(want)
    for unfrozen in range(0, params["num_hidden_layers"] + 1):
        keep = ltt_bert_progressive(pcfg, section, unfrozen)
        jkeep = j_ltt.ltt_bert_progressive(cfg, section, unfrozen)
        assert [keep(k) for k in names] == [jkeep(k) for k in names]
    train = ltt_bert_trainable(pcfg, section)
    jtrain = j_ltt.ltt_bert_trainable(cfg, section)
    assert [train(k) for k in names] == [jtrain(k) for k in names]
    assert any(train(k) for k in names) and not all(train(k) for k in names)


# -------------------------------------------------------------- forwards


def _stage_params(seed=21, share=True):
    cfg, _ = _cfgs()
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    cls = _np(j_ltt.init_ltt_bert_surrogate(keys[0], cfg))
    srg = _np(j_ltt.init_ltt_bert_surrogate(keys[1], cfg))
    exp = _np(j_ltt.init_ltt_bert_explainer(keys[2], cfg))
    # the explainer shares the surrogate's trunk and trained ladder, as the
    # conversion surrogate -> explainer does
    for k in exp if share else ():
        if k.startswith(("bert.", "bert_pooler.", "classifier.")):
            exp[k] = srg[k]
    return cls, srg, exp


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_forwards_match_jax(setting, int8_codes):
    """fw_surrogate (every layer and `ltt_active_layers` = 1),
    fw_classifier_repr, fw_explainer and fw_explainer_repr on random player
    masks, and fw_surrogate_coalitions on <B, M, P> masks."""
    jax_env, port_env, tol = SETTINGS[setting]
    cfg, pcfg = _cfgs()
    _, srg, exp = _stage_params()
    rng = np.random.RandomState(5)
    ids = _ids(rng)
    mask = (rng.rand(B, P) > rng.rand(B, 1)).astype(np.int32)
    masks = (rng.rand(B, 3, P) > 0.5).astype(np.int32)
    null = np.asarray([[0.3, 0.7]], np.float32)
    with _env(jax_env):
        js, jp = _jp(srg), _jp(exp)
        ji, jm = jnp.asarray(ids), jnp.asarray(mask)
        want = {"srg": j_rec.fw_surrogate(cfg, js, ji, jm),
                "srg1": j_rec.fw_surrogate(cfg, js, ji, jm,
                                           ltt_active_layers=jnp.int32(1)),
                "cls_repr": j_rec.fw_classifier_repr(cfg, js, ji, jm),
                "coal": j_rec.fw_surrogate_coalitions(cfg, js, ji,
                                                      jnp.asarray(masks))}
        grand = want["srg"][0]
        want["exp"] = j_rec.fw_explainer(cfg, jp, ji, jm, grand,
                                         jnp.asarray(null))
        want["exp_repr"] = j_rec.fw_explainer_repr(cfg, jp, ji, jm, grand,
                                                   jnp.asarray(null))
    t = torch.from_numpy
    with _env(port_env), torch.no_grad():
        ps = from_jax_params(srg, pcfg, CPU, section="surrogate")
        pe = from_jax_params(exp, pcfg, CPU, section="explainer")
        got = {"srg": p_rec.fw_surrogate(pcfg, ps, t(ids), t(mask)),
               "srg1": p_rec.fw_surrogate(pcfg, ps, t(ids), t(mask),
                                          ltt_active_layers=1),
               "cls_repr": p_rec.fw_classifier_repr(pcfg, ps, t(ids),
                                                    t(mask)),
               "coal": p_rec.fw_surrogate_coalitions(pcfg, ps, t(ids),
                                                     t(masks)),
               "exp": p_rec.fw_explainer(pcfg, pe, t(ids), t(mask),
                                         t(np.array(grand)), t(null)),
               "exp_repr": p_rec.fw_explainer_repr(
                   pcfg, pe, t(ids), t(mask), t(np.array(grand)),
                   t(null))}
    if setting == "mode2_int8" and not _codes_agree():
        tol = TOL_FLIPPED
    assert got["coal"].shape == (B, 3, MINI["num_labels"])
    assert got["exp"][0].shape == (B, MINI["num_labels"], P)
    assert got["cls_repr"][1].shape == (B, T, MINI["hidden_size"])
    assert got["exp_repr"][1].shape == (B, T, MINI["s_attn_hidden_size"])
    for name in want:
        w = want[name] if isinstance(want[name], tuple) else (want[name],)
        g = got[name] if isinstance(got[name], tuple) else (got[name],)
        for i, (gi, wi) in enumerate(zip(g, w)):
            _within(gi.numpy(), wi, tol, f"{name}[{i}]")
    # ladder layers past the first change the side branch
    assert not np.allclose(got["srg"][0].numpy(), got["srg1"][0].numpy())


def test_coalition_forward_refuses_dropout():
    _, pcfg = _cfgs()
    _, srg, _ = _stage_params()
    model = from_jax_params(srg, pcfg, CPU, section="surrogate")
    ids = torch.from_numpy(_ids(np.random.RandomState(1), 1))
    with pytest.raises(NotImplementedError, match="eval-mode"):
        p_rec.fw_surrogate_coalitions(pcfg, model, ids,
                                      torch.ones((1, 2, P), dtype=torch.int32),
                                      deterministic=False)


# ------------------------------------------------------------ conversions


def _check_conv(got, want, new_prefixes):
    assert set(got) == set(want)
    for k in want:
        if k.startswith(new_prefixes):
            _law(k, got[k], want[k], want)
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_conversions_match_jax():
    cfg, pcfg = _cfgs()
    cls, srg, exp = _stage_params(share=False)
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(1)
    _check_conv(p_rec.conv_classifier_surrogate(pcfg, None, cls, gen),
                _np(j_rec.conv_classifier_surrogate(cfg, None, _jp(cls),
                                                    key)), ())
    _check_conv(p_rec.conv_surrogate_explainer(pcfg, None, srg, gen),
                _np(j_rec.conv_surrogate_explainer(cfg, None, _jp(srg), key)),
                ("s_attn_attention_layers.", "s_attn_explainer."))
    # the final: three sources and surrogate_null, the surrogate on the
    # null ids of each package's tokenizer over one vocabulary
    with _env({"AUTOGNOTHI_PALLAS": "0"}):
        got = p_rec.conv_explainer_final(
            pcfg, p_vb.BertMisc(p_tok.WordPieceTokenizer(VOCAB)), cls, srg,
            exp, gen, CPU)
        want = _np(j_rec.conv_explainer_final(
            cfg, j_rec.LttBertMisc(j_tok.WordPieceTokenizer(VOCAB)),
            _jp(cls), _jp(srg), _jp(exp), key))
    np.testing.assert_allclose(got.pop("surrogate_null"),
                               want.pop("surrogate_null"), atol=1e-6)
    _check_conv(got, want, ())
    assert not np.array_equal(got["bert.encoder.s_attn_maps.1_0.weight"],
                              got["bert.encoder.s_attn_maps.0_0.weight"])
    np.testing.assert_array_equal(got["bert.encoder.s_attn_maps.1_0.weight"],
                                  exp["bert.encoder.s_attn_maps.0_0.weight"])


def _hf_bundle(own, layout):
    """An HF BertForSequenceClassification ("seqcls") or bare BertModel
    ("bare") state dict of the own-layout classifier `own`, with the
    `position_ids` buffer HF keeps."""
    out = {}
    for k, v in own.items():
        hf = k.replace("encoder.layers.", "encoder.layer.").replace(
            "bert_pooler.", "bert.pooler.")
        if layout == "bare":
            if hf.startswith("classifier."):
                continue
            hf = hf.removeprefix("bert.")
        out[hf] = v
    prefix = "bert." if layout == "seqcls" else ""
    out[f"{prefix}embeddings.position_ids"] = np.arange(T)[None]
    return out


@pytest.mark.parametrize("layout", ["own", "seqcls", "bare"])
def test_conv_pretrained_classifier_matches_jax(layout):
    cfg, pcfg = _cfgs()
    own = _np(j_bert.init_bert_classifier(jax.random.PRNGKey(2), cfg.into()))
    bundle = own if layout == "own" else _hf_bundle(own, layout)
    got = p_rec.conv_pretrained_classifier(pcfg, bundle,
                                           torch.Generator().manual_seed(0))
    want = _np(j_rec.conv_pretrained_classifier(cfg, bundle,
                                                jax.random.PRNGKey(3)))
    new = ("bert.encoder.s_attn_maps.", "bert.encoder.s_attn_layers.",
           "bert_s_attn_pooler.", "s_attn_classifier.")
    if layout == "bare":  # no head in the bundle: a fresh one
        new += ("classifier.",)
    _check_conv(got, want, new)
    np.testing.assert_array_equal(
        got["bert.encoder.layers.1.output.LayerNorm.weight"],
        own["bert.encoder.layers.1.output.LayerNorm.weight"])
    with pytest.raises(ValueError, match="unrecognized"):
        p_vb.conv_pretrained_classifier(pcfg.into(), {"x": own["classifier.bias"]},
                                        torch.Generator())


# ----------------------------------------------------- one train step each


def _jax_step(stage, cfg, params, teacher, ids, labels, masks, key):
    """The JAX step's loss, trainable gradients, updated parameters (and,
    for the explainer, the masks it drew): the stages' `loss_fn`s
    (`train_classifier.py:87-101`, `train_surrogate.py:90-102`) and
    `make_explainer_train_step`."""
    recipe = j_rec.ltt_bert_recipe()
    p = _jp(params)
    trainable = recipe.trainable(cfg, stage)
    tx, opt_state = jax_training.make_optimizer(p, trainable)
    ones_p = jnp.ones((B, P), jnp.int32)
    w = jnp.ones((B,), jnp.float32)
    xs, labels = jnp.asarray(ids), jnp.asarray(labels)
    ones = {k: jnp.ones(()) for k in p}
    if stage == "explainer":
        null = jnp.asarray([[0.3, 0.7]], jnp.float32)
        srg = _jp(teacher)
        step = jax_make_explainer_step(recipe, cfg, P, M, tx)
        new, _, loss = step(p, opt_state, srg, null, xs, key, LR, ones,
                            jnp.int32(2))
        mask_key, _ = jax.random.split(key)
        masks = jax_shapley.mask_shapley(mask_key, B * M, P).reshape(B, M, P)
        v_s, v_1 = jax.jit(_make_teacher(recipe, cfg, P))(srg, xs, masks)

        def loss_fn(q):
            with jax_quant_override("none"):
                phi, _ = recipe.fw_explainer(
                    cfg, q, xs, ones_p, v_1, null, deterministic=False,
                    rng=jax.random.PRNGKey(9),
                    ltt_active_layers=jnp.int32(2))
            return jax_shapley.loss_shapley(masks, null, v_s, v_1, phi)

        grads = jax.jit(jax.grad(loss_fn))(p)
        return (float(loss), {k: np.asarray(v) for k, v in grads.items()
                              if trainable(k)}, _np(new), np.asarray(masks))
    if stage == "classifier":
        def loss_fn(p, xs, mask, labels, rng, ltt_active, weights):
            with jax_quant_override("none"):
                probs, _ = recipe.fw_classifier(
                    cfg, p, xs, mask, deterministic=False, rng=rng,
                    ltt_active_layers=ltt_active)
            return jax_training.cross_entropy_on_probs(probs, labels,
                                                       weights), probs
        batch = (xs, ones_p, labels, jax.random.PRNGKey(9), jnp.int32(2), w)
    else:
        orig_ys = recipe.fw_classifier(cfg, _jp(teacher), xs, ones_p)[1]

        def loss_fn(p, xs, mask, orig_ys, labels, rng, ltt_active, weights):
            with jax_quant_override("none"):
                adapt_ys, _ = recipe.fw_surrogate(
                    cfg, p, xs, mask, deterministic=False, rng=rng,
                    ltt_active_layers=ltt_active)
            kld = jax_kl(orig_ys, adapt_ys, weights)
            return kld, (jax_training.cross_entropy_on_probs(
                adapt_ys, labels, weights), adapt_ys)
        batch = (xs, jnp.asarray(masks), orig_ys, labels,
                 jax.random.PRNGKey(9), jnp.int32(2), w)
    step = jax_training.make_train_step(tx, loss_fn)
    new, _, loss, _ = step(p, opt_state, LR, ones, *batch)
    grads = jax.jit(jax.grad(lambda q: loss_fn(q, *batch)[0]))(p)
    return (float(loss), {k: np.asarray(v) for k, v in grads.items()
                          if trainable(k)}, _np(new), masks)


def _port_step(stage, params, teacher, ids, labels, masks):
    recipe = p_rec.ltt_bert_recipe()
    pcfg = recipe.t_config(**MINI)
    model = from_jax_params(params, pcfg, CPU, section=stage)
    trainable = recipe.trainable(pcfg, stage)
    for name, p in model.named_parameters():
        p.requires_grad_(trainable(name))
    named = dict(model.named_parameters())
    opt = AdamW(named, trainable)
    seen = {}
    update = opt.update

    def spy(p, grads, lr, mask):
        seen.update({k: v.detach().clone() for k, v in grads.items()
                     if v is not None})
        return update(p, grads, lr, mask)

    opt.update = spy
    t = torch.from_numpy
    ones_p = torch.ones((B, P), dtype=torch.int32)
    update_mask = {k: 1.0 for k in named}
    if stage == "explainer":
        srg = from_jax_params(teacher, pcfg, CPU, section="surrogate")
        srg.requires_grad_(False)
        step = make_explainer_train_step(recipe, pcfg, P, M)
        loss = step(model, opt, srg, torch.tensor([[0.3, 0.7]]), t(ids),
                    None, LR, update_mask, 2, masks=t(np.array(masks)))
    else:
        w = torch.ones(B)
        if stage == "classifier":
            loss_fn = classifier_loss(recipe, pcfg, True)
            batch = (t(ids), ones_p, t(labels), None, 2, w)
        else:
            cls_m = from_jax_params(teacher, pcfg, CPU, section="classifier")
            orig = surrogate_teacher(recipe, pcfg)(cls_m, t(ids), ones_p)
            loss_fn = surrogate_loss(recipe, pcfg, True)
            batch = (t(ids), t(masks), orig, t(labels), None, 2, w)
        loss, _ = make_train_step(loss_fn)(model, opt, LR, update_mask,
                                           *batch)
    return (loss.item(), {k: v.numpy() for k, v in seen.items()},
            {k: v.detach().numpy() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("stage", ["classifier", "surrogate", "explainer"])
@pytest.mark.parametrize("setting", ["mode0", "mode2_int8", "mode1"])
def test_train_step_matches_jax(stage, setting, int8_codes):
    """One step of each stage.  "mode2_int8": pallas mode "2" with the
    fused ops (plain versions on the CPU, the JAX kernels interpreted) in
    the differentiated forward, and the W8A8 teacher of each stage (the
    classifier has none: its step is the float one; the surrogate's teacher
    with AUTOGNOTHI_INT8=1, the explainer's by AUTOGNOTHI_INT8_TEACHER's
    default)."""
    jax_env, port_env, tol = SETTINGS[setting]
    if stage == "classifier" and setting == "mode2_int8":
        jax_env, port_env, tol = SETTINGS["mode2"]
    if setting == "mode0":
        tol = TOL_FP32
    cfg, _ = _cfgs()
    cls, srg, exp = _stage_params(seed=5)
    # a random init's trunk and side predict alike and near 1 / C, and the
    # surrogate stage's KL (over their softmax) would cancel to float
    # noise: biased heads make the teacher and the student disagree
    cls["classifier.bias"] = np.asarray([2.0, -2.0], np.float32)
    srg["s_attn_classifier.bias"] = np.asarray([-2.0, 2.0], np.float32)
    params = {"classifier": cls, "surrogate": srg, "explainer": exp}[stage]
    teacher = {"classifier": None, "surrogate": cls, "explainer": srg}[stage]
    rng = np.random.RandomState(17)
    ids = _ids(rng)
    labels = rng.randint(0, 2, size=B).astype(np.int32)
    masks = (rng.rand(B, P) > rng.rand(B, 1)).astype(np.int32)
    with _env(jax_env), mock.patch(
            "autognothi_tpu.parallel.train_step.mesh_safe_pallas",
            contextlib.nullcontext):
        want_loss, want_g, want_p, masks = _jax_step(
            stage, cfg, params, teacher, ids, labels, masks,
            jax.random.PRNGKey(11))
    with _env(port_env):
        loss, got_g, got_p = _port_step(stage, params, teacher, ids, labels,
                                        masks)
    if setting == "mode2_int8" and stage != "classifier" \
            and not _codes_agree():
        tol = TOL_FLIPPED
    assert abs(loss - want_loss) <= tol * abs(want_loss), (loss, want_loss)
    assert set(got_g) == set(want_g)
    g_max = max(np.abs(g).max() for g in want_g.values())
    for k, g in want_g.items():
        if np.abs(g).max() < 1e-4 * g_max:  # 0 by structure
            assert np.abs(got_g[k]).max() <= 1e-4 * g_max, k
            continue
        err = np.abs(got_g[k] - g).max()
        assert err <= tol * g_max, (k, err, g_max)
        moved = np.abs(g) > 1e-4 * g_max
        np.testing.assert_allclose(got_p[k][moved], want_p[k][moved],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for k in want_p:
        if k not in want_g:  # frozen: unchanged in both
            np.testing.assert_array_equal(got_p[k], params[k])
            np.testing.assert_array_equal(want_p[k], params[k])


# ---------------------------------------------------------------- loaders


def _batches(loader, which, size):
    return list(getattr(loader, which)(size))


def test_nlp_loaders_match_jax(tmp_path, monkeypatch):
    from autognothi_tpu_torch.pipeline.config import Config_Dataset
    from autognothi_tpu_torch.pipeline.resources import load_cfg_dataset

    # the port reads its own copy of the sample set, the JAX package's byte
    # for byte
    assert p_loader._HERE == REPO / "autognothi_tpu_torch" / "data"
    assert (REPO / "autognothi_tpu_torch/data/nlp_samples.json").read_bytes() \
        == (REPO / "autognothi_tpu/data/nlp_samples.json").read_bytes()
    for size in (8, 5):
        for which in ("train_raw", "test_raw"):
            got = _batches(p_loader.load_nlp_samples(), which, size)
            assert got == _batches(j_loader.load_nlp_samples(), which, size)
    got = _batches(load_cfg_dataset(Config_Dataset("nlp_samples", {})),
                   "train", 8)
    assert len(got) == 3 and len(got[0][0]) == 8
    assert got == _batches(load_cfg_dataset(
        Config_Dataset("yelp_polarity_mini", {})), "test", 8)
    # yelp_polarity_mini: a bundled mini file where there is one
    mini = [{"inputs": "a short review", "targets": 0}]
    (tmp_path / "yelp_polarity_mini.json").write_text(json.dumps(mini))
    (tmp_path / "nlp_samples.json").write_text(json.dumps(mini * 2))
    monkeypatch.setattr(p_loader, "_HERE", tmp_path)
    assert _batches(p_loader.load_yelp_polarity_mini(), "train_raw", 4) == \
        [(["a short review"], [0], ["a short review"], [0])]
    # yelp_polarity: no local `datasets` cache, no download
    with pytest.raises(FileNotFoundError, match="yelp_polarity"):
        load_cfg_dataset(Config_Dataset(
            "yelp_polarity", {"train_size": 8, "test_size": 4,
                              "test_seed": 42}))
    # imagenette: likewise no local cache here (the loader is held
    # against the JAX one in tests/test_torch_port_cv_data.py)
    with pytest.raises(FileNotFoundError, match="imagenette"):
        load_cfg_dataset(Config_Dataset(
            "imagenette", {"train_size": 8, "test_size": 4,
                           "test_seed": 42,
                           "transforms": p_loader.CvTransforms()}))


# ------------------------------------------------------- through the CLI


def write_exp(root: pathlib.Path, name: str = "ltt_bert") -> pathlib.Path:
    exp = root / name
    exp.mkdir(parents=True)
    p_tok.WordPieceTokenizer(VOCAB).save(exp / "tokenizer")
    (exp / ".hparams.json").write_text(json.dumps(ltt_bert_hparams(),
                                                  indent=2))
    return exp


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """The mini LTT BERT experiment after the JAX `train_all`."""
    from autognothi_tpu.pipeline.env import ExpEnv as JaxEnv
    from autognothi_tpu.pipeline.train_all import train_all as jax_train_all

    exp = write_exp(tmp_path_factory.mktemp("bert_train"))
    with _env({}):
        jax_train_all(JaxEnv(exp))
    return exp


@pytest.fixture(scope="module")
def measured(jax_trained, tmp_path_factory):
    """`measure_all` of each package on its own copy of the JAX-trained
    experiment -> (jax dir, port dir)."""
    from autognothi_tpu.pipeline.env import ExpEnv as JaxEnv
    from autognothi_tpu.pipeline.measure_all import \
        measure_all as jax_measure_all
    from autognothi_tpu_torch.cli import main

    root = tmp_path_factory.mktemp("bert_reports")
    jax_dir, port_dir = root / "jax", root / "port"
    shutil.copytree(jax_trained, jax_dir)
    shutil.copytree(jax_trained, port_dir)
    jax_masks, port_masks = _shared_masks()
    with _env({}):
        with mock.patch("autognothi_tpu.pipeline.measure_accuracy."
                        "mask_uniform_selective", jax_masks):
            jax_measure_all(JaxEnv(jax_dir))
        with mock.patch("autognothi_tpu_torch.pipeline.measure_accuracy."
                        "mask_uniform_selective", port_masks):
            main(["measure_all", str(port_dir), "--device", "cpu"])
    return jax_dir, port_dir


def test_train_all_and_run_all_cli(tmp_path):
    """`train_all` through `python -m`: the seven stages, the progressive
    surrogate and the coherency check, and a final the JAX package loads
    whose fw_final is the port's; then `run_all` on the same directory
    finds stage 7 and writes the six reports."""
    from autognothi_tpu.pipeline.resources import load_params_file

    exp = write_exp(tmp_path)
    for verb in ("train_all", "run_all"):
        proc = subprocess.run(
            [sys.executable, "-m", "autognothi_tpu_torch", verb, str(exp),
             "--device", "cpu"], cwd=REPO, env=_clean_env(),
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        log = (exp / ".log.txt").read_text()
        if verb == "train_all":
            for line in ("current stage: 0 / 7", "train classifier",
                         "train surrogate", "train explainer",
                         "freeze side branches exc. first 1 layers",
                         "cls_diff: ", "verified final model is coherent",
                         "all stages ok"):
                assert line in log, line
            for name in ("classifier-epoch-1", "surrogate-epoch-2",
                         "explainer-epoch-1", "final-epoch-0"):
                assert (exp / f"{name}.ckpt").exists(), name
            trained_log = log
    rerun = log[len(trained_log):]
    assert "current stage: 7 / 7" in rerun
    assert "[[[ done all measurements ]]]" in rerun
    assert sorted(p.name for p in (exp / ".reports").iterdir()) == NAMES
    final = load_params_file(exp / "final-epoch-0.ckpt")
    cfg, pcfg = _cfgs()
    ids = p_tok.encode_batch(p_tok.WordPieceTokenizer(VOCAB), _corpus()[:3],
                             T)
    with _env({"AUTOGNOTHI_PALLAS": "0"}):
        j_probs, j_attr = j_rec.fw_final(cfg, _jp(final), jnp.asarray(ids))
        with torch.no_grad():
            probs, attr = p_rec.fw_final(pcfg, from_jax_params(final, pcfg,
                                                                CPU),
                                         torch.from_numpy(ids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(j_probs), atol=1e-5)
    np.testing.assert_allclose(attr.numpy(), np.asarray(j_attr), atol=1e-5)


def test_train_classifier_epoch_matches_jax(jax_trained, tmp_path):
    """From the JAX run's classifier-epoch-0.ckpt: the port's
    `train_classifier` epoch within 1e-5 of the JAX run's
    classifier-epoch-1.ckpt, under the AdamW-noise rule of
    tests/test_torch_port_stages.py (an element whose gradient is within
    float noise of 0 takes AdamW's step with either sign: the key biases,
    0 by structure, are held to that bound in both packages, and at most 1%
    of any other tensor's elements may exceed 1e-5, each within two such
    steps)."""
    from autognothi_tpu.pipeline.resources import load_params_file
    from autognothi_tpu_torch.cli import main

    exp = write_exp(tmp_path)
    shutil.copy(jax_trained / "classifier-epoch-0.ckpt", exp)
    with _env({}):
        main(["train_classifier", str(exp), "--device", "cpu"])
    got = load_params_file(exp / "classifier-epoch-1.ckpt")
    want = load_params_file(jax_trained / "classifier-epoch-1.ckpt")
    start = load_params_file(exp / "classifier-epoch-0.ckpt")
    assert set(got) == set(want)
    moved = [k for k in want if not np.array_equal(want[k], start[k])]
    assert moved and not any(k.startswith(TRUNK) for k in moved)
    hp = ltt_bert_hparams()
    steps = -(-len(_corpus()) // hp["train_classifier"]["batch_size"])
    lr = hp["train_classifier"]["lr"]
    for k in want:
        if k.endswith("attention.self.key.bias"):
            for x in (got[k], want[k]):
                assert np.abs(x - start[k]).max() <= steps * lr * 1.01, k
            continue
        err = np.abs(got[k] - want[k])
        unsettled = err > 1e-5
        assert unsettled.mean() <= 0.01, (k, unsettled.sum())
        assert err.max() <= 2 * steps * lr * 1.01, (k, err.max())
    assert "epoch 1 done" in (exp / ".log.txt").read_text()


def test_measure_all_writes_the_six_reports(measured):
    jax_dir, port_dir = measured
    produced = sorted(p.name for p in (port_dir / ".reports").iterdir())
    assert produced == NAMES
    assert produced == sorted(p.name for p in (jax_dir / ".reports")
                              .iterdir())
    for name in NAMES:  # the same keys in the same order
        assert list(_report(port_dir, name)) == list(_report(jax_dir, name))


@pytest.mark.parametrize("name", ["faithfulness.json", "branches_cka.json"])
def test_faithfulness_and_cka_match_jax(measured, name):
    jax_dir, port_dir = measured
    _close(_report(port_dir, name), _report(jax_dir, name), 1e-5)


@pytest.mark.parametrize("name", ["cls_acc.json", "accuracy.json"])
def test_cls_acc_and_accuracy_equal_jax(measured, name):
    """accuracy on the shared masks of `_shared_masks`."""
    jax_dir, port_dir = measured
    assert _report(port_dir, name) == _report(jax_dir, name)


def test_performance_matches_jax(measured):
    jax_dir, port_dir = measured
    got = _report(port_dir, "performance.json")
    want = _report(jax_dir, "performance.json")
    for stage in ("classifier", "surrogate", "explainer", "final"):
        g, w = got[stage], want[stage]
        assert g["params_all"] == w["params_all"], stage
        assert g["params_trainable"] == w["params_trainable"], stage
        assert g["gflops"] > 0
        assert abs(g["gflops"] - w["gflops"]) <= 1e-3 * w["gflops"], stage
        assert len(g["time"]) == len(w["time"]) and g["time_avg"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_each_package_loads_the_others_report(measured, name):
    import pydantic

    from autognothi_tpu.pipeline import measure_all as jax_ma
    from autognothi_tpu_torch.cli import REPORTS
    from autognothi_tpu_torch.pipeline.reports import dump_report, \
        load_report

    jax_dir, port_dir = measured
    module, cls, _ = next(v for v in REPORTS.values() if v[2] == name)
    port_cls = getattr(__import__(
        f"autognothi_tpu_torch.pipeline.{module}", fromlist=[cls]), cls)
    jax_cls = getattr(jax_ma, cls)
    jax_text = (jax_dir / ".reports" / name).read_text()
    assert dump_report(load_report(port_cls, json.loads(jax_text))) == \
        jax_text
    port_json = _report(port_dir, name)
    if name == "train_resources.json":  # the CPU's null memory cells
        with pytest.raises(pydantic.ValidationError):
            jax_cls.model_validate(port_json)
        port_json = dict(port_json, init_mem=1.0,
                         srg_mem={"all": [1.0], "avg": 1.0, "std": 0.0},
                         exp_mem={"all": [1.0], "avg": 1.0, "std": 0.0})
    loaded = jax_cls.model_validate(port_json)
    assert json.loads(loaded.model_dump_json(by_alias=True)) == port_json


def test_verbs_default_to_the_card(tmp_path):
    from autognothi_tpu_torch.cli import REPORTS, TRAINING, main

    exp = write_exp(tmp_path)
    if not torch.cuda.is_available():  # --device defaults to cuda
        for verb in (*TRAINING, *REPORTS, "measure_all", "run_all"):
            with pytest.raises(RuntimeError, match="cuda"):
                main([verb, str(exp)])
    assert not (exp / "classifier-epoch-0.ckpt").exists()
