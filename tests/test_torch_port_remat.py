"""Port parity, per-layer rematerialisation (AUTOGNOTHI_REMAT=1,
`models/common.py:maybe_remat`): the classifier, surrogate and explainer
steps of the vanilla ViT and BERT and of the LTT ViT and BERT, each
- with AUTOGNOTHI_REMAT=1 bit for bit the same step without it (loss,
  every gradient, every updated parameter) on the CPU, with dropout 0.1
  drawn from the step's generator (the recompute replays its state), and
  at dropout 0 in pallas mode "2", where the kernel ops' plain versions
  run inside the checkpoint;
- under AUTOGNOTHI_REMAT=1 equal to the JAX package's step under the same
  variable (its `jax.checkpoint`; the step is traced after the variable
  is set), at `tests/test_torch_port_train.py`'s mode "0" tolerance
  (dropout 0: the two packages cannot share dropout draws);
and a pipeline stage step (data 1 x pipe 2) and a tensor-parallel step
(model 2) over a world of two gloo processes, with and without the
variable, bit for bit: the stage's `autograd.grad` per microbatch and
Megatron's all-reduces run again in the recompute, alike on every rank."""

import contextlib
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autognothi_tpu.models.common import quant_override as jax_quant_override
from autognothi_tpu.ops.shapley import loss_logits_kl_divergence as jax_kl
from autognothi_tpu.ops.shapley import loss_shapley as jax_loss_shapley
from autognothi_tpu.parallel.train_step import _ltt_kwargs as jax_ltt_kwargs
from autognothi_tpu.parallel.train_step import _make_teacher
from autognothi_tpu.pipeline import training as jax_training
from autognothi_tpu.recipes import ltt_bert as j_lb
from autognothi_tpu.recipes import ltt_vit as j_lv
from autognothi_tpu.recipes import vanilla_bert as j_vb
from autognothi_tpu.recipes import vanilla_vit as j_vv
from autognothi_tpu_torch.models import common
from autognothi_tpu_torch.params import MODELS, from_jax_params, to_flat
from autognothi_tpu_torch.parallel.train_step import make_explainer_train_step
from autognothi_tpu_torch.pipeline.train_classifier import classifier_loss
from autognothi_tpu_torch.pipeline.train_surrogate import (surrogate_loss,
                                                           surrogate_teacher)
from autognothi_tpu_torch.pipeline.training import AdamW, make_train_step
from autognothi_tpu_torch.recipes import ltt_bert as p_lb
from autognothi_tpu_torch.recipes import ltt_vit as p_lv
from autognothi_tpu_torch.recipes import vanilla_bert as p_vb
from autognothi_tpu_torch.recipes import vanilla_vit as p_vv
from tests.test_torch_port_bert_train import ltt_bert_hparams
from tests.test_torch_port_model import MINI as LTT_VIT
from tests.test_torch_port_scaleout import run_world
from tests.test_torch_port_vanilla import VOCAB, bert_hparams, vit_hparams

CPU = torch.device("cpu")
B, M, LR = 2, 3, 1e-3
ENV_KEYS = ("AUTOGNOTHI_PALLAS", "AUTOGNOTHI_PALLAS_INTERPRET",
            "AUTOGNOTHI_INT8", "AUTOGNOTHI_INT8_TEACHER", "AUTOGNOTHI_REMAT")
TOL = 1e-5  # tests/test_torch_port_train.py, mode "0"
DROPOUT = dict(attention_probs_dropout_prob=0.1, hidden_dropout_prob=0.1)

FAMILIES = {
    "vit": (j_vv.vanilla_vit_recipe, p_vv.vanilla_vit_recipe,
            lambda: vit_hparams()["net"]["params"]),
    "bert": (j_vb.vanilla_bert_recipe, p_vb.vanilla_bert_recipe,
             lambda: bert_hparams()["net"]["params"]),
    "ltt_vit": (j_lv.ltt_vit_recipe, p_lv.ltt_vit_recipe,
                lambda: dict(LTT_VIT, img_px_size=16, img_patch_size=4)),
    "ltt_bert": (j_lb.ltt_bert_recipe, p_lb.ltt_bert_recipe,
                 lambda: ltt_bert_hparams()["net"]["params"]),
}
STAGES = ("classifier", "surrogate", "explainer")


@contextlib.contextmanager
def _env(values):
    saved = {k: os.environ.pop(k) for k in ENV_KEYS if k in os.environ}
    try:
        with mock.patch.dict(os.environ, values):
            yield
    finally:
        os.environ.update(saved)


class Case:
    """A family's recipes, config, parameters of the three sections and
    one batch, all from numpy seeds."""

    def __init__(self, family: str, dropout: bool):
        j_make, p_make, hparams = FAMILIES[family]
        params = dict(hparams(), **(DROPOUT if dropout else {}))
        self.family = family
        self.j_recipe, self.p_recipe = j_make(), p_make()
        self.jcfg = self.j_recipe.t_config(**params)
        self.pcfg = self.p_recipe.t_config(**params)
        self.ltt = family.startswith("ltt")
        self.n = self.p_recipe.n_players(self.pcfg)
        rng = np.random.RandomState(13)
        self.flat = {s: self._params(s, rng) for s in STAGES}
        if family.endswith("bert"):
            ids = rng.randint(5, len(VOCAB), (B, self.n + 1))
            ids[:, 0] = VOCAB.index("[CLS]")
            self.xs = ids.astype(np.int64)
        else:
            c = self.pcfg
            self.xs = rng.randn(B, c.img_channels, c.img_px_size,
                                c.img_px_size).astype(np.float32)
        self.labels = rng.randint(0, 2, size=B).astype(np.int32)
        self.mask = (rng.rand(B, self.n) > 0.3).astype(np.int32)
        self.masks = (rng.rand(B, M, self.n) > 0.5).astype(np.int32)
        self.null = np.full((1, self.pcfg.num_labels),
                            1.0 / self.pcfg.num_labels, np.float32)

    def _params(self, section, rng):
        with torch.device("meta"):
            shapes = {k: v.shape for k, v in
                      MODELS[type(self.pcfg)](self.pcfg, section)
                      .state_dict().items()}
        return {k: ((1.0 if k.lower().endswith(("layernorm.weight",
                                                  "ln.weight")) else 0.0)
                    + 0.1 * rng.randn(*s)).astype(np.float32)
                for k, s in shapes.items()}


# ------------------------------------------------------------ the port


def port_step(case: Case, stage: str, seed: int = 5):
    """-> (loss, gradients, updated parameters) of one step of the port."""
    recipe, cfg = case.p_recipe, case.pcfg
    model = from_jax_params(case.flat[stage], cfg, CPU, section=stage)
    trainable = recipe.trainable(cfg, stage)
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
    gen = torch.Generator().manual_seed(seed)
    w = torch.ones(B)
    ones = {k: 1.0 for k in named}
    if stage == "explainer":
        srg = from_jax_params(case.flat["surrogate"], cfg, CPU,
                              section="surrogate")
        srg.requires_grad_(False)
        step = make_explainer_train_step(recipe, cfg, case.n, M)
        loss = step(model, opt, srg, t(case.null), t(case.xs), gen, LR,
                    ones, 2, masks=t(case.masks))
    else:
        if stage == "classifier":
            loss_fn = classifier_loss(recipe, cfg, case.ltt)
            batch = (t(case.xs), t(case.mask), t(case.labels), gen, 2, w)
        else:
            cls = from_jax_params(case.flat["classifier"], cfg, CPU,
                                  section="classifier")
            orig = surrogate_teacher(recipe, cfg)(cls, t(case.xs),
                                                  t(case.mask))
            loss_fn = surrogate_loss(recipe, cfg, case.ltt)
            batch = (t(case.xs), t(case.mask), orig, t(case.labels), gen, 2,
                     w)
        loss, _ = make_train_step(loss_fn)(model, opt, LR, ones, *batch)
    return (loss.item(), {k: v.numpy() for k, v in seen.items()},
            to_flat(model))


@contextlib.contextmanager
def _counting_checkpoints():
    import torch.utils.checkpoint as ckpt

    calls = []
    wrapped = ckpt.checkpoint

    def counted(*args, **kwargs):
        calls.append(1)
        return wrapped(*args, **kwargs)

    with mock.patch.object(ckpt, "checkpoint", counted):
        yield calls


def _identical(a, b):
    assert a[0] == b[0], (a[0], b[0])
    for got, want in ((a[1], b[1]), (a[2], b[2])):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_step_is_bit_identical_with_dropout(family, stage):
    case = Case(family, dropout=True)
    with _env({}):
        plain = port_step(case, stage)
    with _env({"AUTOGNOTHI_REMAT": "1"}), _counting_checkpoints() as layers:
        remat = port_step(case, stage)
    assert layers, "no layer ran under torch.utils.checkpoint"
    _identical(remat, plain)
    # another generator draws other dropout masks: the draws are live
    with _env({}):
        other = port_step(case, stage, seed=6)
    assert not plain[1] or other[0] != plain[0]


@pytest.mark.parametrize("family", ["ltt_vit", "ltt_bert", "vit"])
def test_remat_step_is_bit_identical_on_the_kernel_ops(family):
    """Dropout 0 in pallas mode "2": the differentiated forward runs the
    kernel ops (their plain versions here) inside the checkpoint, and the
    recompute sees the train step's quant and pallas scopes."""
    case = Case(family, dropout=False)
    calls = []
    from autognothi_tpu_torch.ops import (attention_block, ladder_block,
                                          mlp_block)

    def spy(module):
        dispatch = module.dispatch

        def spied(launch, plain, counter, *a, **kw):
            calls.append(counter.name)
            return dispatch(launch, plain, counter, *a, **kw)
        return mock.patch.object(module, "dispatch", spied)

    # AUTOGNOTHI_INT8=1: the teacher runs W8A8 and the differentiated
    # forward, under the step's quant_override("none"), does not; so must
    # its recompute, which runs in the backward, outside that scope
    with _env({"AUTOGNOTHI_INT8": "1"}):
        plain = port_step(case, "explainer")
    with _env({"AUTOGNOTHI_INT8": "1", "AUTOGNOTHI_REMAT": "1"}), \
            spy(attention_block), spy(mlp_block), spy(ladder_block):
        remat = port_step(case, "explainer")
    _identical(remat, plain)
    assert calls, "no kernel op ran"


def test_remat_is_a_no_op_without_autograd():
    """Under no_grad (serving, the teacher sweep) `maybe_remat` calls the
    body once, as it is; unset or "0" it never checkpoints."""
    seen = []

    def body(x):
        seen.append(torch.is_grad_enabled())
        return torch.sin(x)  # keeps x for its backward

    x = torch.ones(3, requires_grad=True)
    with _env({"AUTOGNOTHI_REMAT": "1"}), torch.no_grad():
        common.maybe_remat(body, x)
    for value in ({}, {"AUTOGNOTHI_REMAT": "0"}):
        with _env(value):
            common.maybe_remat(body, x).sum().backward()
    assert seen == [False, True, True]
    with _env({"AUTOGNOTHI_REMAT": "1"}):
        common.maybe_remat(body, x).sum().backward()
    assert seen == [False, True, True, True, True]  # forward + recompute


def test_recompute_replays_the_generator_and_the_scopes():
    """The recompute draws the forward's dropout and sees its override
    scopes; the generator then holds the state it had before the
    backward."""
    gen = torch.Generator().manual_seed(3)
    seen = []

    def body(x):
        seen.append((common.pallas_mode(), common.quant_mode()))
        return common.dropout(gen, x, 0.5, False)

    x = torch.ones(64, requires_grad=True)
    with _env({"AUTOGNOTHI_REMAT": "1"}):
        with common.pallas_override("0"), common.quant_override("none"):
            y = common.maybe_remat(body, x, generator=gen)
        after = gen.get_state()
        y.sum().backward()
    assert torch.equal(gen.get_state(), after)
    assert torch.equal(x.grad, y.detach())  # the forward's mask, scaled
    assert seen == [("0", "none"), ("0", "none")]


# ------------------------------------------------------ against the JAX


def jax_step(case: Case, stage: str):
    """-> (loss, trainable gradients) of the JAX package's step, traced
    under the caller's environment."""
    recipe, cfg = case.j_recipe, case.jcfg
    p = {k: jnp.asarray(v) for k, v in case.flat[stage].items()}
    trainable = recipe.trainable(cfg, stage)
    xs = jnp.asarray(case.xs)
    w = jnp.ones((B,), jnp.float32)
    ltt = {"ltt_active_layers": jnp.int32(2)} if case.ltt else {}
    rng = jax.random.PRNGKey(9)
    if stage == "explainer":
        srg = {k: jnp.asarray(v) for k, v in case.flat["surrogate"].items()}
        masks = jnp.asarray(case.masks)
        v_s, v_1 = _make_teacher(recipe, cfg, case.n)(srg, xs, masks)
        null = jnp.asarray(case.null)

        def loss_fn(q):
            with jax_quant_override("none"):
                phi, _ = recipe.fw_explainer(
                    cfg, q, xs, jnp.ones((B, case.n), jnp.int32), v_1, null,
                    deterministic=False, rng=rng,
                    **jax_ltt_kwargs(recipe, jnp.int32(2)))
            return jax_loss_shapley(masks, null, v_s, v_1, phi, w)
    else:
        mask = jnp.asarray(case.mask)
        labels = jnp.asarray(case.labels)
        if stage == "surrogate":
            cls = {k: jnp.asarray(v)
                   for k, v in case.flat["classifier"].items()}
            orig = recipe.fw_classifier(cfg, cls, xs, mask)[1]

        def loss_fn(q):
            with jax_quant_override("none"):
                if stage == "classifier":
                    probs, _ = recipe.fw_classifier(
                        cfg, q, xs, mask, deterministic=False, rng=rng,
                        **ltt)
                    return jax_training.cross_entropy_on_probs(probs, labels,
                                                               w)
                adapt, _ = recipe.fw_surrogate(cfg, q, xs, mask,
                                               deterministic=False, rng=rng,
                                               **ltt)
                return jax_kl(orig, adapt, w)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()
                         if trainable(k)}


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_step_matches_jax(family, stage):
    case = Case(family, dropout=False)
    env = {"AUTOGNOTHI_PALLAS": "0", "AUTOGNOTHI_REMAT": "1"}
    with _env(env), mock.patch(
            "autognothi_tpu.parallel.train_step.mesh_safe_pallas",
            contextlib.nullcontext):
        want_loss, want_g = jax_step(case, stage)
    with _env(env):
        loss, got_g, _ = port_step(case, stage)
    assert abs(loss - want_loss) <= TOL * abs(want_loss), (loss, want_loss)
    got_g = {k: v for k, v in got_g.items() if k in want_g}
    assert set(got_g) == {k for k, g in want_g.items()
                          if k in got_g or np.abs(g).max() > 0}
    if not want_g:
        return
    g_max = max(np.abs(g).max() for g in want_g.values())
    for k, g in want_g.items():
        got = got_g.get(k, np.zeros_like(g))
        if np.abs(g).max() < 1e-4 * g_max:  # 0 by structure, as
            # tests/test_torch_port_stages.py holds it
            assert np.abs(got).max() <= 1e-4 * g_max, k
            continue
        err = np.abs(got - g).max()
        assert err <= TOL * g_max, (k, err, g_max)


# ------------------------------------------------- two gloo processes


def test_remat_pipeline_and_tensor_parallel_steps_bit_identical(tmp_path):
    """A PP (data 1 x pipe 2) surrogate step and a TP (model 2) explainer
    step of the mini vanilla ViT at dropout 0.1, each with and without
    AUTOGNOTHI_REMAT=1 from the same parameters: bit for bit on every
    rank, the ranks' losses equal."""
    case = Case("vit", dropout=True)
    inputs = tmp_path / "inputs.npz"
    arrays = {f"srg/{k}": v for k, v in case.flat["surrogate"].items()}
    arrays.update({f"exp/{k}": v for k, v in case.flat["explainer"].items()})
    arrays.update({f"cls/{k}": v for k, v in case.flat["classifier"].items()})
    arrays.update(xs=case.xs, mask=case.mask, masks=case.masks,
                  labels=case.labels, null=case.null,
                  orig=np.random.RandomState(3).randn(B, case.pcfg.num_labels)
                  .astype(np.float32))
    np.savez(inputs, **arrays)
    cfg = dict(vit_hparams()["net"]["params"], **DROPOUT)
    ranks = run_world({"tag": "remat", "jobs": ["remat"],
                       "inputs": str(inputs), "cfgs": {"vit": cfg},
                       "lr": LR}, 2, tmp_path,
                      module="tests.torch_port_pp_child")
    for js, npz in ranks:
        for what in ("pp", "tp"):
            assert js[f"{what}/0/loss"] == js[f"{what}/1/loss"], what
            assert js[f"{what}/recomputed"], what
            keys = [k for k in npz if k.startswith(f"{what}/0/")]
            assert keys, what
            for k in keys:
                np.testing.assert_array_equal(
                    npz[k], npz[k.replace(f"{what}/0/", f"{what}/1/")],
                    err_msg=k)
    for what in ("pp", "tp"):
        assert ranks[0][0][f"{what}/0/loss"] == ranks[1][0][f"{what}/0/loss"]
