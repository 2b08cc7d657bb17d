"""Port parity, the LTT ViT's budget gates (F5) and the fused-width floor
(F6), and the weight-code cache of the int8 ops.

- `gates.mlp_ladder_fits` and `gates.ladder_block_fits` against the JAX
  `mlp_ladder_fits_vmem` / `ladder_fits_vmem` over a grid of shapes.
- The mini LTT ViT final and the coalition (teacher) forward, int8 and
  fp32, against JAX under a budget lowered on both sides so that the fused
  trunk-MLP + ladder step (K2) and the ladder op (K5) do not fit: JAX then
  runs the trunk MLP as its own op (at 8,000 B as the 2-tile int8 chain)
  and per-branch side layers, and so must the port.
- AUTOGNOTHI_FUSED_MIN_HIDDEN above the side width (and above every
  width) on the mini LTT ViT and LTT BERT finals: the layers below the
  floor run the unfused, unquantized math on both sides.
- `ops/weight_codes.py` on the CPU (its plain quantizer).

Tolerances as `tests/test_torch_port_bert.py` states them: int8 forwards
whose per-token codes all agree within 2e-5, one with a flipped code
within 1e-2; fp32 against interpreted kernels 1e-4; x max(1, max|ref|).
"""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autognothi_tpu.models import ltt_bert as j_ltt_bert
from autognothi_tpu.models import ltt_vit as j_ltt_vit
from autognothi_tpu.ops import ladder_block as j_lb
from autognothi_tpu_torch.models import ltt_vit
from autognothi_tpu_torch.models.ltt_bert import (LttBertConfig,
                                                  ltt_bert_final_fwd)
from autognothi_tpu_torch.ops import gates
from autognothi_tpu_torch.ops import weight_codes as wc
from autognothi_tpu_torch.ops.mlp_block import quant_cols
from autognothi_tpu_torch.params import from_jax_params
from tests.test_torch_port_bert import (MINI as BERT_MINI, TOL_FLIPPED,
                                        TOL_INT8, TOL_INTERPRET, _close,
                                        _recorded_codes, _set_budget,
                                        _set_env, int8_codes)  # noqa: F401
from tests.test_torch_port_bert import _mini_params as _bert_params
from tests.test_torch_port_model import MINI as VIT_MINI
from tests.test_torch_port_model import _jax_params as _vit_params

CPU = torch.device("cpu")
# the mini LTT ViT (hidden 32, MLP 64, T = 5, 16-wide ladders, 4 heads)
# needs 25,892 B for K2 and 17,856 B for the two-branch ladder op: at
# 20,000 the ladder fits and K2 does not; at 8,000 neither does, the int8
# trunk attention does not (float attention), and the int8 trunk MLP
# splits into 2 tiles (K8q)
LADDER_ONLY, NOTHING_FUSED = 20000, 8000


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(a)


# ---------------------------------------------------------------- gates

# (hidden, MLP width, T, side width, branches, heads)
GATE_GRID = [
    (768, 3072, 197, 96, 2, 12),   # ViT-B/16@224: K2 fits
    (768, 3072, 197, 96, 1, 12),
    (768, 3072, 577, 96, 2, 12),   # ViT-B/16@384: K2 does not
    (1024, 4096, 197, 96, 2, 16),  # ViT-L/16@224: K2 does not
    (768, 3072, 512, 96, 2, 12),   # BERT-base@512
    (768, 3072, 640, 96, 2, 12),   # past the score-stack cap
    (32, 64, 5, 16, 2, 4),         # the mini model
    (384, 1536, 197, 48, 3, 6),
]


@pytest.mark.parametrize("budget", [None, LADDER_ONLY, 4 * 2 ** 20])
@pytest.mark.parametrize("shape", GATE_GRID)
def test_ladder_gates_equal_jax(monkeypatch, shape, budget):
    if budget is not None:
        _set_budget(monkeypatch, budget)
    hidden, inter, t, s, nb, heads = shape
    assert gates.mlp_ladder_fits(hidden, inter, t, s, nb, heads) == \
        j_lb.mlp_ladder_fits_vmem(hidden, inter, t, s, nb, heads)
    assert gates.ladder_block_fits(hidden, t, s, heads, nb) == \
        j_lb.ladder_fits_vmem(hidden, t, s, heads, nb)


def test_ladder_gates_vit_decisions():
    assert gates.mlp_ladder_fits(768, 3072, 197, 96, 2, 12)
    assert not gates.mlp_ladder_fits(768, 3072, 577, 96, 2, 12)
    assert not gates.mlp_ladder_fits(1024, 4096, 197, 96, 2, 16)
    # the ladder op itself fits at all three
    assert gates.ladder_block_fits(768, 577, 96, 12, 2)
    assert gates.ladder_block_fits(1024, 197, 96, 16, 2)


# --------------------------------------------------- LTT ViT under the gates


def _routes(monkeypatch):
    """Counts the port's calls of the fused ladder ops."""
    calls = {"mlp_ladder_block": 0, "ladder_block": 0}
    for name in calls:
        fn = getattr(ltt_vit, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(ltt_vit, name, spy)
    return calls


def _fused_widths(monkeypatch):
    """The widths at which the port's layers call the fused block ops."""
    from autognothi_tpu_torch.models import bert, ltt_bert, vit

    widths = []
    for mod in (vit, bert):
        for name in ("attention_block", "mlp_block"):
            def spy(h, *a, _fn=getattr(mod, name), **k):
                widths.append(h.shape[-1])
                return _fn(h, *a, **k)

            monkeypatch.setattr(mod, name, spy)

    def no_ladder(*a, **k):
        raise AssertionError("the ladder op ran below the fused floor")

    monkeypatch.setattr(ltt_bert, "ladder_block", no_ladder)
    return widths


def _tolerance(int8: bool) -> float:
    """The int8 bound by the recorded per-token codes: the same set of code
    rows on both sides (the interpreted JAX kernels quantize some blocks
    more than once, so the rows are compared as sets), else one flipped."""
    if not int8:
        return TOL_INTERPRET
    port, jax_ = _recorded_codes()
    # both sides quantize the same activations: the same widths (a layer
    # below the fused floor quantizes none)
    assert {c.shape[-1] for c in port} == {c.shape[-1] for c in jax_}
    rows = {side: {r.tobytes() for c in codes for r in c}
            for side, codes in (("port", port), ("jax", jax_))}
    return TOL_INT8 if rows["port"] == rows["jax"] else TOL_FLIPPED


def _vit_inputs(seed):
    rng = np.random.RandomState(seed)
    pixels = rng.randn(3, 3, 16, 16).astype(np.float32)
    mask = np.ones((3, 5), np.float32)
    mask[:, 1:] = rng.rand(3, 4) > 0.5
    return pixels, mask


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("budget", [None, LADDER_ONLY, NOTHING_FUSED])
def test_ltt_vit_final_under_the_ladder_gates(monkeypatch, int8_codes, budget,
                                              int8):
    """The mini final against JAX: at the default budget K2 (int8) or K5;
    with K2 over budget the trunk MLP as its own op and K5; with neither
    fitting, the 2-tile int8 trunk chain and per-branch side layers."""
    _set_env(monkeypatch, "2", int8)
    if budget is not None:
        _set_budget(monkeypatch, budget)
    calls = _routes(monkeypatch)
    jcfg, flat = _vit_params(VIT_MINI, seed=5)
    pixels, mask = _vit_inputs(6)
    want_logits, want_attr, _ = j_ltt_vit.ltt_vit_final_fwd(
        {k: _j(v) for k, v in flat.items()}, jcfg, _j(pixels), _j(mask))
    cfg = ltt_vit.LttViTConfig(**VIT_MINI)
    model = from_jax_params(flat, cfg, CPU)
    with torch.inference_mode():
        logits, attr = ltt_vit.ltt_vit_final_fwd(model, cfg, _t(pixels),
                                                 _t(mask))
    layers = VIT_MINI["num_hidden_layers"]
    want_calls = {
        None: {"mlp_ladder_block": layers if int8 else 0,
               "ladder_block": 0 if int8 else layers},
        LADDER_ONLY: {"mlp_ladder_block": 0, "ladder_block": layers},
        NOTHING_FUSED: {"mlp_ladder_block": 0, "ladder_block": 0},
    }[budget]
    assert calls == want_calls
    tol = _tolerance(int8)
    _close(logits.numpy(), want_logits, tol, "logits")
    _close(attr.numpy(), want_attr, tol, "attributions")


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("budget", [None, NOTHING_FUSED])
def test_ltt_vit_coalitions_under_the_ladder_gate(monkeypatch, int8_codes,
                                                  budget, int8):
    """The teacher sweep (branch 0 over B x M coalitions) against JAX: the
    one-branch ladder op where it fits (9,408 B), per-branch side layers
    (int8 in int8 mode) where it does not."""
    _set_env(monkeypatch, "2", int8)
    if budget is not None:
        _set_budget(monkeypatch, budget)
    calls = _routes(monkeypatch)
    jcfg, flat = _vit_params(VIT_MINI, seed=7)
    rng = np.random.RandomState(8)
    pixels = rng.randn(2, 3, 16, 16).astype(np.float32)
    masks = (rng.rand(2, 3, 5) > 0.4).astype(np.float32)
    masks[..., 0] = 1
    want = j_ltt_vit.ltt_vit_surrogate_coalitions_fwd(
        {k: _j(v) for k, v in flat.items()}, jcfg, _j(pixels), _j(masks))
    cfg = ltt_vit.LttViTConfig(**VIT_MINI)
    model = from_jax_params(flat, cfg, CPU)
    with torch.inference_mode():
        got = ltt_vit.ltt_vit_surrogate_coalitions_fwd(model, cfg,
                                                       _t(pixels), _t(masks))
    assert got.shape == (2, 3, VIT_MINI["num_labels"])
    layers = VIT_MINI["num_hidden_layers"]
    assert calls == {"mlp_ladder_block": 0,
                     "ladder_block": layers if budget is None else 0}
    _close(got.numpy(), want, _tolerance(int8), "coalitions")


# ------------------------------------------------- the fused-width floor


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("floor", [32, 128])
def test_ltt_vit_final_under_the_fused_floor(monkeypatch, int8_codes, floor,
                                             int8):
    """AUTOGNOTHI_FUSED_MIN_HIDDEN = 32 sends the 16-wide side layers (and
    the ladder) to the unfused, unquantized math; 128 the 32-wide trunk as
    well.  Against JAX under the same floor."""
    _set_env(monkeypatch, "2", int8)
    monkeypatch.setenv("AUTOGNOTHI_FUSED_MIN_HIDDEN", str(floor))
    calls = _routes(monkeypatch)
    widths = _fused_widths(monkeypatch)
    jcfg, flat = _vit_params(VIT_MINI, seed=9)
    pixels, mask = _vit_inputs(10)
    want_logits, want_attr, _ = j_ltt_vit.ltt_vit_final_fwd(
        {k: _j(v) for k, v in flat.items()}, jcfg, _j(pixels), _j(mask))
    cfg = ltt_vit.LttViTConfig(**VIT_MINI)
    model = from_jax_params(flat, cfg, CPU)
    with torch.inference_mode():
        logits, attr = ltt_vit.ltt_vit_final_fwd(model, cfg, _t(pixels),
                                                 _t(mask))
    assert calls == {"mlp_ladder_block": 0, "ladder_block": 0}
    assert set(widths) == ({32} if floor == 32 else set())
    tol = _tolerance(int8)
    _close(logits.numpy(), want_logits, tol, "logits")
    _close(attr.numpy(), want_attr, tol, "attributions")
    # below the floor nothing is fused: the same forward at floor 0 differs
    monkeypatch.delenv("AUTOGNOTHI_FUSED_MIN_HIDDEN")
    with torch.inference_mode():
        _, attr_fused = ltt_vit.ltt_vit_final_fwd(model, cfg, _t(pixels),
                                                  _t(mask))
    if int8:
        assert float((attr - attr_fused).abs().max()) > 1e-6


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("floor", [64, 128])
def test_ltt_bert_final_under_the_fused_floor(monkeypatch, int8_codes, floor,
                                              int8):
    """The mini LTT BERT (hidden 64, 32-wide ladders) under floors 64 (side
    layers and ladders unfused) and 128 (every layer unfused)."""
    _set_env(monkeypatch, "2", int8)
    monkeypatch.setenv("AUTOGNOTHI_FUSED_MIN_HIDDEN", str(floor))
    widths = _fused_widths(monkeypatch)
    jcfg, flat = _bert_params(seed=1)
    rng = np.random.RandomState(52)
    ids = rng.randint(1, BERT_MINI["vocab_size"], (3, 32)).astype(np.int64)
    mask = np.ones((3, 32), np.int64)
    mask[:, 1:] = rng.rand(3, 31) > 0.4
    ttype = np.zeros_like(ids)
    want_logits, want_attr, _ = j_ltt_bert.ltt_bert_final_fwd(
        {k: _j(v) for k, v in flat.items()}, jcfg, _j(ids), _j(mask),
        _j(ttype))
    cfg = LttBertConfig(**BERT_MINI)
    model = from_jax_params(flat, cfg, CPU)
    with torch.inference_mode():
        logits, attr = ltt_bert_final_fwd(model, cfg, _t(ids), _t(mask),
                                          _t(ttype))
    assert set(widths) == ({64} if floor == 64 else set())
    tol = _tolerance(int8)
    _close(logits.numpy(), want_logits, tol, "logits")
    _close(attr.numpy(), want_attr, tol, "attributions")


# --------------------------------------------------- the weight-code cache


def test_weight_codes_equal_quant_cols_and_are_kept():
    g = torch.Generator().manual_seed(0)
    wq, wk, wv = (torch.randn(24, 16, generator=g) for _ in range(3))
    codes, scales = wc.weight_codes((wq, wk, wv), torch.float32)
    want_q, want_s = quant_cols(torch.cat([wq, wk, wv]))
    assert torch.equal(codes, want_q) and torch.equal(scales, want_s)
    # the stacked codes are each weight's own
    q_k, s_k = quant_cols(wk)
    assert torch.equal(codes[24:48], q_k) and torch.equal(scales[24:48], s_k)
    again = wc.weight_codes((wq, wk, wv), torch.float32)
    assert again[0] is codes and again[1] is scales
    # the cast is part of the key: bf16 codes are those of the cast weights
    q16, s16 = wc.weight_codes((wq,), torch.bfloat16)
    want16 = quant_cols(wq.to(torch.bfloat16))
    assert torch.equal(q16, want16[0]) and torch.equal(s16, want16[1])


def test_weight_codes_follow_in_place_updates():
    g = torch.Generator().manual_seed(1)
    w = torch.nn.Parameter(torch.randn(8, 32, generator=g))
    first = wc.weight_codes((w,), torch.float32)
    with torch.no_grad():
        w.add_(torch.randn(8, 32, generator=g))  # an optimizer step
    second = wc.weight_codes((w,), torch.float32)
    assert second[0] is not first[0]
    assert torch.equal(second[0], quant_cols(w.detach())[0])
    with torch.no_grad():
        w.copy_(torch.randn(8, 32, generator=g) * 3)  # a checkpoint load
    third = wc.weight_codes((w,), torch.float32)
    assert torch.equal(third[0], quant_cols(w.detach())[0])
    assert torch.equal(third[1], quant_cols(w.detach())[1])


def test_weight_codes_of_a_new_tensor_at_a_reused_address():
    """Another tensor over the same memory, its values written where no
    version counter sees it, is another weight: it gets its own codes."""
    rng = np.random.RandomState(2)
    arr = rng.randn(8, 32).astype(np.float32)
    w = torch.from_numpy(arr)
    old = wc.weight_codes((w,), torch.float32)[0].clone()
    arr[:] = rng.randn(8, 32)  # no version bump
    for _ in range(2):  # w alive, then dead (its id free to be reused)
        w2 = torch.from_numpy(arr)
        assert w2.data_ptr() == w.data_ptr() and w2._version == w._version
        got = wc.weight_codes((w2,), torch.float32)[0]
        assert torch.equal(got, quant_cols(w2)[0])
        assert not torch.equal(got, old)
        del w, w2
        gc.collect()
        w = torch.from_numpy(arr)
        old = wc.weight_codes((w,), torch.float32)[0].clone()
        arr[:] = rng.randn(8, 32)


def test_weight_codes_of_column_slices_key_on_the_weight():
    """The K8q chain's W2 column slice is a new view at each call: its
    codes are kept per slice of the weight it views, and recomputed when
    that weight changes in place."""
    g = torch.Generator().manual_seed(3)
    w = torch.nn.Parameter(torch.randn(8, 32, generator=g))

    def codes(lo):
        with torch.no_grad():
            view = w[:, lo:lo + 8]  # as `_tiled` slices the weight
            assert view._base is w
            return wc.weight_codes((view,), torch.float32)[0], \
                quant_cols(view)[0]

    first, want = codes(8)
    assert torch.equal(first, want)
    assert codes(8)[0] is first
    other, want = codes(16)
    assert torch.equal(other, want) and not torch.equal(other, first)
    with torch.no_grad():
        w.mul_(-2)
    after, want = codes(8)
    assert torch.equal(after, want) and not torch.equal(after, first)


def test_weight_codes_keep_no_weight_alive():
    w = torch.randn(16, 16)
    ref = weakref.ref(w)
    before = wc.size()
    wc.weight_codes((w,), torch.float32)
    assert wc.size() == before + 1
    del w
    gc.collect()
    assert ref() is None
    assert wc.size() == before


def test_packed_bias_is_the_fp32_concatenation():
    bq, bk, bv = (torch.randn(8, dtype=torch.bfloat16) for _ in range(3))
    got = wc.packed_bias((bq, bk, bv))
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.cat([bq, bk, bv]).float())
    assert wc.packed_bias((bq, bk, bv)) is got
    with torch.no_grad():
        bk.mul_(2)
    assert torch.equal(wc.packed_bias((bq, bk, bv)),
                       torch.cat([bq, bk, bv]).float())


def test_weight_codes_of_inference_tensors_are_not_kept():
    with torch.inference_mode():
        w = torch.randn(8, 16)
    before = wc.size()
    q, s = wc.weight_codes((w,), torch.float32)
    assert wc.size() == before and torch.equal(q, quant_cols(w)[0])
