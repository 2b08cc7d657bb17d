"""The int8 MLP block (K4) and explainer head (K3) of the port at full width,
against the JAX package's int8 Pallas kernels in interpret mode on the CPU,
and the rules that shape their kernels on the card.

K4's design on the card is picked by a plain shape rule
(`mlp_block.k4_design`): held here over every MLP width of the repo's
configurations.  K3 folds its float d3 into d2's epilogue for up to
`I8_MAX_FOLD` classes and refuses more before it launches anything.

The full-width parity cases (K4 at 768/3072 on one image of 197 tokens,
K3 at 96-3072-3072-C on 128 tokens) record every per-token int8 code
array both packages compute (both `_quant_rows` patched): a row whose
codes all agree is held at TOL = 2e-5, the tolerance of the mini cases of
`tests/test_torch_port_int8.py`; a row with a flipped code (a value that
the packages' GELUs, A&S erf against the exact one, or their LayerNorm
sums put on the two sides of a rounding boundary) at 1e-2, the int8 ops'
bound on the card.  At these widths such flips are expected (hundreds of
thousands of codes per call); a case where more than a tenth of the rows
flipped fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autognothi_tpu.ops.head_block as j_hb
import autognothi_tpu.ops.mlp_block as j_mb
from autognothi_tpu_torch.kernels.primitives import I8_MAX_FOLD
from autognothi_tpu_torch.ops import gates
from autognothi_tpu_torch.ops import head_block as hb
from autognothi_tpu_torch.ops import mlp_block as mb
from tests.test_torch_port_cuda import config_head_shapes, config_mlp_widths
from tests.test_torch_port_ops import _np

TOL, TOL_FLIPPED = 2e-5, 1e-2
MAX_FLIPPED_ROWS = 0.1

# every per-token int8 code array each package computes, in call order,
# as <rows, width> numpy arrays
CODES = {"port": [], "jax": []}
_PORT_QUANT_ROWS, _JAX_QUANT_ROWS = mb._quant_rows, j_mb._quant_rows


def _record(side, q):
    q = np.asarray(q)
    CODES[side].append(q.reshape(-1, q.shape[-1]))


def _port_quant_rows(x32):
    q, s = _PORT_QUANT_ROWS(x32)
    _record("port", q)
    return q, s


def _jax_quant_rows(x32):
    q, s = _JAX_QUANT_ROWS(x32)
    jax.debug.callback(_record, "jax", q)
    return q, s


@pytest.fixture
def int8_codes(monkeypatch):
    """Routes both packages' row quantizer through the recorder."""
    for side in CODES.values():
        side.clear()
    for mod in (mb, hb):
        monkeypatch.setattr(mod, "_quant_rows", _port_quant_rows)
    for mod in (j_mb, j_hb):
        monkeypatch.setattr(mod, "_quant_rows", _jax_quant_rows)
    return CODES


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(a)


def _hold_rows(got, want, rows):
    """Each row within TOL where the two packages' codes of that row agree
    in every recorded array, within TOL_FLIPPED where one differs."""
    jax.effects_barrier()
    port, jax_ = CODES["port"], CODES["jax"]
    assert port and [c.shape for c in port] == [c.shape for c in jax_]
    flipped = np.zeros(rows, bool)
    for p, j in zip(port, jax_):
        flipped |= (p != j).any(axis=-1)
    got = np.asarray(got, np.float32).reshape(rows, -1)
    want = np.asarray(want, np.float32).reshape(rows, -1)
    scale = max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want).max(axis=-1)
    assert flipped.mean() <= MAX_FLIPPED_ROWS, flipped.sum()
    if (~flipped).any():
        assert err[~flipped].max() <= TOL * scale, err[~flipped].max()
    assert err.max() <= TOL_FLIPPED * scale, err.max()


# ---------------------------------------------------------- K4's design


@pytest.mark.parametrize("h,inter", config_mlp_widths())
def test_k4_design_rule_over_the_config_widths(h, inter):
    """The narrow one-launch K4 where a 64-row block holds both weights'
    codes and whole intermediate rows in shared memory (the LTT sides of
    ViT-B / BERT-base and of ViT-L); every trunk width, and the sides the
    narrow kernel is not built for, take the three-launch trunk design."""
    narrow = (h, inter) in ((96, 384), (128, 512))
    assert mb.k4_design(h, inter) == ("narrow" if narrow else "trunk")
    # the rule depends on the widths only
    assert mb.k4_design(h, inter) == mb.k4_design(int(h), int(inter))


def test_k4_design_covers_the_main_paths():
    """The ViT-B and BERT-base side layers take the narrow design, their
    trunk MLPs (and the int8 teacher's) the trunk design."""
    widths = config_mlp_widths()
    assert (96, 384) in widths and (768, 3072) in widths
    assert mb.k4_design(96, 384) == "narrow"
    assert mb.k4_design(768, 3072) == "trunk"
    assert mb.k4_design(1024, 4096) == "trunk"


@pytest.mark.parametrize("c", [I8_MAX_FOLD + 1, 1000])
def test_k3_fold_refuses_more_classes_before_launching(c):
    """K3's card version folds d3 into d2's epilogue for up to
    I8_MAX_FOLD classes; with more it raises ValueError before it launches
    anything (here on CPU tensors, which never reach a kernel)."""
    rng = np.random.RandomState(30)
    x = _t(_np(rng, 1, 3, 32))
    ws = [_t(_np(rng, *s)) for s in ((64, 32), (64,), (64, 64), (64,),
                                     (c, 64), (c,))]
    ones, zeros = torch.ones(32), torch.zeros(32)
    with pytest.raises(ValueError, match=f"at most {I8_MAX_FOLD} classes"):
        hb.head_int8_launch(x, *ws, ones, zeros, has_ln=True, ln_eps=1e-5)


def test_k3_fold_takes_every_config_head():
    """Every head of the repo's configurations (2 and 10 classes) is one
    the fold takes."""
    import json
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "experiments"
    labels = {json.loads(p.read_text())["net"]["params"]["num_labels"]
              for p in root.glob("*/.hparams.json")}
    assert labels == {2, 10}
    assert max(labels) <= I8_MAX_FOLD


# ------------------------------------------- full-width parity with JAX


@pytest.mark.parametrize("ln_position", ["prologue", "epilogue"])
def test_mlp_block_int8_matches_jax_at_full_width(int8_codes, ln_position):
    """K4 at 768/3072 (the int8 teacher's trunk MLP; epilogue: BERT's
    post-norm), one image of 197 tokens, against the JAX int8 kernel."""
    rng = np.random.RandomState(31)
    b, t, h, inter = 1, 197, 768, 3072
    resid = _np(rng, b, t, h)
    w1, b1 = _np(rng, inter, h, scale=h ** -0.5), _np(rng, inter, scale=0.1)
    w2, b2 = _np(rng, h, inter, scale=inter ** -0.5), _np(rng, h, scale=0.1)
    lnw, lnb = 1 + _np(rng, h, scale=0.1), _np(rng, h, scale=0.1)
    with torch.inference_mode():
        got = mb.mlp_block(_t(resid), _t(w1), _t(b1), _t(w2), _t(b2),
                           ln=(_t(lnw), _t(lnb), 1e-12),
                           ln_position=ln_position, quant="int8")
    want = j_mb.mlp_block(_j(resid), _j(w1), _j(b1), _j(w2), _j(b2),
                          use_pallas=True, interpret=True, quant="int8",
                          ln=(_j(lnw), _j(lnb), 1e-12),
                          ln_position=ln_position)
    assert [c.shape for c in CODES["port"]] == [(t, h), (t, inter)]
    _hold_rows(got.numpy(), want, t)


@pytest.mark.parametrize("c,has_ln", [(10, True), (2, False)])
def test_explainer_head_block_matches_jax_at_full_width(int8_codes, c,
                                                        has_ln):
    """K3 at 96-3072-3072-C (ViT's head with LN, 10 classes; BERT's
    without, 2), 128 tokens, against the JAX int8 kernel."""
    rng = np.random.RandomState(32)
    t, h_in, inter = 128, 96, 3072
    x = _np(rng, 1, t, h_in)
    ws = (_np(rng, inter, h_in, scale=h_in ** -0.5),
          _np(rng, inter, scale=0.1),
          _np(rng, inter, inter, scale=inter ** -0.5),
          _np(rng, inter, scale=0.1), _np(rng, c, inter, scale=inter ** -0.5),
          _np(rng, c, scale=0.1))
    lnw, lnb = 1 + _np(rng, h_in, scale=0.1), _np(rng, h_in, scale=0.1)
    with torch.inference_mode():
        got = hb.explainer_head_block(
            _t(x), *map(_t, ws), _t(lnw) if has_ln else None,
            _t(lnb) if has_ln else None, 1e-5)
    want = j_hb.explainer_head_block(
        _j(x), *map(_j, ws), _j(lnw) if has_ln else None,
        _j(lnb) if has_ln else None, 1e-5, use_pallas=True, quant="int8",
        interpret=True)
    assert got.shape == (1, t, c)
    assert [c_.shape for c_ in CODES["port"]] == [(t, h_in), (t, inter)]
    _hold_rows(got.numpy(), want, t)


# ------------------------------------------------ K3's route (F11)


@pytest.mark.parametrize("t,h_in,inter,c", config_head_shapes()
                         + [(197, 96, 3072, 10)])
def test_k3_route_covers_every_head_the_jax_gate_admits(t, h_in, inter, c):
    """Every head of the repo's configurations (and the LTT ViT-B side
    head) that the JAX gate sends to the fused int8 head gets a route on
    the card, and none raises: the LTT side heads (96 wide) the narrow
    one-launch d1, the vanilla and froyo heads on the trunk's 192 to 768
    wide hidden state the wide d1.  The port's gate is the JAX one."""
    tile = gates.head_token_tile(t, h_in, inter, c)
    assert tile == j_hb._pick_tile(t, h_in, inter, c)
    if tile is None:  # ViT-L's 1024 -> 4096: the eager W8A8 denses
        assert (h_in, inter) == (1024, 4096)
        return
    route = hb.k3_route(h_in, inter, c)
    assert route == ("narrow" if h_in <= 128 else "wide")
    assert hb.k3_route(int(h_in), int(inter), int(c)) == route


def test_k3_route_table():
    """The shapes of the vanilla paths: ViT-B and BERT-base 768 -> 3072
    (F11: the narrow d1 refused any K past 128), ViT-S 384, ViT-T 192, the
    LTT sides' 96; more than I8_MAX_FOLD classes or a width that is not a
    multiple of 16 raise."""
    assert hb.k3_route(768, 3072, 10) == "wide"
    assert hb.k3_route(768, 3072, 2) == "wide"
    assert hb.k3_route(384, 1536, 10) == "wide"
    assert hb.k3_route(192, 768, 10) == "wide"
    assert hb.k3_route(96, 3072, 10) == "narrow"
    assert hb.k3_route(128, 4096, 2) == "narrow"
    with pytest.raises(ValueError, match="at most"):
        hb.k3_route(768, 3072, I8_MAX_FOLD + 1)
    with pytest.raises(ValueError, match="multiples of 16"):
        hb.k3_route(100, 3072, 10)


@pytest.mark.parametrize("h_in,inter", [(192, 768), (768, 3072)])
@pytest.mark.parametrize("has_ln", [True, False])
def test_explainer_head_block_matches_jax_at_wide_inputs(int8_codes,
                                                         monkeypatch, h_in,
                                                         inter, has_ln):
    """K3 at the vanilla heads' inputs (192 -> 768 -> 768 and 768 -> 3072
    -> 3072, 10 classes, with and without LN), 64 tokens, under
    AUTOGNOTHI_INT8=1, against the JAX int8 kernel in interpret mode."""
    monkeypatch.setenv("AUTOGNOTHI_INT8", "1")
    rng = np.random.RandomState(33)
    t, c = 64, 10
    x = _np(rng, 1, t, h_in)
    ws = (_np(rng, inter, h_in, scale=h_in ** -0.5),
          _np(rng, inter, scale=0.1),
          _np(rng, inter, inter, scale=inter ** -0.5),
          _np(rng, inter, scale=0.1), _np(rng, c, inter, scale=inter ** -0.5),
          _np(rng, c, scale=0.1))
    lnw, lnb = 1 + _np(rng, h_in, scale=0.1), _np(rng, h_in, scale=0.1)
    with torch.inference_mode():
        got = hb.explainer_head_block(
            _t(x), *map(_t, ws), _t(lnw) if has_ln else None,
            _t(lnb) if has_ln else None, 1e-5)
    want = j_hb.explainer_head_block(
        _j(x), *map(_j, ws), _j(lnw) if has_ln else None,
        _j(lnb) if has_ln else None, 1e-5, use_pallas=True, quant="int8",
        interpret=True)
    assert got.shape == (1, t, c)
    assert [q.shape for q in CODES["port"]] == [(t, h_in), (t, inter)]
    _hold_rows(got.numpy(), want, t)
