"""Port parity, the LTT BERT slice: the JAX budget gates that choose
arithmetic, the int8 split MLP (K8q) chain, the ladder op with the "add"
bias and post-norm (K5), one full-width BERT-base layer at T = 512, the
mini LTT BERT final forward, the tokenizer and `serve` of `texts`, against
the JAX package on the same numpy inputs on the CPU (its Pallas kernels in
interpret mode, as `tests/test_int8_kernels.py` runs them).

Tolerances, x max(1, max|ref|): fp32 float paths 1e-5 against the XLA
math (sums in another order), 1e-4 against interpreted kernels (their
GELU carries the A&S erf, max error 1.5e-7); int8 paths 2e-5
(`tests/test_torch_port_int8.py`: the quantizers match bit for bit and
the products are exact, so what differs is the erf and the float sums
around them).  Those last-bit differences put a value on the other side
of a rounding boundary now and then, and a flipped int8 code moves its
row by a quantization step.  So the int8 model tests record every
per-token code array both packages compute (`int8_codes`) and hold a
forward, or a row, whose codes all agree to 2e-5; where a code differs,
the bound is 1e-2, the int8 ops' bound on the card.
"""

import json
import pathlib
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autognothi_tpu.ops.attention_block as j_ab
import autognothi_tpu.ops.head_block as j_hb
import autognothi_tpu.ops.ladder_block as j_lb
import autognothi_tpu.ops.mlp_block as j_mb
from autognothi_tpu.models import bert as j_bert
from autognothi_tpu.models import ltt_bert as j_ltt
from autognothi_tpu.models.common import \
    additive_mask_bias as j_additive_mask_bias
from autognothi_tpu_torch.models.bert import BertLayer
from autognothi_tpu_torch.models.common import additive_mask_bias
from autognothi_tpu_torch.models.ltt_bert import (LttBert, LttBertConfig,
                                                  ltt_bert_final_fwd)
from autognothi_tpu_torch.ops import gates
from autognothi_tpu_torch.ops import head_block as hb
from autognothi_tpu_torch.ops import mlp_block as mb
from autognothi_tpu_torch.ops.ladder_block import ladder_block
from autognothi_tpu_torch.params import from_jax_params, to_flat
from tests.test_torch_port_ops import _branch, _np

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL_FP32, TOL_INTERPRET, TOL_INT8 = 1e-5, 1e-4, 2e-5
TOL_FLIPPED = 1e-2  # an int8 forward in which a code differs
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
MINI = dict(
    attention_probs_dropout_prob=0.1, explainer_s_attn_num_layers=1,
    explainer_s_head_hidden_size=64, explainer_normalize=True,
    hidden_dropout_prob=0.1, hidden_size=64, intermediate_size=128,
    layer_norm_eps=1e-12, max_position_embeddings=32,
    num_attention_heads=4, num_hidden_layers=2, num_labels=3,
    pad_token_id=0, s_attn_hidden_size=32, s_attn_intermediate_size=64,
    type_vocab_size=2, vocab_size=150)
# a budget under which the mini model takes every fallback: float trunk
# attention under int8 (the int8 block needs 98,304 B), a 2-tile int8 and
# 4-tile fp32 trunk MLP, per-branch side layers (the ladder op needs
# 102,400 B) and the eager W8A8 head (92,160 B)
SMALL_BUDGET = 60000


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(a)


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"{what}: max|port-jax| {err} > {bound}"


def _set_env(monkeypatch, pallas, int8):
    monkeypatch.setenv("AUTOGNOTHI_PALLAS", pallas)
    monkeypatch.setenv("AUTOGNOTHI_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("AUTOGNOTHI_INT8", "1" if int8 else "0")


def _set_budget(monkeypatch, budget):
    for mod in (j_ab, j_mb, j_lb, j_hb):
        monkeypatch.setattr(mod, "_VMEM_BUDGET_BYTES", budget)
    monkeypatch.setattr(gates, "VMEM_BUDGET_BYTES", budget)


# every per-token int8 code array each package computes, in call order,
# as <rows, width> numpy arrays; one module-level recorder, so a kernel
# whose interpreted trace JAX reuses still records here
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
    """Routes both packages' row quantizer (every activation quantization
    of the int8 ops and of `dense_serving`) through the recorder."""
    for side in CODES.values():
        side.clear()
    for mod in (mb, hb):
        monkeypatch.setattr(mod, "_quant_rows", _port_quant_rows)
    for mod in (j_mb, j_hb):
        monkeypatch.setattr(mod, "_quant_rows", _jax_quant_rows)
    return CODES


def _recorded_codes():
    jax.effects_barrier()
    return CODES["port"], CODES["jax"]


# ---------------------------------------------------------------- gates

# (name, T, hidden, MLP width, heads, side width, side MLP width)
SHAPES = {
    "bert-base@512": (512, 768, 3072, 12, 96, 384),
    "bert side@512": (512, 96, 384, 12, 96, 384),
    "vit-b@197": (197, 768, 3072, 12, 96, 384),
    "vit-l@197": (197, 1024, 4096, 16, 96, 384),
}


def _jax_mlp_tiles(monkeypatch, t, h, inter, dtype, quant):
    """The split the JAX `mlp_block` takes, read off the function itself
    under `jax.eval_shape` (its kernels stubbed out)."""
    seen = {}

    def fused(*_a, **_k):
        seen["n"] = 1
        return lambda *args: args[0]

    def tiled(*args, **_k):
        seen["n"] = args[9]
        return args[0]

    def xla(*args, **_k):
        seen["n"] = None
        return args[0]

    monkeypatch.setattr(j_mb, "_make_block_fn", fused)
    monkeypatch.setattr(j_mb, "_tiled_mlp", tiled)
    monkeypatch.setattr(j_mb, "_xla_mlp_block", xla)
    dt = JAX_DTYPES[dtype]
    jax.eval_shape(
        lambda r, w1, b1, w2, b2: j_mb.mlp_block(
            r, w1, b1, w2, b2, use_pallas=True, quant=quant),
        jax.ShapeDtypeStruct((1, t, h), dt),
        jax.ShapeDtypeStruct((inter, h), jnp.float32),
        jax.ShapeDtypeStruct((inter,), jnp.float32),
        jax.ShapeDtypeStruct((h, inter), jnp.float32),
        jax.ShapeDtypeStruct((h,), jnp.float32))
    return seen["n"]


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_gates_equal_jax(monkeypatch, shape, dtype, quant):
    t, h, inter, heads, s, s_inter = SHAPES[shape]
    tdt = getattr(torch, dtype)
    resid = jax.ShapeDtypeStruct((1, t, h), JAX_DTYPES[dtype])
    assert gates.attention_block_fits(t, h, tdt, quant) == \
        j_ab._fits_vmem(resid, quant)
    assert gates.mlp_block_tiles(t, h, inter, tdt, quant) == \
        _jax_mlp_tiles(monkeypatch, t, h, inter, dtype, quant)
    for n_branches in (1, 2):
        assert gates.ladder_block_fits(h, t, s, heads, n_branches) == \
            j_lb.ladder_fits_vmem(h, t, s, heads, n_branches)
    for h_in, c in ((s, 2), (s, 1000), (h, 10)):
        assert gates.head_token_tile(t, h_in, inter, c) == \
            j_hb._pick_tile(t, h_in, inter, c)


def test_gates_bert_base_decisions():
    """The decisions at BERT-base T = 512 that change the arithmetic, and
    ViT-B T = 197's, which do not (all fused; the fp32 float MLP splits)."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert not gates.attention_block_fits(512, 768, f32, "int8")
    assert gates.attention_block_fits(512, 768, bf16, "int8")
    assert not gates.attention_block_fits(512, 768, f32, "none")
    assert gates.mlp_block_tiles(512, 768, 3072, f32, "int8") == 2
    assert gates.mlp_block_tiles(512, 768, 3072, bf16, "int8") == 2
    assert gates.mlp_block_tiles(512, 768, 3072, f32, "none") == 4
    assert gates.ladder_block_fits(768, 512, 96, 12, 2)
    assert gates.head_token_tile(512, 96, 3072, 2) == 128
    assert gates.attention_block_fits(197, 768, f32, "int8")
    assert gates.mlp_block_tiles(197, 768, 3072, f32, "int8") == 1
    assert gates.mlp_block_tiles(197, 768, 3072, f32, "none") == 2
    assert gates.mlp_block_tiles(197, 96, 384, f32, "int8") == 1
    assert gates.head_token_tile(197, 96, 3072, 10) == 128


# ----------------------------------------------------------------- ops

B, T, H, INTER, HEADS, S = 2, 17, 32, 64, 4, 16


@pytest.mark.parametrize("ln_position", ["epilogue", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_tiles", [2, 4, 8])
def test_k8q_chain_matches_jax(n_tiles, dtype, ln_position):
    rng = np.random.RandomState(30 + n_tiles)
    resid = _np(rng, B, T, H, scale=0.5)
    w1, b1 = _np(rng, INTER, H, scale=0.15), _np(rng, INTER, scale=0.15)
    w2, b2 = _np(rng, H, INTER, scale=0.15), _np(rng, H, scale=0.15)
    lnw, lnb = 1 + _np(rng, H, scale=0.1), _np(rng, H, scale=0.1)
    tdt, jdt = getattr(torch, dtype), JAX_DTYPES[dtype]
    ln_on = ln_position != "none"
    got = mb.mlp_block_int8_tiled(
        _t(resid).to(tdt), _t(w1), _t(b1), _t(w2), _t(b2),
        ln=(_t(lnw), _t(lnb), 1e-12) if ln_on else None,
        ln_position=ln_position, n_tiles=n_tiles)
    ones, zeros = jnp.ones((H,), jdt), jnp.zeros((H,), jdt)
    want = j_mb._tiled_mlp(
        _j(resid).astype(jdt), _j(w1).T.astype(jdt), _j(b1),
        _j(w2).T.astype(jdt), _j(b2), _j(lnw) if ln_on else ones,
        _j(lnb) if ln_on else zeros, ln_position, 1e-12, n_tiles,
        interpret=True, quant="int8")
    assert got.dtype == tdt
    _close(got.float().numpy(), np.asarray(want, np.float32), TOL_INT8,
           f"K8q x{n_tiles}")
    # each tile re-quantizes its own slice: not the unsplit K4's numbers
    one = mb.mlp_block(_t(resid).to(tdt), _t(w1), _t(b1), _t(w2), _t(b2),
                       ln=(_t(lnw), _t(lnb), 1e-12) if ln_on else None,
                       ln_position=ln_position, quant="int8")
    assert float((got.float() - one.float()).abs().max()) > 1e-6


def test_k8_float_split_is_the_one_pass_block_in_fp32():
    """The float split only reorders an fp32 sum: the one-pass block is
    within 1e-5 of JAX `_tiled_mlp(n_tiles=4)`."""
    rng = np.random.RandomState(40)
    resid = _np(rng, B, T, H, scale=0.5)
    w1, b1 = _np(rng, INTER, H, scale=0.15), _np(rng, INTER, scale=0.15)
    w2, b2 = _np(rng, H, INTER, scale=0.15), _np(rng, H, scale=0.15)
    lnw, lnb = 1 + _np(rng, H, scale=0.1), _np(rng, H, scale=0.1)
    tensors, static = mb.mlp_block_args(
        _t(resid), _t(w1), _t(b1), _t(w2), _t(b2),
        ln=(_t(lnw), _t(lnb), 1e-12), ln_position="epilogue")
    got = mb.mlp_block_plain(*tensors, **static)
    want = j_mb._tiled_mlp(_j(resid), _j(w1).T, _j(b1), _j(w2).T, _j(b2),
                           _j(lnw), _j(lnb), "epilogue", 1e-12, 4,
                           interpret=True)
    _close(got.numpy(), want, TOL_FP32, "K8 fp32")


@pytest.mark.parametrize("mask_kind", ["ones", "random"])
def test_ladder_add_post_norm_matches_jax(mask_kind):
    rng = np.random.RandomState(41)
    h = _np(rng, B, T, H, scale=0.5)
    sides = [_np(rng, B, T, S, scale=0.5) for _ in range(2)]
    branches = [_branch(rng), _branch(rng)]
    m01 = np.ones((B, T), np.float32)
    if mask_kind == "random":
        m01 = (rng.rand(B, T) > 0.4).astype(np.float32)
    bias = additive_mask_bias(_t(m01))[:, 0, 0, :]
    np.testing.assert_array_equal(
        bias.numpy(), np.asarray(j_additive_mask_bias(_j(m01)))[:, 0, 0, :])
    got = ladder_block(_t(h), [_t(s) for s in sides], bias,
                       [{k: _t(v) for k, v in b.items()} for b in branches],
                       HEADS, "add", False, 1e-12)
    want = j_lb.ladder_block(_j(h), [_j(s) for s in sides],
                             _j(bias.numpy()),
                             [{k: _j(v) for k, v in b.items()}
                              for b in branches],
                             HEADS, "add", False, 1e-12, use_pallas=True,
                             interpret=True)
    for s in range(2):
        _close(got[s].numpy(), want[s], TOL_INTERPRET, f"K5 branch {s}")


# -------------------------------------------------------------- models


def _layer_params(rng, h, inter):
    p = {}
    for name in ("query", "key", "value"):
        p[f"attention.self.{name}.weight"] = _np(rng, h, h, scale=h ** -0.5)
        p[f"attention.self.{name}.bias"] = _np(rng, h, scale=0.05)
    p["attention.output.dense.weight"] = _np(rng, h, h, scale=h ** -0.5)
    p["attention.output.dense.bias"] = _np(rng, h, scale=0.05)
    p["intermediate.dense.weight"] = _np(rng, inter, h, scale=h ** -0.5)
    p["intermediate.dense.bias"] = _np(rng, inter, scale=0.05)
    p["output.dense.weight"] = _np(rng, h, inter, scale=inter ** -0.5)
    p["output.dense.bias"] = _np(rng, h, scale=0.05)
    for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
        p[f"{ln}.weight"] = 1 + _np(rng, h, scale=0.1)
        p[f"{ln}.bias"] = _np(rng, h, scale=0.1)
    return p


def test_bert_base_layer_at_512_matches_jax(monkeypatch, int8_codes):
    """One full-width layer, B = 1, fp32 with AUTOGNOTHI_INT8=1: the real
    gates send the attention to the float block and the MLP to the 2-tile
    K8q chain, on both sides.  The attention half matches at the fp32
    tolerance.  The layer: each row whose int8 codes (the MLP input and
    both tiles' intermediates, per token) agree with JAX's matches at
    TOL_INT8; a row with a flipped code within TOL_FLIPPED (the MLP works
    token by token, so a flip moves its own row only).  A flip is a value
    on the other side of a rounding boundary: the codes that differ are
    neighbours, in the input and, on rows whose input codes agree, in the
    intermediates."""
    _set_env(monkeypatch, "2", True)
    rng = np.random.RandomState(42)
    t, h, inter = 512, 768, 3072
    params = _layer_params(rng, h, inter)
    x = _np(rng, 1, t, h)
    m01 = (rng.rand(1, t) > 0.3).astype(np.float32)
    m01[:, 0] = 1
    calls = {"tiles": 0}
    tile = mb.mlp_tile_int8_plain

    def counted(*args):
        calls["tiles"] += 1
        return tile(*args)

    def refuse(*_a, **_k):
        raise AssertionError("the int8 attention block ran")

    from autognothi_tpu_torch.ops import attention_block as ab

    monkeypatch.setattr(mb, "mlp_tile_int8_plain", counted)
    monkeypatch.setattr(ab, "attention_block_int8_plain", refuse)
    cfg = LttBertConfig(**dict(MINI, hidden_size=h, intermediate_size=inter,
                               num_attention_heads=12,
                               max_position_embeddings=t)).into()
    layer = BertLayer(h, inter)
    layer.load_state_dict({k: _t(v) for k, v in params.items()})
    names = ("query", "key", "value")
    weights = [params[f"attention.self.{n}.{wb}"] for n in names
               for wb in ("weight", "bias")]
    weights += [params[f"attention.output.dense.{wb}"]
                for wb in ("weight", "bias")]
    ln1 = [params[f"attention.output.LayerNorm.{wb}"]
           for wb in ("weight", "bias")]
    bias = additive_mask_bias(_t(m01))
    with torch.inference_mode():
        got_attn = ab.attention_block(
            _t(x), bias[:, 0, 0, :], tuple(map(_t, weights)), 12, "add",
            ln=(*map(_t, ln1), 1e-12), ln_position="epilogue", quant="int8")
        got = layer(_t(x), bias, cfg)
    want_attn = j_ab.attention_block(
        _j(x), _j(bias.numpy())[:, 0, 0, :], tuple(map(_j, weights)), 12,
        "add", use_pallas=True, ln=(*map(_j, ln1), 1e-12),
        ln_position="epilogue", interpret=True, quant="int8")
    _close(got_attn.numpy(), want_attn, TOL_FP32, "attention half")
    want = np.asarray(j_bert._bert_layer_body(
        {k: _j(v) for k, v in params.items()}, _j(x),
        j_additive_mask_bias(_j(m01)), j_bert.VanillaBertConfig(
            **{k: getattr(cfg, k) for k in cfg.__dataclass_fields__}),
        ident_ln1=False, deterministic=True, rng=None))
    assert calls["tiles"] == 2
    port, jax_ = _recorded_codes()
    # per tile: x, then the intermediate; each <512, width>
    assert [c.shape for c in port] == [c.shape for c in jax_] == \
        [(t, h), (t, inter // 2)] * 2
    steps = [np.abs(p_codes.astype(np.int32) - j_codes.astype(np.int32))
             for p_codes, j_codes in zip(port, jax_)]
    x_flipped = steps[0].any(axis=-1)
    assert steps[0].max() <= 1 and (steps[2] == steps[0]).all()
    assert max(steps[1][~x_flipped].max(), steps[3][~x_flipped].max()) <= 1
    flipped = np.any([d.any(axis=-1) for d in steps], axis=0)
    scale = max(1.0, float(np.abs(want).max()))
    err = np.abs(got.numpy() - want).max(axis=-1)[0]  # per row
    assert err[~flipped].max() <= TOL_INT8 * scale, err[~flipped].max()
    assert err.max() <= TOL_FLIPPED * scale, (err.max(), flipped.sum())


def _mini_params(seed=0):
    cfg = j_ltt.LttBertConfig(**MINI)
    p = j_ltt.init_ltt_bert_final(jax.random.PRNGKey(seed), cfg)
    p["surrogate_null"] = jnp.asarray([[0.2, 0.3, 0.5]])
    return cfg, {k: np.asarray(v) for k, v in p.items()}


def test_ltt_bert_params_load_strictly_and_init_matches_keys():
    _, flat = _mini_params()
    model = from_jax_params(flat, LttBertConfig(**MINI), CPU)
    back = to_flat(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    mine = LttBert(LttBertConfig(**MINI))
    mine.reset_parameters(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in to_flat(mine).items()} == \
        {k: v.shape for k, v in flat.items()}
    assert not to_flat(mine)["bert.embeddings.word_embeddings.weight"][0].any()
    flat.pop("s_attn_attention_layers.0.output.LayerNorm.bias")
    with pytest.raises(RuntimeError):
        from_jax_params(flat, LttBertConfig(**MINI), CPU)


@pytest.mark.parametrize("mask_kind", ["ones", "random"])
@pytest.mark.parametrize("pallas,int8,budget,seed", [
    ("0", False, None, 51), ("0", True, None, 51), ("2", False, None, 51),
    ("2", True, None, 51), ("2", True, None, 46),
    ("2", False, SMALL_BUDGET, 51), ("2", True, SMALL_BUDGET, 51),
    ("2", True, SMALL_BUDGET, 41)])
def test_ltt_bert_final_fwd_matches_jax(monkeypatch, int8_codes, pallas,
                                        int8, budget, seed, mask_kind):
    """The mini final against JAX.  Where the two forwards computed the
    same int8 codes (the same multiset of per-token code rows: the JAX
    kernels quantize block by block) the outputs agree at the path's
    tolerance; where a code differs, within TOL_FLIPPED."""
    _set_env(monkeypatch, pallas, int8)
    if budget is not None:
        _set_budget(monkeypatch, budget)
    jcfg, flat = _mini_params(seed=1)
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, MINI["vocab_size"], (3, 32)).astype(np.int64)
    mask = np.ones((3, 32), np.int64)
    if mask_kind == "random":
        mask[:, 1:] = rng.rand(3, 31) > 0.4
    ttype = np.zeros_like(ids)
    want_logits, want_attr, _ = j_ltt.ltt_bert_final_fwd(
        {k: _j(v) for k, v in flat.items()}, jcfg, _j(ids), _j(mask),
        _j(ttype))
    cfg = LttBertConfig(**MINI)
    model = from_jax_params(flat, cfg, CPU)
    with torch.inference_mode():
        logits, attr = ltt_bert_final_fwd(model, cfg, _t(ids), _t(mask),
                                          _t(ttype))
    assert attr.shape == (3, 3, 31)
    tol = TOL_INT8 if int8 and pallas == "2" else (
        TOL_FP32 if pallas == "0" else TOL_INTERPRET)
    port, jax_ = _recorded_codes()
    assert sum(len(c) for c in port) == sum(len(c) for c in jax_)
    if not int8:
        assert not port
    rows = {side: sorted(r.tobytes() for c in codes for r in c)
            for side, codes in (("port", port), ("jax", jax_))}
    if rows["port"] != rows["jax"]:
        tol = TOL_FLIPPED
    _close(logits.numpy(), want_logits, tol, "logits")
    _close(attr.numpy(), want_attr, tol, "attributions")


# ------------------------------------------------------- tokenizer, serve


def _corpus():
    return [s["inputs"] for s in json.loads(
        (REPO / "autognothi_tpu/data/nlp_samples.json").read_text())]


def test_tokenizer_ids_equal_jax():
    from autognothi_tpu.data import tokenizer as j_tok
    from autognothi_tpu_torch.data import tokenizer as tok

    texts = _corpus()
    vocab = tok.build_vocab(texts, max_size=150)
    assert vocab == j_tok.build_vocab(texts, max_size=150)
    extra = ["", "Déjà vu, naïve café!", "x" * 120, "unseenword " * 40]
    for length in (16, 64):
        got = tok.encode_batch(tok.WordPieceTokenizer(vocab), texts + extra,
                               length)
        want = j_tok.encode_batch(j_tok.WordPieceTokenizer(vocab),
                                  texts + extra, length)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)


def _write_bert_exp(root: pathlib.Path) -> pathlib.Path:
    from autognothi_tpu.pipeline.resources import save_params
    from autognothi_tpu_torch.data.tokenizer import (WordPieceTokenizer,
                                                     build_vocab)

    exp = root / "ltt_bert"
    exp.mkdir()
    hp = json.loads((REPO / "experiments" / "bert_base_tayp_ltt"
                     / ".hparams.json").read_text())
    vocab = build_vocab(_corpus(), max_size=MINI["vocab_size"])
    assert len(vocab) == MINI["vocab_size"]
    WordPieceTokenizer(vocab).save(exp / "tokenizer")
    hp["net"]["params"] = dict(MINI)
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    _, flat = _mini_params(seed=2)
    save_params(exp / "final-epoch-0.ckpt", flat)
    return exp


def test_cpu_serve_texts(tmp_path):
    """`serve --device cpu` of an `ltt_bert` experiment answers `texts`
    requests of 3 rows (one slab) and 9 rows (two slabs of 8) with the
    plain forward of its model and with the JAX final on the same ids."""
    from autognothi_tpu.recipes.ltt_bert import fw_final as j_fw_final
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import serve_in_thread

    exp = _write_bert_exp(tmp_path)
    env = ExpEnv(exp)
    server, service, thread = serve_in_thread(env, port=0, batch_size=8,
                                              device="cpu")
    texts = _corpus()
    got = {}
    try:
        for n in (3, 9):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/explain",
                data=json.dumps({"texts": texts[:n]}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                got[n] = json.loads(resp.read())
        slabs = service._batcher.stats()["slabs"]
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        env.close()
    assert slabs == 1 + 2  # 3 rows, 9 rows
    _, flat = _mini_params(seed=2)
    for n, body in got.items():
        logits = np.asarray(body["logits"], np.float32)
        attr = np.asarray(body["attributions"], np.float32)
        assert logits.shape == (n, 3) and attr.shape == (n, 3, 31)
        np.testing.assert_allclose(logits.sum(-1), np.ones(n), atol=1e-5)
        ids, _ = service.gen_input(texts[:n], [0] * n)
        with torch.inference_mode():
            want = service.recipe.fw_final(service.m_config, service.model,
                                           _t(ids))
        np.testing.assert_allclose(logits, want[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(attr, want[1].numpy(), atol=1e-6)
        j_logits, j_attr = j_fw_final(
            j_ltt.LttBertConfig(**MINI), {k: _j(v) for k, v in flat.items()},
            _j(ids))
        _close(logits, j_logits, TOL_FP32, "served logits vs JAX")
        _close(attr, j_attr, TOL_FP32, "served attributions vs JAX")
