"""Port parity, the W8A8 int8 serving path (AUTOGNOTHI_INT8=1): the port's
quantizers, its int8 ops (K1 attention block, K4 MLP block, K2 trunk MLP +
ladders, K3 explainer head) and the int8 LTT ViT final forward, against
the JAX package's int8 Pallas kernels run in interpret mode on the CPU, on
the same numpy inputs in fp32.

The quantizers match bit for bit.  The ops and the model match within
TOL x max(1, max|ref|), TOL = 2e-5.  Why not bit-exact: the interpreted
kernels' GELU carries the A&S erf (max error 1.5e-7) where the port uses
the exact erf, and the packages' LayerNorm, softmax and float products sum
in different orders: a few fp32 ulps (measured worst: ops 1.7e-6, the
model 6e-8).  Those differences could put a value on the other side of a
rounding boundary, and one such flipped int8 code would move a product by
a quantization step of its row (max|row| / 127 times a weight, ~1e-3 at
these widths); no code flips at these seeds, so the bound does not
allow one.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autognothi_tpu.models import ltt_vit as jax_ltt
from autognothi_tpu.models.common import dense_serving as jax_dense_serving
from autognothi_tpu.ops.attention_block import attention_block as jax_attn
from autognothi_tpu.ops.head_block import \
    explainer_head_block as jax_head_block
from autognothi_tpu.ops.ladder_block import \
    mlp_ladder_block as jax_mlp_ladder
from autognothi_tpu.ops.mlp_block import _quant_rows as jax_quant_rows
from autognothi_tpu.ops.mlp_block import mlp_block as jax_mlp
from autognothi_tpu.ops.mlp_block import quant_cols as jax_quant_cols
from autognothi_tpu_torch.models.common import dense_serving, quant_mode
from autognothi_tpu_torch.models.ltt_vit import LttViTConfig, ltt_vit_final_fwd
from autognothi_tpu_torch.ops import head_block as hb
from autognothi_tpu_torch.ops.attention_block import (attention_block,
                                                      attention_block_plain)
from autognothi_tpu_torch.ops.ladder_block import mlp_ladder_block
from autognothi_tpu_torch.ops.mlp_block import (_quant_rows, mlp_block,
                                                quant_cols)
from autognothi_tpu_torch.params import from_jax_params
from tests.test_torch_port_model import MINI, _jax_params
from tests.test_torch_port_ops import _branch, _mask, _mlp_inputs, _np

B, T, H, HEADS, S = 2, 17, 32, 4, 16
TOL = 2e-5
JAX_INT8 = {"AUTOGNOTHI_PALLAS": "2", "AUTOGNOTHI_PALLAS_INTERPRET": "1",
            "AUTOGNOTHI_INT8": "1"}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(a)


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = tol * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"{what}: max|port-jax| {err} > {bound}"


# ------------------------------------------------------------ quantizers


def _bf16_valued(a):
    """fp32 values that bf16 holds exactly (the codes of bf16 weights)."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_cols_bit_exact(dtype):
    rng = np.random.RandomState(10)
    w = _np(rng, 48, 40, scale=0.3)  # torch (out, in)
    w[3] = 0.0  # an all-zero output channel: scale 1e-12, codes 0
    if dtype == "bfloat16":
        w = _bf16_valued(w)
        q, s = quant_cols(_t(w).to(torch.bfloat16))
    else:
        q, s = quant_cols(_t(w))
    jq, js = jax_quant_cols(_j(w).T)  # (in, out) in JAX
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_rows_bit_exact(dtype):
    rng = np.random.RandomState(11)
    x = _np(rng, 3, 7, 50, scale=2.0)
    x[1, 2] = 0.0  # an all-zero token
    if dtype == "bfloat16":
        x = _bf16_valued(x)
    q, s = _quant_rows(_t(x).to(getattr(torch, dtype)).float())
    jq, js = jax_quant_rows(_j(x))
    assert s.shape == (3, 7, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantizers_round_ties_to_even():
    """amax = 127 makes the scale exactly 1: x.5 values are ties, and
    jnp.round / torch.round / rintf send them to the even code."""
    row = np.asarray([127.0, 2.5, -3.5, 0.5, 1.5, -0.5, -126.5],
                     np.float32)
    want = np.asarray([127, 2, -4, 0, 2, 0, -126], np.int8)
    q, s = _quant_rows(_t(row[None]))
    np.testing.assert_array_equal(q.numpy()[0], want)
    assert float(s) == 1.0
    np.testing.assert_array_equal(np.asarray(jax_quant_rows(_j(row))[0]),
                                  want)
    wq, ws = quant_cols(_t(row[None]))  # one output channel
    np.testing.assert_array_equal(wq.numpy()[0], want)
    assert float(ws) == 1.0
    np.testing.assert_array_equal(
        np.asarray(jax_quant_cols(_j(row[:, None]))[0])[:, 0], want)


def test_quant_rows_divides_127_by_amax():
    """inv = 127 / amax is one correctly rounded division, as jnp's (and the
    kernel's __fdiv_rn): with amax = 5.988135, reciprocal(amax) * 127 is an
    ulp larger and sends 0.070726 * inv across 1.5 to the code 2."""
    row = np.asarray([5.988135, 0.070726], np.float32)
    q, _ = _quant_rows(_t(row))
    np.testing.assert_array_equal(q.numpy(), [127, 1])
    np.testing.assert_array_equal(np.asarray(jax_quant_rows(_j(row))[0]),
                                  [127, 1])


# ------------------------------------------------------------------- ops


@pytest.mark.parametrize("mask_kind", ["ones", "random"])
@pytest.mark.parametrize("ln_position", ["prologue", "epilogue", "none"])
@pytest.mark.parametrize("mode", ["mul", "add"])
def test_attention_block_int8_matches_jax(mode, ln_position, mask_kind):
    rng = np.random.RandomState(20)
    resid = _np(rng, B, T, H)
    weights = [_np(rng, *shape, scale=0.15) for shape in [(H, H), (H,)] * 4]
    ln = (1 + _np(rng, H, scale=0.1), _np(rng, H, scale=0.1))
    mask = _mask(rng, mask_kind, mode)
    ln_on = ln_position != "none"
    got = attention_block(
        _t(resid), _t(mask), tuple(_t(w) for w in weights), HEADS, mode,
        ln=(_t(ln[0]), _t(ln[1]), 1e-12) if ln_on else None,
        ln_position=ln_position, quant="int8")
    want = jax_attn(
        _j(resid), _j(mask), tuple(_j(w) for w in weights), HEADS, mode,
        use_pallas=True, interpret=True, quant="int8",
        ln=(_j(ln[0]), _j(ln[1]), 1e-12) if ln_on else None,
        ln_position=ln_position)
    _close(got.numpy(), want, TOL, "K1")
    # and it is the int8 block, not the float one
    fp = attention_block(
        _t(resid), _t(mask), tuple(_t(w) for w in weights), HEADS, mode,
        ln=(_t(ln[0]), _t(ln[1]), 1e-12) if ln_on else None,
        ln_position=ln_position)
    assert float((got - fp).abs().max()) > 1e-5


@pytest.mark.parametrize("ln_position", ["prologue", "epilogue", "none"])
def test_mlp_block_int8_matches_jax(ln_position):
    resid, w1, b1, w2, b2, lnw, lnb = _mlp_inputs(21)
    ln_on = ln_position != "none"
    got = mlp_block(_t(resid), _t(w1), _t(b1), _t(w2), _t(b2),
                    ln=(_t(lnw), _t(lnb), 1e-12) if ln_on else None,
                    ln_position=ln_position, quant="int8")
    want = jax_mlp(_j(resid), _j(w1), _j(b1), _j(w2), _j(b2),
                   use_pallas=True, interpret=True, quant="int8",
                   ln=(_j(lnw), _j(lnb), 1e-12) if ln_on else None,
                   ln_position=ln_position)
    _close(got.numpy(), want, TOL, "K4")


@pytest.mark.parametrize("mask_kind", ["ones", "random"])
def test_mlp_ladder_block_matches_jax(mask_kind):
    rng = np.random.RandomState(22)
    resid, w1, b1, w2, b2, lnw, lnb = _mlp_inputs(23)
    sides = [_np(rng, B, T, S, scale=0.5) for _ in range(2)]
    branches = [_branch(rng), _branch(rng)]
    mask = _mask(rng, mask_kind, "mul")
    trunk = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "ln_w": lnw,
             "ln_b": lnb}
    got = mlp_ladder_block(
        _t(resid), [_t(s) for s in sides], _t(mask),
        {k: _t(v) for k, v in trunk.items()},
        [{k: _t(v) for k, v in b.items()} for b in branches],
        HEADS, "mul", 1e-12)
    want = jax_mlp_ladder(
        _j(resid), [_j(s) for s in sides], _j(mask),
        {k: _j(v) for k, v in trunk.items()},
        [{k: _j(v) for k, v in b.items()} for b in branches],
        HEADS, "mul", 1e-12, use_pallas=True, interpret=True)
    assert len(got) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w, TOL, f"K2 output {i}")


@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("t", [17, 45])  # below one 32-token tile; 1.4 tiles
def test_explainer_head_block_matches_jax(t, has_ln):
    rng = np.random.RandomState(24)
    x = _np(rng, B, t, S)
    w1, b1 = _np(rng, 64, S, scale=0.3), _np(rng, 64, scale=0.1)
    w2, b2 = _np(rng, 64, 64, scale=0.15), _np(rng, 64, scale=0.1)
    w3, b3 = _np(rng, 3, 64, scale=0.15), _np(rng, 3, scale=0.1)
    lnw, lnb = 1 + _np(rng, S, scale=0.1), _np(rng, S, scale=0.1)
    ws = (w1, b1, w2, b2, w3, b3)
    got = hb.explainer_head_block(
        _t(x), *map(_t, ws), _t(lnw) if has_ln else None,
        _t(lnb) if has_ln else None, 1e-5)
    want = jax_head_block(
        _j(x), *map(_j, ws), _j(lnw) if has_ln else None,
        _j(lnb) if has_ln else None, 1e-5, use_pallas=True, quant="int8",
        interpret=True)
    assert got.shape == (B, t, 3)
    _close(got.numpy(), want, TOL, "K3")


def test_dense_serving_matches_jax(monkeypatch):
    for k, v in JAX_INT8.items():
        monkeypatch.setenv(k, v)
    assert quant_mode() == "int8"
    rng = np.random.RandomState(25)
    x, w, b = _np(rng, B, T, S), _np(rng, 24, S, scale=0.3), \
        _np(rng, 24, scale=0.1)
    got = dense_serving(_t(x), _t(w), _t(b))
    want = jax_dense_serving(_j(x), _j(w), _j(b))
    _close(got.numpy(), want, 1e-6, "dense_serving")
    monkeypatch.setenv("AUTOGNOTHI_INT8", "0")
    assert quant_mode() == "none"


def test_int8_gradient_is_the_unquantized_math():
    """Forward quantized, backward the unquantized block (the JAX
    custom_vjp convention): the int8 op's input gradient equals the float
    op's exactly."""
    rng = np.random.RandomState(26)
    resid = _np(rng, B, T, H)
    weights = tuple(_t(_np(rng, *s, scale=0.15)) for s in [(H, H), (H,)] * 4)
    mask = _t(_mask(rng, "random", "mul"))
    ln = (_t(1 + _np(rng, H, scale=0.1)), _t(_np(rng, H, scale=0.1)), 1e-12)
    x = _t(resid).requires_grad_(True)
    attention_block(x, mask, weights, HEADS, "mul", ln=ln,
                    ln_position="prologue",
                    quant="int8").square().sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
    # d/dx of sum(out^2) = 2 out J: the int8 forward's out with the float J
    x2 = _t(resid).requires_grad_(True)
    out = attention_block_plain(x2, mask, *weights, *ln[:2], n_heads=HEADS,
                                mode="mul", ln_position="prologue",
                                ln_eps=1e-12)
    with torch.no_grad():
        q_out = attention_block(_t(resid), mask, weights, HEADS, "mul",
                                ln=ln, ln_position="prologue", quant="int8")
    (want,) = torch.autograd.grad(out, x2, 2 * q_out)
    torch.testing.assert_close(x.grad, want, atol=1e-6, rtol=1e-6)


# ----------------------------------------------------------------- model


@pytest.mark.parametrize("mask_kind", ["ones", "random"])
def test_ltt_vit_final_fwd_int8_matches_jax(monkeypatch, mask_kind):
    for k, v in JAX_INT8.items():
        monkeypatch.setenv(k, v)
    jcfg, flat = _jax_params(MINI, seed=5)
    rng = np.random.RandomState(6)
    pixels = rng.randn(3, 3, 16, 16).astype(np.float32)
    mask = np.ones((3, 5), np.float32)
    if mask_kind == "random":
        mask[:, 1:] = rng.rand(3, 4) > 0.5
    want_logits, want_attr, _ = jax_ltt.ltt_vit_final_fwd(
        {k: jnp.asarray(v) for k, v in flat.items()}, jcfg,
        jnp.asarray(pixels), jnp.asarray(mask))
    cfg = LttViTConfig(**MINI)
    model = from_jax_params(flat, cfg, torch.device("cpu"))
    with torch.inference_mode():
        logits, attr = ltt_vit_final_fwd(model, cfg, _t(pixels), _t(mask))
    assert attr.shape == (3, 3, 4)
    _close(logits.numpy(), want_logits, TOL, "logits")
    _close(attr.numpy(), want_attr, TOL, "attributions")
    # the fp32 forward of the same weights is a different function
    monkeypatch.setenv("AUTOGNOTHI_INT8", "0")
    with torch.inference_mode():
        _, attr_fp = ltt_vit_final_fwd(model, cfg, _t(pixels), _t(mask))
    assert float((attr - attr_fp).abs().max()) > 1e-6


def test_cpu_serve_int8(monkeypatch, tmp_path):
    """`serve` on the CPU with AUTOGNOTHI_INT8=1 answers with the plain int8
    forward of its model (one slab, so the same batch), not the fp32 one."""
    import urllib.request

    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import serve_in_thread
    from tests.test_torch_port_serve import _write_exp

    monkeypatch.setenv("AUTOGNOTHI_INT8", "1")
    env = ExpEnv(_write_exp(tmp_path))
    server, service, thread = serve_in_thread(env, port=0, batch_size=4,
                                              device="cpu")
    rows = np.random.RandomState(7).rand(4, 3, 16, 16).astype(np.float32)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/explain",
            data=json.dumps({"images": rows.tolist()}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            got = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        env.close()
    logits = np.asarray(got["logits"], np.float32)
    attr = np.asarray(got["attributions"], np.float32)
    assert logits.shape == (4, 3) and attr.shape == (4, 3, 4)
    np.testing.assert_allclose(logits.sum(-1), np.ones(4), atol=1e-5)
    with torch.inference_mode():
        want = service.recipe.fw_final(service.m_config, service.model,
                                       _t(rows))
        monkeypatch.setenv("AUTOGNOTHI_INT8", "0")
        fp = service.recipe.fw_final(service.m_config, service.model,
                                     _t(rows))
    np.testing.assert_allclose(logits, want[0].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(attr, want[1].numpy(), atol=1e-6, rtol=0)
    assert float(np.abs(attr - fp[1].numpy()).max()) > 1e-6

