"""Port parity for the tensor-core redesign of the float products: the bf16
float split MLP (K8) chain against the JAX package, the numerics of 3xTF32,
and the fp32-grade bound `chip_smoke.py` charges the float kernels with.

The CUDA kernels themselves run only on the card
(`tests/test_torch_port_cuda.py`); what is held here is what they compute:
- the bf16 K8 chain (`ops/mlp_block.py:mlp_block_tiled`, plain versions on
  the CPU) against JAX `_tiled_mlp` in bf16 with its Pallas kernels
  interpreted, tile by tile, within one bf16 step (2^-7) x max(1, |ref|):
  both round every tile's output to bf16, and a last-bit difference in a
  sum (the JAX kernels' A&S erf, another order) may round one value apart;
- the mini LTT BERT final in bf16 without int8 under a lowered budget, so
  both packages take the 2-tile chain, within the served bf16 gate (3e-2);
- an emulation of 3xTF32 (`cvt.rna.tf32` on the int32 view, products of
  the hi/lo parts summed exactly per k8 step, fp32 accumulation across
  steps) on LayerNorm'd rows within 1e-5 x max(1, |ref|) of float64 at the
  inner dims of the path, where one TF32 product alone misses that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autognothi_tpu.ops.mlp_block as j_mb
import chip_smoke
from autognothi_tpu.models import ltt_bert as j_ltt
from autognothi_tpu_torch.models.ltt_bert import (LttBertConfig,
                                                  ltt_bert_final_fwd)
from autognothi_tpu_torch.ops import gates
from autognothi_tpu_torch.ops import mlp_block as mb
from autognothi_tpu_torch.params import from_jax_params
from tests.test_torch_port_bert import (MINI, SMALL_BUDGET, _mini_params,
                                        _set_budget, _set_env)
from tests.test_torch_port_ops import _np

CPU = torch.device("cpu")
BF16_STEP = 2.0 ** -7   # one bf16 step at magnitude 1
TOL_SERVED_BF16 = 3e-2  # chip_smoke's bound for a bf16 forward
TOL_3XTF32 = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()), max(1.0, float(np.abs(want).max()))


# -------------------------------------------------- the bf16 K8 chain


@pytest.mark.parametrize("ln_position", ["prologue", "epilogue"])
@pytest.mark.parametrize("n_tiles", [2, 4])
def test_k8_bf16_float_chain_matches_jax(n_tiles, ln_position):
    rng = np.random.RandomState(60 + n_tiles)
    b, t, h, inter = 2, 17, 32, 128
    resid = _np(rng, b, t, h, scale=0.5)
    w1, b1 = _np(rng, inter, h, scale=0.15), _np(rng, inter, scale=0.15)
    w2, b2 = _np(rng, h, inter, scale=0.15), _np(rng, h, scale=0.15)
    lnw, lnb = 1 + _np(rng, h, scale=0.1), _np(rng, h, scale=0.1)
    args = (_t(resid).to(torch.bfloat16), _t(w1), _t(b1), _t(w2), _t(b2))
    kw = dict(ln=(_t(lnw), _t(lnb), 1e-12), ln_position=ln_position)
    got = mb.mlp_block_tiled(*args, n_tiles=n_tiles, **kw)
    bf = jnp.bfloat16
    want = j_mb._tiled_mlp(
        jnp.asarray(resid).astype(bf), jnp.asarray(w1).T.astype(bf),
        jnp.asarray(b1), jnp.asarray(w2).T.astype(bf), jnp.asarray(b2),
        jnp.asarray(lnw), jnp.asarray(lnb), ln_position, 1e-12, n_tiles,
        interpret=True)
    assert got.dtype == torch.bfloat16
    err, scale = _err(got.float().numpy(), np.asarray(want, np.float32))
    assert err <= BF16_STEP * scale, (err, scale)
    # the tiles round their outputs apart: not the one-pass block's numbers
    one = mb.mlp_block_plain(*mb.mlp_block_args(*args, **kw)[0],
                             **mb.mlp_block_args(*args, **kw)[1])
    assert float((got.float() - one.float()).abs().max()) > 0


def test_mlp_block_takes_the_bf16_chain_where_the_gate_splits(monkeypatch):
    """bf16 without int8 where `mlp_block_tiles` > 1 runs the float chain
    with the gate's tile count; fp32 keeps the one-pass block."""
    seen = []

    def spy(*args, n_tiles, **kwargs):
        seen.append(n_tiles)
        return real(*args, n_tiles=n_tiles, **kwargs)

    real = mb.mlp_block_tiled
    monkeypatch.setattr(mb, "mlp_block_tiled", spy)
    rng = np.random.RandomState(62)
    b, t, h, inter = 1, 32, 64, 128
    w1, b1 = _t(_np(rng, inter, h, scale=0.1)), _t(_np(rng, inter))
    w2, b2 = _t(_np(rng, h, inter, scale=0.1)), _t(_np(rng, h))
    x = _t(_np(rng, b, t, h))
    monkeypatch.setattr(gates, "VMEM_BUDGET_BYTES", SMALL_BUDGET)
    for dtype, want in ((torch.bfloat16, [2]), (torch.float32, [])):
        seen.clear()
        n = gates.mlp_block_tiles(t, h, inter, dtype)
        mb.mlp_block(x.to(dtype), w1, b1, w2, b2)
        assert n > 1 and seen == want, (dtype, n, seen)


def test_ltt_bert_final_bf16_float_chain_matches_jax(monkeypatch):
    """The mini LTT BERT final with bf16 parameters, int8 off, under the
    lowered budget on both sides: each takes the 2-tile float chain in
    every trunk MLP."""
    calls = {"port": [], "jax": []}
    real_port, real_jax = mb.mlp_block_tiled, j_mb._tiled_mlp

    def port_spy(*args, n_tiles, **kwargs):
        calls["port"].append(n_tiles)
        return real_port(*args, n_tiles=n_tiles, **kwargs)

    def jax_spy(*args, **kwargs):
        calls["jax"].append(args[9])
        return real_jax(*args, **kwargs)

    monkeypatch.setattr(mb, "mlp_block_tiled", port_spy)
    monkeypatch.setattr(j_mb, "_tiled_mlp", jax_spy)
    _set_env(monkeypatch, "2", False)
    _set_budget(monkeypatch, SMALL_BUDGET)
    jcfg, flat = _mini_params(seed=1)
    rng = np.random.RandomState(63)
    ids = rng.randint(1, MINI["vocab_size"], (3, 32)).astype(np.int64)
    mask = np.ones((3, 32), np.int64)
    mask[:, 1:] = rng.rand(3, 31) > 0.4
    ttype = np.zeros_like(ids)
    jparams = {k: jnp.asarray(v).astype(jnp.bfloat16)
               for k, v in flat.items()}
    want_logits, want_attr, _ = j_ltt.ltt_bert_final_fwd(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(ttype))
    cfg = LttBertConfig(**MINI)
    model = from_jax_params(flat, cfg, CPU).to(torch.bfloat16)
    with torch.inference_mode():
        logits, attr = ltt_bert_final_fwd(model, cfg, _t(ids), _t(mask),
                                          _t(ttype))
    layers = MINI["num_hidden_layers"]
    assert calls["port"] == [2] * layers
    # JAX traces the layer body once for all layers
    assert calls["jax"] and set(calls["jax"]) == {2}
    assert attr.dtype == torch.bfloat16
    for got, want in ((logits, want_logits), (attr, want_attr)):
        err, scale = _err(got.float().numpy(),
                          np.asarray(jnp.asarray(want, jnp.float32)))
        assert err <= TOL_SERVED_BF16 * scale, (err, scale)


# -------------------------------------------------------------- 3xTF32


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32`: round to 10 significand bits, ties away from
    zero, on the int32 view (sign and magnitude round alike)."""
    bits = (x.view(torch.int32) + 0x1000) & -0x2000  # & 0xFFFFE000
    return bits.view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def gemm_3xtf32(a: torch.Tensor, w: torch.Tensor, *, terms=3) -> torch.Tensor:
    """a <M, K> @ w <N, K>.T as the tensor-core GEMM computes it: per k8
    step the tf32 products (hi*hi + hi*lo + lo*hi, or hi*hi alone) summed
    exactly, the steps accumulated in fp32."""
    ah, al = split_tf32(a)
    wh, wl = split_tf32(w)
    acc = torch.zeros(a.shape[0], w.shape[0], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        step = ah[:, ks].double() @ wh[:, ks].double().T
        if terms == 3:
            step = step + ah[:, ks].double() @ wl[:, ks].double().T \
                + al[:, ks].double() @ wh[:, ks].double().T
        acc = acc + step.float()
    return acc


def test_rna_tf32_rounds_ties_away_and_keeps_ten_bits():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4,
                      1 + 3 * ulp / 4, 3.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 3.0])
    assert torch.equal(rna_tf32(x), want)
    hi, lo = split_tf32(torch.tensor([1 + 2.0 ** -20], dtype=torch.float32))
    assert torch.equal(hi, one) and lo.item() == 2.0 ** -20


@pytest.mark.parametrize("k", [64, 96, 512, 768, 3072])
def test_3xtf32_holds_fp32_grade_at_the_path_inner_dims(k):
    """k = 64 (attention scores at d = 64), 96 and 768 (ladder, trunk), 512
    (P.V over BERT's keys), 3072 (the MLP's W2, the head's d3): 3xTF32 on
    LN'd rows within 1e-5 x max(1, |ref|) of float64; TF32 alone is not."""
    rng = np.random.RandomState(k)
    x = rng.randn(64, k)
    x = (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)
    a = torch.from_numpy(x).float()
    w = torch.from_numpy(rng.uniform(-1, 1, (48, k)) / np.sqrt(k)).float()
    ref = a.double() @ w.double().T
    scale = max(1.0, ref.abs().max().item())
    err3 = (gemm_3xtf32(a, w).double() - ref).abs().max().item()
    err1 = (gemm_3xtf32(a, w, terms=1).double() - ref).abs().max().item()
    assert err3 <= TOL_3XTF32 * scale, (err3, scale)
    assert err1 > TOL_3XTF32 * scale, (err1, scale)


# ------------------------------------------------------- the new bound


def test_op_bound_charges_fp32_float_products_at_165_tflops():
    """fp32 float products are fp32-grade work the card does as 3xTF32:
    495 / 3 TFLOP/s.  K7 at the ViT shape is operations-bound at 119.0
    GFLOP -> 0.7211 ms; K9 at <256, 12, 197, 64> moves 620 MB (bytes,
    0.1850 ms) and at <8, 12, 512, 64> does 6.44 GFLOP (0.0390 ms)."""
    assert chip_smoke.PEAK["fp32"] == 495e12 / 3
    f32 = torch.float32
    x = torch.empty(64, 197, 768, dtype=f32)
    mlp = (x, torch.empty(3072, 768), torch.empty(3072),
           torch.empty(768, 3072), torch.empty(768))
    ms, by = chip_smoke.op_bound("mlp_block", mlp)
    assert by == "operations"
    assert ms == pytest.approx(4 * 12608 * 768 * 3072 / (495e12 / 3) * 1e3)
    assert round(ms, 4) == 0.7211
    for (n, t), want_by, want_ms in (((256, 197), "bytes", 0.1850),
                                     ((8, 512), "operations", 0.0390)):
        q = torch.empty(n, 12, t, 64, dtype=f32)
        ms, by = chip_smoke.op_bound("masked_attention",
                                     (q, q, q, torch.empty(n, t)))
        assert (by, round(ms, 4)) == (want_by, want_ms)
    # bf16 float products keep the bf16 tensor-core peak
    ms, _ = chip_smoke.op_bound("mlp_block",
                                tuple(a.to(torch.bfloat16) for a in mlp))
    assert ms == pytest.approx(4 * 12608 * 768 * 3072 / 989e12 * 1e3)
