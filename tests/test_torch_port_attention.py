"""Port parity, the masked attention ops and the dispatch modes: the plain
versions of K9 (`masked_attention`) and K10 (`ladder_attention`) against
the JAX package's kernels run in Pallas interpret mode and its XLA
reference, in both mask modes, fp32 and bf16, at T = 5 and 197; the
`pallas_mode` / `quant_mode` / `quant_override` rules against the JAX
package's across the environment grid; and the forward through the
masked attention op (mode "1") and with AUTOGNOTHI_INT8=1 outside mode
"2", against the JAX package on the same weights.

Tolerances: fp32 atol 2e-5, rtol 1e-5, as tests/test_flash_attention.py
(the same fp32 math in another summation order; the kernel scales by
1/sqrt(d) where XLA divides by sqrt(d)); bf16 3e-2 (one bf16 ulp at the
cast of the probabilities or the output); the LTT ViT forward 1e-5, as
tests/test_torch_port_model.py.
"""

import itertools
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autognothi_tpu.models import common as jax_common
from autognothi_tpu.models import ltt_vit as jax_ltt
from autognothi_tpu.ops.flash_attention import \
    _xla_masked_attention as jax_xla_attention
from autognothi_tpu.ops.flash_attention import \
    masked_attention as jax_masked_attention
from autognothi_tpu.ops.ladder_block import \
    ladder_attention as jax_ladder_attention
from autognothi_tpu_torch.models import common
from autognothi_tpu_torch.models.ltt_vit import LttViTConfig, ltt_vit_final_fwd
from autognothi_tpu_torch.ops import flash_attention as fa
from autognothi_tpu_torch.ops import ladder_block as lb
from autognothi_tpu_torch.params import from_jax_params
from tests.test_torch_port_model import MINI, _jax_params

TOL = {"float32": dict(atol=2e-5, rtol=1e-5),
       "bfloat16": dict(atol=3e-2, rtol=3e-2)}
MODEL_TOL = dict(atol=1e-5, rtol=1e-5)
ENV_KEYS = ("AUTOGNOTHI_PALLAS", "AUTOGNOTHI_INT8",
            "AUTOGNOTHI_PALLAS_INTERPRET")


def _row(rng, n, t, mode):
    m01 = rng.randint(0, 2, (n, t)).astype(np.float32)
    m01[:, 0] = 1
    if mode == "add":
        return (1.0 - m01) * np.float32(np.finfo(np.float32).min)
    return m01


def _cast(a, dtype):
    """numpy fp32 -> (torch, jax) in `dtype`, holding the same values."""
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))


def _np32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [5, 197])
@pytest.mark.parametrize("mode", ["add", "mul"])
def test_masked_attention_plain_matches_jax(mode, t, dtype):
    rng = np.random.RandomState(0)
    n, h, d = 2, 3, 32
    (q, jq), (k, jk), (v, jv) = (
        _cast(rng.randn(n, h, t, d).astype(np.float32), dtype)
        for _ in range(3))
    row = _row(rng, n, t, mode)
    before = fa.COUNTER.count
    got = fa.masked_attention(q, k, v, torch.from_numpy(row), mode=mode)
    assert fa.COUNTER.count == before  # CPU tensors: the plain version
    assert got.dtype == q.dtype and got.shape == (n, h, t, d)
    jrow = jnp.asarray(row)
    for want in (jax_masked_attention(jq, jk, jv, jrow, mode=mode,
                                      interpret=True),
                 jax_xla_attention(jq, jk, jv, jrow, mode=mode)):
        np.testing.assert_allclose(_np32(got), _np32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [5, 197])
@pytest.mark.parametrize("mode", ["add", "mul"])
def test_ladder_attention_plain_matches_jax(mode, t, dtype):
    rng = np.random.RandomState(1)
    b, s_h, heads = 2, 16, 4
    qkvs = [[_cast((rng.randn(b, t, s_h)).astype(np.float32), dtype)
             for _ in range(3)] for _ in range(2)]
    row = _row(rng, b, t, mode)
    got = lb.ladder_attention([tuple(x[0] for x in tr) for tr in qkvs],
                              torch.from_numpy(row), heads, mode)
    for use_pallas in (False, True):
        want = jax_ladder_attention(
            [tuple(x[1] for x in tr) for tr in qkvs], jnp.asarray(row),
            heads, mode, use_pallas=use_pallas, interpret=True)
        for g, w in zip(got, want):
            assert g.dtype == qkvs[0][0][0].dtype
            np.testing.assert_allclose(_np32(g), _np32(w), **TOL[dtype])


def test_masked_attention_backward_is_the_plain_gradient():
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(2, 2, 7, 8).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    row = torch.from_numpy(_row(rng, 2, 7, "mul"))
    fa.masked_attention(q, k, v, row, mode="mul").square().sum().backward()
    assert all(torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
               for x in (q, k, v))


# ----------------------------------------------------------- mode rules


def _jax_modes(env, override):
    """JAX pallas_mode/quant_mode as on its accelerator (Pallas available),
    under `env` and an optional quant_override."""
    with mock.patch.dict(os.environ, env, clear=False), \
            mock.patch("autognothi_tpu.ops.flash_attention.pallas_available",
                       lambda: True):
        if override is None:
            return jax_common.pallas_mode(), jax_common.quant_mode()
        with jax_common.quant_override(override):
            return jax_common.pallas_mode(), jax_common.quant_mode()


def _port_modes(env, override):
    with mock.patch.dict(os.environ, env, clear=False):
        if override is None:
            return common.pallas_mode(), common.quant_mode()
        with common.quant_override(override):
            return common.pallas_mode(), common.quant_mode()


def test_pallas_and_quant_modes_match_jax_across_the_env_grid():
    """AUTOGNOTHI_INT8=1 means W8A8 only in pallas mode "2" (the fault the
    port had: it served int8 in modes "0" and "1"), and a quant_override
    scope replaces the variable under the same rule."""
    saved = {k: os.environ.pop(k) for k in ENV_KEYS if k in os.environ}
    try:
        for pallas, int8, override in itertools.product(
                (None, "auto", "0", "1", "2"), (None, "0", "1"),
                (None, "int8", "none")):
            env = {}
            if pallas is not None:
                env["AUTOGNOTHI_PALLAS"] = pallas
            if int8 is not None:
                env["AUTOGNOTHI_INT8"] = int8
            got = _port_modes(env, override)
            assert got == _jax_modes(env, override), (env, override)
        assert _port_modes({"AUTOGNOTHI_INT8": "1",
                            "AUTOGNOTHI_PALLAS": "0"}, None) == ("0", "none")
    finally:
        os.environ.update(saved)
    with pytest.raises(ValueError):
        common.quant_override("bf16")


@pytest.mark.parametrize("pallas", ["0", "1"])
def test_int8_outside_mode_2_computes_unquantized_as_jax(pallas):
    """AUTOGNOTHI_INT8=1 with AUTOGNOTHI_PALLAS=0 or 1: both packages run
    the float forward; in mode "1" every attention is the masked attention
    op (JAX: its Pallas kernel, interpreted)."""
    cfg_dict = dict(MINI)
    jcfg, flat = _jax_params(cfg_dict, seed=3)
    rng = np.random.RandomState(4)
    pixels = rng.randn(2, 3, 16, 16).astype(np.float32)
    mask = np.ones((2, 5), np.float32)
    mask[:, 1:] = rng.rand(2, 4) > 0.5
    env = {"AUTOGNOTHI_INT8": "1", "AUTOGNOTHI_PALLAS": pallas,
           "AUTOGNOTHI_PALLAS_INTERPRET": "1"}
    with mock.patch.dict(os.environ, env):
        want_logits, want_attr, _ = jax_ltt.ltt_vit_final_fwd(
            {k: jnp.asarray(v) for k, v in flat.items()}, jcfg,
            jnp.asarray(pixels), jnp.asarray(mask))
        model = from_jax_params(flat, LttViTConfig(**cfg_dict),
                                torch.device("cpu"))
        with torch.inference_mode(), mock.patch.object(
                fa, "masked_attention", wraps=fa.masked_attention) as spy:
            logits, attr = ltt_vit_final_fwd(
                model, LttViTConfig(**cfg_dict), torch.from_numpy(pixels),
                torch.from_numpy(mask))
    # mode "1": 2 trunk layers, 2 x 2 ladder side layers, 1 explainer layer
    assert spy.call_count == (7 if pallas == "1" else 0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **MODEL_TOL)
    np.testing.assert_allclose(attr.numpy(), np.asarray(want_attr),
                               **MODEL_TOL)


def test_dropout_laws():
    """The port's dropout cannot repeat JAX's random bits; it keeps JAX's
    law: off when deterministic or at rate 0, else each value kept with
    probability 1 - rate and scaled by 1 / (1 - rate)."""
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(0)
    assert common.dropout(g, x, 0.3, deterministic=True) is x
    assert common.dropout(None, x, 0.0, deterministic=False) is x
    y = common.dropout(g, x, 0.3, deterministic=False)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    share = kept.float().mean().item()
    assert abs(share - 0.7) < 5 * (0.7 * 0.3 / x.numel()) ** 0.5
    y2 = common.dropout(torch.Generator().manual_seed(0), x, 0.3, False)
    assert torch.equal(y, y2)  # the same generator state, the same mask
    with pytest.raises(ValueError):
        common.dropout(None, x, 0.3, deterministic=False)
