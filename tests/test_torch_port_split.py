"""Port parity of the split MLP chains as a BERT layer composes them: a mini
post-norm BERT layer (hidden 64, MLP 256, T = 17) under a budget that
splits its MLP into 2 and 4 tiles in both packages, the int8 K8q chain
with fp32 parameters (AUTOGNOTHI_INT8=1) and the float K8 chain in bf16,
against the JAX package on the same numpy inputs on the CPU (its Pallas
kernels interpreted).

On the card a K8q chain shares x's codes, the weights' codes and its
row-max buffers across its tiles (`mlp_block._Int8Chain`); here each tile
takes its plain version.  What is held:
- the layer's output: fp32 int8 within 2e-5 x max(1, |ref|) where every
  per-token int8 code agrees with JAX's (the `int8_codes` recorder), else
  1e-2, the int8 bound on the card; bf16 within 3e-2 x max(1, |ref|), the
  served bf16 gate (the layer's attention block and two LayerNorms round
  in bf16 on top of the chain, which `tests/test_torch_port_tensorcore.py`
  holds alone at one bf16 step);
- the split: both packages take the same number of tiles, and the port
  makes one counted op call per tile, all of one chain;
- the gradient of the split MLP op, the float tile's in both packages (the
  JAX custom_vjp differentiates `_xla_mlp_sepx`): fp32 within 1e-4 x
  max(1, max|g|) (the forward it is linearised at carries int8 values),
  bf16 within 3e-2 x max(1, max|g|) (bf16 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autognothi_tpu.ops.mlp_block as j_mb
from autognothi_tpu.models import bert as j_bert
from autognothi_tpu.models.common import \
    additive_mask_bias as j_additive_mask_bias
from autognothi_tpu_torch.models.bert import BertLayer
from autognothi_tpu_torch.models.common import additive_mask_bias
from autognothi_tpu_torch.models.ltt_bert import LttBertConfig
from autognothi_tpu_torch.ops import mlp_block as mb
from tests.test_torch_port_bert import (MINI, TOL_FLIPPED, TOL_INT8,
                                        _layer_params, _recorded_codes,
                                        _set_budget, _set_env)
from tests.test_torch_port_bert import int8_codes  # noqa: F401 (fixture)
from tests.test_torch_port_ops import _np

B, T, H, INTER, HEADS = 2, 17, 64, 256, 4
# budgets under which both packages split this MLP into n tiles, int8
# (fp32) and float (bf16) alike; the attention block runs float under both
BUDGETS = {2: 55000, 4: 40000}
TOL_BF16 = 3e-2
TOL_GRAD = {"float32": 1e-4, "bfloat16": 3e-2}
CASES = {"int8": ("float32", True), "bf16": ("bfloat16", False)}


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a)).to(getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _spy_tiles(monkeypatch):
    """The split op calls of both packages: the port's `dispatch` calls by
    counter name with their launches, JAX's `_tiled_mlp` tile counts."""
    seen = {"port": [], "jax": []}
    real_dispatch, real_tiled = mb.dispatch, j_mb._tiled_mlp

    def dispatch(launch, plain, counter, *rest, **kw):
        seen["port"].append((counter.name, launch))
        return real_dispatch(launch, plain, counter, *rest, **kw)

    def tiled(*args, **kw):
        seen["jax"].append(args[9])
        return real_tiled(*args, **kw)

    monkeypatch.setattr(mb, "dispatch", dispatch)
    monkeypatch.setattr(j_mb, "_tiled_mlp", tiled)
    return seen


@pytest.mark.parametrize("n_tiles", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_mini_bert_layer_split_mlp_matches_jax(monkeypatch, int8_codes,
                                               case, n_tiles):
    dtype, int8 = CASES[case]
    _set_env(monkeypatch, "2", int8)
    _set_budget(monkeypatch, BUDGETS[n_tiles])
    seen = _spy_tiles(monkeypatch)
    rng = np.random.RandomState(70 + n_tiles)
    params = _layer_params(rng, H, INTER)
    x = _np(rng, B, T, H)
    m01 = (rng.rand(B, T) > 0.3).astype(np.float32)
    m01[:, 0] = 1
    cfg = LttBertConfig(**dict(MINI, hidden_size=H, intermediate_size=INTER,
                               num_attention_heads=HEADS,
                               max_position_embeddings=T)).into()
    layer = BertLayer(H, INTER)
    layer.load_state_dict({k: _t(v, "float32") for k, v in params.items()})
    layer.to(getattr(torch, dtype))
    with torch.inference_mode():
        got = layer(_t(x, dtype), additive_mask_bias(
            torch.from_numpy(m01), getattr(torch, dtype)), cfg)
    want = j_bert._bert_layer_body(
        {k: _j(v, dtype) for k, v in params.items()}, _j(x, dtype),
        j_additive_mask_bias(jnp.asarray(m01), getattr(jnp, dtype)),
        j_bert.VanillaBertConfig(
            **{k: getattr(cfg, k) for k in cfg.__dataclass_fields__}),
        ident_ln1=False, deterministic=True, rng=None)
    want = np.asarray(want.astype(jnp.float32))
    counter = mb.COUNTER_INT8_TILED if int8 else mb.COUNTER_TILED
    tiles = [launch for name, launch in seen["port"]
             if name == counter.name]
    assert seen["jax"] == [n_tiles] and len(tiles) == n_tiles
    if int8:  # one chain shared by its tiles
        assert len({id(t.keywords["chain"]) for t in tiles}) == 1
    got = got.float().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    if not int8:
        assert err <= TOL_BF16 * scale, err
        return
    port, jax_ = _recorded_codes()
    # per tile: x, then the tile's intermediate, <B * T, width> each in the
    # port; JAX's kernels run image by image: x and the intermediate of
    # each image in turn, <T, width>
    assert [c.shape for c in port] == \
        [(B * T, H), (B * T, INTER // n_tiles)] * n_tiles
    assert len(jax_) == 2 * B * n_tiles
    jax_ = [np.concatenate(jax_[2 * B * k + part:2 * B * (k + 1):2])
            for k in range(n_tiles) for part in (0, 1)]
    agree = all(np.array_equal(p, j) for p, j in zip(port, jax_))
    assert err <= (TOL_INT8 if agree else TOL_FLIPPED) * scale, (err, agree)


@pytest.mark.parametrize("n_tiles", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_split_mlp_gradient_is_the_float_tiles(monkeypatch, case, n_tiles):
    dtype, int8 = CASES[case]
    quant = "int8" if int8 else "none"
    _set_env(monkeypatch, "2", int8)
    _set_budget(monkeypatch, BUDGETS[n_tiles])
    seen = _spy_tiles(monkeypatch)
    rng = np.random.RandomState(80 + n_tiles)
    arrays = (_np(rng, B, T, H), _np(rng, INTER, H, scale=H ** -0.5),
              _np(rng, INTER, scale=0.1), _np(rng, H, INTER,
                                               scale=INTER ** -0.5),
              _np(rng, H, scale=0.1), 1 + _np(rng, H, scale=0.1),
              _np(rng, H, scale=0.1))
    cot = _np(rng, B, T, H)
    ts = [_t(a, dtype).requires_grad_() for a in arrays]
    out = mb.mlp_block(*ts[:5], ln=(ts[5], ts[6], 1e-12),
                       ln_position="epilogue", quant=quant)
    (out.float() * torch.from_numpy(cot)).sum().backward()

    def loss(resid, w1, b1, w2, b2, lnw, lnb):
        y = j_mb.mlp_block(resid, w1, b1, w2, b2, use_pallas=True,
                           ln=(lnw, lnb, 1e-12), ln_position="epilogue",
                           interpret=True, quant=quant)
        return jnp.sum(y.astype(jnp.float32) * cot)

    grads = jax.grad(loss, argnums=tuple(range(7)))(
        *(_j(a, dtype) for a in arrays))
    assert seen["jax"] == [n_tiles]
    assert sum(name == ("mlp_block_int8_tiled" if int8 else
                        "mlp_block_tiled") for name, _ in seen["port"]) \
        == n_tiles
    for name, t, g in zip(("resid", "w1", "b1", "w2", "b2", "ln_w", "ln_b"),
                          ts, grads):
        g = np.asarray(g.astype(jnp.float32))
        scale = max(1.0, float(np.abs(g).max()))
        err = float(np.abs(t.grad.float().numpy() - g).max())
        assert err <= TOL_GRAD[dtype] * scale, (name, err, scale)
