"""K5's four stages (`ops/ladder_block.py`: side-in, side QKV, side
attention, side MLP), each a plain version of its own on the branch-major
tensors its launch takes: chained, they hold against the JAX package's
XLA ladder (`_xla_ladder`, through `ladder_block(use_pallas=False)`) and
against the port's `ladder_block_plain`, on the same numpy inputs on the
CPU.  The cache of the branches' packed weights follows the weight-code
rules of `tests/test_torch_port_gates.py`.

Tolerances: fp32 2e-5 x max(1, |ref|) against JAX (the same fp32 math in
another summation order) and exact against `ladder_block_plain` (the same
torch operations); bf16 1e-2 x max(1, |ref|) against JAX (a bf16 value one
ulp apart at a cast point, where fp32 sums differ in order).
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autognothi_tpu.ops.ladder_block import ladder_block as jax_ladder
from autognothi_tpu_torch.ops import ladder_block as lb
from autognothi_tpu_torch.ops import weight_codes as wc

B, H = 2, 24
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _branch(rng, s, inter=None):
    w = {"map_w": _np(rng, s, H, scale=0.3), "map_b": _np(rng, s, scale=0.1)}
    for n in ("q", "k", "v", "o"):
        w[f"w{n}"] = _np(rng, s, s, scale=0.3)
        w[f"b{n}"] = _np(rng, s, scale=0.1)
    for n in ("1", "2"):
        w[f"ln{n}_w"] = 1 + _np(rng, s, scale=0.1)
        w[f"ln{n}_b"] = _np(rng, s, scale=0.1)
    inter = inter or 4 * s
    w["w1"], w["b1"] = _np(rng, inter, s, scale=0.3), _np(rng, inter)
    w["w2"], w["b2"] = _np(rng, s, inter, scale=0.2), _np(rng, s)
    return w


def _case(seed, t, s, n_branches, mode, inter=None):
    rng = np.random.RandomState(seed)
    h = _np(rng, B, t, H)
    sides = [_np(rng, B, t, s) for _ in range(n_branches)]
    branches = [_branch(rng, s, inter) for _ in range(n_branches)]
    m01 = (rng.rand(B, t) > 0.4).astype(np.float32)
    m01[:, 0] = 1
    mask = m01 if mode == "mul" else \
        (1 - m01) * np.float32(np.finfo(np.float32).min)
    return h, sides, branches, mask


def _check(seed, t, s, heads, n_branches, mode, pre_norm, dtype, inter=None):
    h, sides, branches, mask = _case(seed, t, s, n_branches, mode, inter)
    tensors, static = lb.ladder_block_args(
        torch.from_numpy(h).to(dtype),
        [torch.from_numpy(x).to(dtype) for x in sides], torch.from_numpy(mask),
        [{k: torch.from_numpy(v) for k, v in w.items()} for w in branches],
        heads, mode, pre_norm, 1e-12)
    got = lb.ladder_stages_plain(*tensors, **static)
    assert len(got) == n_branches
    jd = JAX_DTYPE[dtype]
    want = jax_ladder(jnp.asarray(h).astype(jd),
                      [jnp.asarray(x).astype(jd) for x in sides],
                      jnp.asarray(mask),
                      [{k: jnp.asarray(v) for k, v in w.items()}
                       for w in branches],
                      heads, mode, pre_norm, 1e-12, use_pallas=False)
    for y, w_jax in zip(got, want):
        ref = np.asarray(w_jax.astype(jnp.float32))
        err = np.abs(y.float().numpy() - ref).max()
        assert err <= TOL[dtype] * max(1.0, np.abs(ref).max()), err
    for y, w_plain in zip(got, lb.ladder_block_plain(*tensors, **static)):
        assert y.dtype == dtype and y.shape == (B, t, s)
        assert torch.equal(y, w_plain)


@pytest.mark.parametrize("t", [1, 9, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,pre_norm", [("mul", True), ("add", False)])
@pytest.mark.parametrize("n_branches", [1, 2])
def test_stages_chained_match_jax_and_plain(n_branches, mode, pre_norm,
                                            dtype, t):
    """Side 16, 4 heads of d = 4."""
    _check(t + 10 * n_branches, t, 16, 4, n_branches, mode, pre_norm, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,pre_norm", [("mul", True), ("add", False)])
def test_stages_chained_at_heads_of_8(mode, pre_norm, dtype):
    """Side 32, 4 heads of d = 8 (the kernels' head width)."""
    _check(5, 17, 32, 4, 2, mode, pre_norm, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,pre_norm", [("mul", True), ("add", False)])
def test_stages_chained_at_an_mlp_width_other_than_4s(mode, pre_norm, dtype):
    """Side 24 (3 heads of d = 8), MLP 40: widths the kernels take besides
    the 4S of the ViT and BERT configurations."""
    _check(6, 9, 24, 3, 2, mode, pre_norm, dtype, inter=40)


def test_pack_casts_every_weight_to_the_activation_dtype():
    """fp32 weights and a bf16 step: the pack's matrices are the weights
    cast to bf16 and its fp32 vectors the bf16-cast vectors widened, as
    `ladder_block_plain` casts them."""
    branches = _torch_branches(5)
    pk = lb.ladder_pack(_flat(branches, [torch.zeros(1, 1, 16)] * 2), 2,
                        torch.bfloat16)
    for i, w in enumerate(branches):
        assert torch.equal(pk["wo"][i], w["wo"].bfloat16())
        assert torch.equal(pk["b1"][i], w["b1"].bfloat16().float())
        assert torch.equal(pk["ln2_w"][i], w["ln2_w"].bfloat16().float())
        assert torch.equal(pk["bqkv"][i, 16:32], w["bk"].bfloat16().float())
        assert torch.equal(pk["map_b"][16 * i:16 * (i + 1)],
                           w["map_b"].bfloat16().float())


def test_side_in_reads_every_branch_from_one_product():
    """side_in_plain on the packed <branches * S, H> map equals each
    branch's own map: the packing moves no column."""
    rng = np.random.RandomState(7)
    m, s = 11, 16
    h2 = torch.from_numpy(_np(rng, m, H))
    sides = [torch.from_numpy(_np(rng, m, s)) for _ in range(2)]
    ws = [torch.from_numpy(_np(rng, s, H, scale=0.3)) for _ in range(2)]
    bs = [torch.from_numpy(_np(rng, s)) for _ in range(2)]
    got = lb.side_in_plain(h2, sides, torch.cat(ws), torch.cat(bs))
    for i in range(2):
        want = lb.side_in_plain(h2, sides[i:i + 1], ws[i], bs[i])[0]
        torch.testing.assert_close(got[i], want, rtol=0, atol=1e-6)


def _flat(branches, sides):
    return [*sides, *(w[k] for w in branches for k in lb.BRANCH_KEYS)]


def _torch_branches(seed, s=16):
    rng = np.random.RandomState(seed)
    return [{k: torch.from_numpy(v) for k, v in _branch(rng, s).items()}
            for _ in range(2)]


def test_pack_cache_recomputes_after_in_place_updates():
    """The packed weights are made once per weight version: a second call
    returns the same pack; `add_` or `copy_` on any branch weight makes a
    new one that follows the new values."""
    branches = _torch_branches(1)
    sides = [torch.zeros(2, 3, 16) for _ in range(2)]
    flat = _flat(branches, sides)
    first = lb.ladder_pack_cached(flat, 2, torch.float32)
    assert lb.ladder_pack_cached(flat, 2, torch.float32) is first
    with torch.no_grad():
        branches[1]["wk"].add_(1.0)
    second = lb.ladder_pack_cached(flat, 2, torch.float32)
    assert second is not first
    torch.testing.assert_close(second["wqkv"][1, 16:32], branches[1]["wk"],
                               rtol=0, atol=0)
    with torch.no_grad():
        branches[0]["map_w"].copy_(branches[0]["map_w"] * 2)
    third = lb.ladder_pack_cached(flat, 2, torch.float32)
    assert third is not second
    torch.testing.assert_close(third["map_w"][:16], branches[0]["map_w"],
                               rtol=0, atol=0)
    assert lb.ladder_pack_cached(flat, 2, torch.float32) is third


def test_pack_cache_keeps_no_weight_alive_and_forgets_dead_ones():
    """The cache holds no strong reference to a weight: once the branches
    die their entry goes; a new tensor at a reused address gets a fresh
    pack, not the dead one's."""
    branches = _torch_branches(2)
    flat = _flat(branches, [torch.zeros(1, 1, 16)] * 2)
    before = wc.size()
    lb.ladder_pack_cached(flat, 2, torch.float32)
    assert wc.size() == before + 1
    del flat, branches
    gc.collect()
    assert wc.size() == before
    fresh = _torch_branches(3)
    got = lb.ladder_pack_cached(_flat(fresh, [torch.zeros(1, 1, 16)] * 2), 2,
                                torch.float32)
    torch.testing.assert_close(got["wo"][0], fresh[0]["wo"], rtol=0, atol=0)


def test_pack_holds_the_stage_layout():
    """Shapes and dtypes the stage launches check: matrices in the
    activation dtype, vectors in fp32, per kind stacked by branch."""
    branches = _torch_branches(4)
    pk = lb.ladder_pack(_flat([{k: v.bfloat16() for k, v in w.items()}
                               for w in branches],
                              [torch.zeros(1, 1, 16)] * 2), 2,
                        torch.bfloat16)
    shapes = {"map_w": (32, H), "map_b": (32,), "wqkv": (2, 48, 16),
              "bqkv": (2, 48), "wo": (2, 16, 16), "bo": (2, 16),
              "w1": (2, 64, 16), "b1": (2, 64), "w2": (2, 16, 64),
              "b2": (2, 16), "ln1_w": (2, 16), "ln2_b": (2, 16)}
    for k, shape in shapes.items():
        assert tuple(pk[k].shape) == shape, k
        want = torch.float32 if pk[k].dim() == 1 or k[0] in "bl" \
            else torch.bfloat16
        assert pk[k].dtype == want, k
        assert pk[k].is_contiguous(), k
