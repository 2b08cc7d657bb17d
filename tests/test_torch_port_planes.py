"""The tf32 planes of the fp32 float products (`ops/weight_codes.py:
tf32_planes`, the function the card's kernels compute as `split_tf32`), and
the cache of the float kernels' packed weights, planes and fp32 vectors.

The planes are held bit for bit against an emulation in numpy float64
that rounds the significand to 11 bits half away from zero, ties and
carries included.  The 3xTF32 sum the kernels take (lo*hi + hi*lo + hi*hi
per product, 64-deep k slices each in a fresh fp32 accumulator joined by a
rounded fp32 add) is emulated on those planes in numpy fp32 and held
against the float64 product at K = 96, 768 and 3072 within 1e-6 of the
sum of |a||w| (the dropped lo*lo term is ~2^-22 of a product; fp32 sums
of 64 terms add ~2^-20 at most).  The cache follows the weight-code tests
of `tests/test_torch_port_gates.py`.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from autognothi_tpu_torch.ops import weight_codes as wc


def _rna_tf32(x: np.ndarray) -> np.ndarray:
    """x (float32) rounded to 11 significant bits, half away from zero."""
    m, e = np.frexp(x.astype(np.float64))  # x = m 2^e, 0.5 <= |m| < 1
    r = np.floor(np.abs(m) * 2.0 ** 11 + 0.5) * np.sign(m)
    return np.ldexp(r, e - 11).astype(np.float32)


def _planes_np(x: np.ndarray):
    hi = _rna_tf32(x)
    return hi, _rna_tf32((x - hi).astype(np.float32))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _normal_values(rng, n: int) -> np.ndarray:
    """Random sign, exponent in [2^-40, 2^40), random significand bits,
    then the ties: hi ties (low 13 bits 0x1000), lo ties (bit 12 clear,
    bits 11 and 0 set), carries into the exponent, exact tf32 values."""
    sign = rng.randint(0, 2, n).astype(np.uint32) << 31
    exp = (rng.randint(127 - 40, 127 + 40, n).astype(np.uint32)) << 23
    frac = rng.randint(0, 1 << 23, n).astype(np.uint32)
    x = sign | exp | frac
    q = n // 8
    x[:q] = (x[:q] & ~np.uint32(0x1FFF)) | np.uint32(0x1000)
    x[q:2 * q] = (x[q:2 * q] & ~np.uint32(0x1FFF)) | np.uint32(0x0801) \
        | (rng.randint(0, 1 << 10, q).astype(np.uint32) << 1)
    x[2 * q:3 * q] |= np.uint32(0x7FF000)  # all-ones high bits: a carry
    x[3 * q:4 * q] &= ~np.uint32(0x1FFF)   # exactly tf32
    return x.view(np.float32)


def test_planes_match_the_numpy_rounding_bit_for_bit():
    rng = np.random.RandomState(0)
    x = _normal_values(rng, 1 << 16)
    hi, lo = wc.tf32_planes(torch.from_numpy(x))
    want_hi, want_lo = _planes_np(x)
    assert np.array_equal(_bits(hi.numpy()), _bits(want_hi))
    assert np.array_equal(_bits(lo.numpy()), _bits(want_lo))
    # 13 low bits of both planes zero; hi + lo carries 22 significand bits
    assert not (_bits(hi.numpy()) & 0x1FFF).any()
    assert not (_bits(lo.numpy()) & 0x1FFF).any()
    rel = np.abs(hi.double().numpy() + lo.double().numpy() - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -22


def test_planes_round_ties_away_from_zero():
    one_tie = np.array([0x3F801000, 0xBF801000, 0x3F803000, 0x3F800FFF],
                       np.uint32).view(np.float32)
    hi, lo = wc.tf32_planes(torch.from_numpy(one_tie))
    assert _bits(hi.numpy()).tolist() == [0x3F802000, 0xBF802000,
                                           0x3F804000, 0x3F800000]
    # the lo plane of 1 + 0xFFF ulp: 0xFFF ulp = 4095 x 2^-23, 12 bits with
    # the last set, a tie at 11 bits rounded away from zero: 4096 x 2^-23
    assert lo[3].item() == 4096 * 2.0 ** -23
    assert lo[0].item() == -(2.0 ** -11) and lo[1].item() == 2.0 ** -11


def _three_product_sum(a: np.ndarray, w: np.ndarray) -> np.ndarray:
    """C = A W^T as the kernels sum it: per 64-deep k slice a fresh fp32
    sum of lo*hi + hi*lo + hi*hi terms (each exact in fp32), the slices
    joined by rounded fp32 adds."""
    ah, al = (p.numpy() for p in wc.tf32_planes(torch.from_numpy(a)))
    wh, wl = (p.numpy() for p in wc.tf32_planes(torch.from_numpy(w)))
    acc = np.zeros((a.shape[0], w.shape[0]), np.float32)
    for k0 in range(0, a.shape[1], 64):
        part = np.zeros_like(acc)
        for k in range(k0, min(k0 + 64, a.shape[1])):
            for x, y in ((al, wh), (ah, wl), (ah, wh)):
                part = (part + np.outer(x[:, k], y[:, k])).astype(np.float32)
        acc = (acc + part).astype(np.float32)
    return acc


@pytest.mark.parametrize("k", [96, 768, 3072])
def test_three_product_slice_sum_is_fp32_grade(k):
    rng = np.random.RandomState(k)
    a = rng.randn(6, k).astype(np.float32)
    w = (rng.randn(5, k) * k ** -0.5).astype(np.float32)
    got = _three_product_sum(a, w)
    exact = a.astype(np.float64) @ w.astype(np.float64).T
    scale = np.abs(a).astype(np.float64) @ np.abs(w).astype(np.float64).T
    assert (np.abs(got - exact) / scale).max() <= 1e-6
    # one TF32 product alone is three decimal digits: the split matters
    one = _rna_tf32(a).astype(np.float64) @ _rna_tf32(w).astype(np.float64).T
    assert (np.abs(one - exact) / scale).max() > 1e-5


# ------------------------------------------ the float kernels' cache


def test_float_weight_packs_and_splits_once_per_version():
    g = torch.Generator().manual_seed(0)
    wq, wk, wv = (torch.nn.Parameter(torch.randn(24, 16, generator=g))
                  for _ in range(3))
    hi, lo = wc.float_weight((wq, wk, wv), torch.float32)
    want = wc.tf32_planes(torch.cat([wq, wk, wv]).detach())
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
    again = wc.float_weight((wq, wk, wv), torch.float32)
    assert again[0] is hi and again[1] is lo
    (b16,) = wc.float_weight((wq, wk, wv), torch.bfloat16)
    assert b16.dtype == torch.bfloat16
    assert torch.equal(b16, torch.cat([wq, wk, wv]).detach().bfloat16())
    with torch.no_grad():
        wk.add_(1.0)  # an optimizer step
    hi2, lo2 = wc.float_weight((wq, wk, wv), torch.float32)
    assert hi2 is not hi
    want = wc.tf32_planes(torch.cat([wq, wk, wv]).detach())
    assert torch.equal(hi2, want[0]) and torch.equal(lo2, want[1])
    with torch.no_grad():
        wv.copy_(wv * -2)  # a checkpoint loaded in place
    hi3, _ = wc.float_weight((wq, wk, wv), torch.float32)
    assert torch.equal(hi3, wc.tf32_planes(
        torch.cat([wq, wk, wv]).detach())[0])


def test_vec32_copies_once_and_passes_fp32_through():
    v32 = torch.randn(8)
    assert wc.vec32(v32) is v32
    v16 = torch.randn(8, dtype=torch.bfloat16)
    got = wc.vec32(v16)
    assert got.dtype == torch.float32 and torch.equal(got, v16.float())
    assert wc.vec32(v16) is got
    with torch.no_grad():
        v16.mul_(3)
    assert torch.equal(wc.vec32(v16), v16.float())


def test_float_weight_of_a_new_tensor_at_a_reused_address():
    """Another tensor over the same memory, its values written where no
    version counter sees it, is another weight: it gets its own planes."""
    rng = np.random.RandomState(2)
    arr = rng.randn(8, 32).astype(np.float32)
    w = torch.from_numpy(arr)
    old = wc.float_weight((w,), torch.float32)[0].clone()
    arr[:] = rng.randn(8, 32)  # no version bump
    for _ in range(2):  # w alive, then dead (its id free to be reused)
        w2 = torch.from_numpy(arr)
        assert w2.data_ptr() == w.data_ptr() and w2._version == w._version
        got = wc.float_weight((w2,), torch.float32)[0]
        assert torch.equal(got, wc.tf32_planes(w2)[0])
        assert not torch.equal(got, old)
        del w, w2
        gc.collect()
        w = torch.from_numpy(arr)
        old = wc.float_weight((w,), torch.float32)[0].clone()
        arr[:] = rng.randn(8, 32)


def test_float_weight_keeps_no_weight_alive():
    w = torch.randn(16, 16)
    v = torch.randn(16, dtype=torch.bfloat16)
    refs = (weakref.ref(w), weakref.ref(v))
    before = wc.size()
    wc.float_weight((w,), torch.float32)
    wc.vec32(v)
    assert wc.size() == before + 2
    del w, v
    gc.collect()
    assert all(r() is None for r in refs)
    assert wc.size() == before
