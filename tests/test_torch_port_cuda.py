"""The port's CUDA kernels against their plain versions on the card.

These need an NVIDIA GPU and nvcc; elsewhere they skip.  On the card:
    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py
(`--noconftest`: the JAX conftest needs JAX, which the card's host lacks.)
Tolerance: fp32 max-abs <= 1e-4 * max(1, max|ref|) (same fp32 math in a
different summation order); bf16 <= 3e-2 * max(1, max|ref|) (one bf16 ulp
at the cast points, where fp32 sums that differ in order may round apart).
"""

from unittest import mock

import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    from autognothi_tpu_torch.utils.devices import resolve_device

    return resolve_device("cuda")


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    bound = TOL[dtype] * max(1.0, want.float().abs().max().item())
    assert err <= bound, (err, bound)


def _rand(g, dev, *shape, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).to(dev)


def _mask(g, dev, b, t, random):
    m = torch.ones(b, t)
    if random:
        m = (torch.rand(b, t, generator=g) > 0.4).float()
        m[:, 0] = 1
    return m.to(dev)


@pytest.mark.parametrize("random_mask", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,heads", [(96, 12), (64, 4)])
def test_attention_block_kernel(dev, h, heads, dtype, random_mask):
    from autognothi_tpu_torch.ops import attention_block as ab

    g = torch.Generator().manual_seed(0)
    b, t = 3, 37
    resid = _rand(g, dev, b, t, h).to(dtype)
    ws = tuple(_rand(g, dev, *s, scale=0.1) for s in [(h, h), (h,)] * 4)
    ln = (1 + _rand(g, dev, h, scale=0.1), _rand(g, dev, h, scale=0.1), 1e-12)
    mask = _mask(g, dev, b, t, random_mask)
    for position in ("prologue", "epilogue", "none"):
        before = ab.COUNTER.count
        got = ab.attention_block(resid, mask, ws, heads, "mul", ln=ln,
                                 ln_position=position)
        assert ab.COUNTER.count == before + 1
        want = ab.attention_block_plain(
            resid, mask, *ws, ln[0], ln[1], n_heads=heads, mode="mul",
            ln_position=position, ln_eps=1e-12)
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_block_kernel(dev, dtype):
    from autognothi_tpu_torch.ops import mlp_block as mb

    g = torch.Generator().manual_seed(1)
    b, t, h, inter = 2, 29, 64, 256
    resid = _rand(g, dev, b, t, h).to(dtype)
    w1, b1 = _rand(g, dev, inter, h, scale=0.1), _rand(g, dev, inter)
    w2, b2 = _rand(g, dev, h, inter, scale=0.05), _rand(g, dev, h)
    ln = (1 + _rand(g, dev, h, scale=0.1), _rand(g, dev, h, scale=0.1), 1e-12)
    for position in ("prologue", "epilogue", "none"):
        got = mb.mlp_block(resid, w1, b1, w2, b2, ln=ln, ln_position=position)
        want = mb.mlp_block_plain(resid, w1, b1, w2, b2, ln[0], ln[1],
                                  ln_position=position, ln_eps=1e-12)
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ladder_block_kernel_and_backward(dev, dtype):
    from autognothi_tpu_torch.ops import ladder_block as lb

    g = torch.Generator().manual_seed(2)
    b, t, h, s = 2, 21, 64, 32
    hid = _rand(g, dev, b, t, h).to(dtype)
    sides = [_rand(g, dev, b, t, s).to(dtype) for _ in range(2)]
    shapes = {"map_w": (s, h), "w1": (4 * s, s), "b1": (4 * s,),
              "w2": (s, 4 * s)}
    branches = [{k: _rand(g, dev, *shapes.get(k, (s, s) if k.startswith("w")
                                              else (s,)), scale=0.1)
                 for k in lb.BRANCH_KEYS} for _ in range(2)]
    mask = _mask(g, dev, b, t, True)
    got = lb.ladder_block(hid, sides, mask, branches, 4, "mul", True, 1e-12)
    want = lb.ladder_block_plain(
        hid, mask, *sides,
        *(w[k].to(dtype) for w in branches for k in lb.BRANCH_KEYS),
        n_branches=2, n_heads=4, mode="mul", pre_norm=True, ln_eps=1e-12)
    for x, y in zip(got, want):
        _close(x, y, dtype)
    # BERT's layer kind: the additive bias with post-norm
    bias = (1 - mask) * torch.finfo(torch.float32).min
    got = lb.ladder_block(hid, sides, bias, branches, 4, "add", False, 1e-12)
    want = lb.ladder_block_plain(
        hid, bias, *sides,
        *(w[k].to(dtype) for w in branches for k in lb.BRANCH_KEYS),
        n_branches=2, n_heads=4, mode="add", pre_norm=False, ln_eps=1e-12)
    for x, y in zip(got, want):
        _close(x, y, dtype)
    if dtype == torch.float32:  # backward = autograd through the plain math
        x = hid.clone().requires_grad_(True)
        out = lb.ladder_block(x, sides, mask, branches, 4, "mul", True, 1e-12)
        sum(o.square().sum() for o in out).backward()
        assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n", [(4099, 768), (12608, 96), (300, 200)])
def test_gemm_tiles_and_epilogues(dev, m, n, dtype):
    """Both GEMM tile variants (the large tile engages when its tiles fill
    the card's SMs), with and without the LN prologue, every epilogue."""
    from autognothi_tpu_torch.kernels import primitives as kp

    g = torch.Generator().manual_seed(3)
    k = 96 if n == 96 else 768
    a = _rand(g, dev, m, k).to(dtype)
    w = _rand(g, dev, n, k, scale=k ** -0.5).to(dtype)
    bias, resid = _rand(g, dev, n), _rand(g, dev, m, n).to(dtype)
    lnw, lnb = 1 + _rand(g, dev, k, scale=0.1), _rand(g, dev, k, scale=0.1)
    for use_ln in (False, True):
        x = a.float()
        ln = None
        if use_ln:
            mean, rstd = kp.rowstats(a, 1e-12)
            ln = (mean, rstd, lnw, lnb)
            x = (((x - mean[:, None]) * rstd[:, None]) * lnw + lnb).to(dtype)
        y = x.float() @ w.float().T + bias
        for epi in (kp.EPI_BIAS, kp.EPI_BIAS_GELU, kp.EPI_BIAS_RESID):
            want = y
            if epi == kp.EPI_BIAS_GELU:
                want = torch.nn.functional.gelu(want)
            want = want.to(dtype)
            if epi == kp.EPI_BIAS_RESID:
                want = resid + want
            got = kp.gemm(a, w, bias, epi, ln=ln,
                          resid=resid if epi >= kp.EPI_BIAS_RESID else None)
            _close(got, want, dtype)


# ------------------------------------------------------------- int8 path
# The int8 ops against their plain int8 versions.  Both quantize the same
# values with the same recipe, but an input that differs in its last bit
# (LayerNorm and softmax sums in another order) can fall on the other side
# of a code boundary now and then; each such flip moves its row by one
# quantization step (~1e-3 here), so the bound allows a few steps: fp32
# 1e-2 x max(1, max|ref|); bf16 as the float ops.
TOL_INT8 = {torch.float32: 1e-2, torch.bfloat16: 3e-2}


def _close_int8(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    bound = TOL_INT8[dtype] * max(1.0, want.float().abs().max().item())
    assert torch.isfinite(got.float()).all() and err <= bound, (err, bound)


def test_quant_rows_kernel_rounds_ties_to_even_and_divides(dev):
    from autognothi_tpu_torch.kernels import primitives as kp

    ties = torch.tensor([[127.0, 2.5, -3.5, 0.5, 1.5, -0.5, -126.5]],
                        device=dev)
    want = [127, 2, -4, 0, 2, 0, -126]
    for weight in (False, True):  # amax 127: both scales are exactly 1
        q, s = kp.quant_rows(ties, weight=weight)
        assert q.tolist() == [want] and s.tolist() == [1.0]
    # 127 / amax is one correctly rounded division, as jnp's
    q, _ = kp.quant_rows(torch.tensor([[5.988135, 0.070726]], device=dev))
    assert q.tolist() == [[127, 1]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_rows_kernel_matches_plain(dev, dtype):
    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.models.common import layer_norm
    from autognothi_tpu_torch.ops.mlp_block import _quant_rows, quant_cols

    g = torch.Generator().manual_seed(4)
    x = _rand(g, dev, 301, 768, scale=2.0).to(dtype)
    x[5] = 0  # an all-zero row: scale 1e-12 / 127, codes 0
    q, s = kp.quant_rows(x)
    wq, ws = _quant_rows(x.float())
    assert torch.equal(q, wq) and torch.equal(s, ws[:, 0])
    q, s = kp.quant_rows(x, weight=True)
    wq, ws = quant_cols(x)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    ln = (1 + _rand(g, dev, 768, scale=0.1), _rand(g, dev, 768, scale=0.1))
    q, s = kp.quant_rows(x, ln=(*ln, 1e-12))
    wq, ws = _quant_rows(layer_norm(x, *ln, 1e-12).float())
    # the LN sums run in another order: a code may move by one, rarely, and
    # in bf16 a row's largest value may round to the neighbouring bf16
    diff = (q.int() - wq.int()).abs()
    assert diff.max() <= 1 and diff.float().mean() < 1e-3
    torch.testing.assert_close(
        s, ws[:, 0], rtol=1e-5 if dtype == torch.float32 else 8e-3, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", [(4099, 768, 3072), (300, 200, 96),
                                   (37, 96, 384)])
def test_gemm_i8_tiles_and_epilogues(dev, m, n, k, dtype):
    """Both tile variants and every epilogue against the exact int8 product
    of the plain version; one row and column of 127s drive the int32 sum
    past 2^24 (at K=3072), where fp32 accumulation would round."""
    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.ops.mlp_block import int8_linear

    g = torch.Generator().manual_seed(5)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    a[0], w[0] = 127, 127
    a, w = a.to(dev), w.to(dev)
    sa, sw = _rand(g, dev, m).abs() * 1e-2, _rand(g, dev, n).abs() * 1e-3
    bias, resid = _rand(g, dev, n), _rand(g, dev, m, n).to(dtype)
    y = int8_linear(a, sa[:, None], w, sw, bias)
    gelu = torch.nn.functional.gelu
    cases = {kp.I8_EPI_BIAS: y.to(dtype),
             kp.I8_EPI_BIAS_RESID: resid + y.to(dtype),
             kp.I8_EPI_GELU_F32: gelu(y)}
    for epi, want in cases.items():
        got = kp.gemm_i8(a, sa, w, sw, bias, epi, dtype,
                         resid=resid if epi == kp.I8_EPI_BIAS_RESID else None)
        assert got.dtype == want.dtype
        # same fp32 epilogue on an exact sum: one ulp of the output dtype
        # at most (GELU's erf differs in its last bits)
        ulp = 2e-6 if got.dtype == torch.float32 else 8e-3
        bound = ulp * max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= bound
    _check_fold(kp, a, sa, w, sw, bias, dtype, gelu(y), 3)
    with pytest.raises(ValueError):  # K must be a multiple of 16
        kp.gemm_i8(a[:, :k - 8], sa, w[:, :k - 8].contiguous(), sw, bias,
                   kp.I8_EPI_BIAS, dtype)


def _check_fold(kp, a, sa, w, sw, bias, dtype, gelu, c):
    """I8_EPI_GELU_FOLD (K3's d2 with d3 folded in): one fp32 partial sum
    per column tile of cast(gelu) times c float rows, whose sum is the
    float64 product of the cast GELU and those rows within the int8 bounds
    (erf's last bits, the cast, an fp32 sum in tiles)."""
    g = torch.Generator().manual_seed(c)
    m, n = a.shape[0], w.shape[0]
    fold = _rand(g, a.device, c, n, scale=n ** -0.5)
    part = kp.gemm_i8(a, sa, w, sw, bias, kp.I8_EPI_GELU_FOLD, dtype,
                      fold=kp.fold_planes(fold, dtype), classes=c)
    assert part.dtype == torch.float32 and part.shape[1:] == (m, c)
    want = gelu.to(dtype).double() @ fold.to(dtype).double().T
    _close_int8(part.double().sum(0), want, dtype)


@pytest.mark.parametrize("random_mask", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_attention_and_mlp_block_kernels(dev, dtype, random_mask):
    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import mlp_block as mb

    g = torch.Generator().manual_seed(6)
    b, t, h, inter = 3, 37, 64, 256
    resid = _rand(g, dev, b, t, h).to(dtype)
    ws = tuple(_rand(g, dev, *s, scale=0.1) for s in [(h, h), (h,)] * 4)
    ln = (1 + _rand(g, dev, h, scale=0.1), _rand(g, dev, h, scale=0.1), 1e-12)
    mask = _mask(g, dev, b, t, random_mask)
    w1, b1 = _rand(g, dev, inter, h, scale=0.1), _rand(g, dev, inter)
    w2, b2 = _rand(g, dev, h, inter, scale=0.05), _rand(g, dev, h)
    for position in ("prologue", "epilogue", "none"):
        before = ab.COUNTER_INT8.count
        got = ab.attention_block(resid, mask, ws, 4, "mul", ln=ln,
                                 ln_position=position, quant="int8")
        assert ab.COUNTER_INT8.count == before + 1
        want = ab.attention_block_int8_plain(
            resid, mask, *ws, ln[0], ln[1], n_heads=4, mode="mul",
            ln_position=position, ln_eps=1e-12)
        _close_int8(got, want, dtype)
        before = mb.COUNTER_INT8.count
        got = mb.mlp_block(resid, w1, b1, w2, b2, ln=ln, ln_position=position,
                           quant="int8")
        assert mb.COUNTER_INT8.count == before + 1
        want = mb.mlp_block_int8_plain(resid, w1, b1, w2, b2, ln[0], ln[1],
                                       ln_position=position, ln_eps=1e-12)
        _close_int8(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_ladder_block_kernel_and_backward(dev, dtype):
    from autognothi_tpu_torch.ops import ladder_block as lb

    g = torch.Generator().manual_seed(7)
    b, t, h, s, inter = 2, 21, 64, 32, 256
    hid = _rand(g, dev, b, t, h).to(dtype)
    sides = [_rand(g, dev, b, t, s).to(dtype) for _ in range(2)]
    shapes = {"map_w": (s, h), "w1": (4 * s, s), "b1": (4 * s,),
              "w2": (s, 4 * s)}
    branches = [{k: _rand(g, dev, *shapes.get(k, (s, s) if k.startswith("w")
                                              else (s,)), scale=0.1)
                 for k in lb.BRANCH_KEYS} for _ in range(2)]
    trunk = {"w1": _rand(g, dev, inter, h, scale=0.1),
             "b1": _rand(g, dev, inter),
             "w2": _rand(g, dev, h, inter, scale=0.05),
             "b2": _rand(g, dev, h),
             "ln_w": 1 + _rand(g, dev, h, scale=0.1),
             "ln_b": _rand(g, dev, h, scale=0.1)}
    mask = _mask(g, dev, b, t, True)
    before = lb.COUNTER_MLP_LADDER.count
    got = lb.mlp_ladder_block(hid, sides, mask, trunk, branches, 4, "mul",
                              1e-12)
    assert lb.COUNTER_MLP_LADDER.count == before + 1 and len(got) == 3
    tensors, static = lb.mlp_ladder_block_args(hid, sides, mask, trunk,
                                               branches, 4, "mul", 1e-12)
    for x, y in zip(got, lb.mlp_ladder_block_plain(*tensors, **static)):
        _close_int8(x, y, dtype)
    if dtype == torch.float32:  # backward = autograd through the float step
        x = hid.clone().requires_grad_(True)
        out = lb.mlp_ladder_block(x, sides, mask, trunk, branches, 4, "mul",
                                  1e-12)
        sum(o.square().sum() for o in out).backward()
        assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0


@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_block_kernel(dev, dtype, has_ln):
    from autognothi_tpu_torch.ops import head_block as hb

    g = torch.Generator().manual_seed(8)
    b, t, h_in, inter, c = 2, 45, 32, 128, 10
    x = _rand(g, dev, b, t, h_in).to(dtype)
    ws = (_rand(g, dev, inter, h_in, scale=0.2), _rand(g, dev, inter),
          _rand(g, dev, inter, inter, scale=0.1), _rand(g, dev, inter),
          _rand(g, dev, c, inter, scale=0.1), _rand(g, dev, c))
    ln = ((1 + _rand(g, dev, h_in, scale=0.1), _rand(g, dev, h_in, scale=0.1))
          if has_ln else (None, None))
    before = hb.COUNTER.count
    got = hb.explainer_head_block(x, *ws, *ln, 1e-5)
    assert hb.COUNTER.count == before + 1 and got.shape == (b, t, c)
    tensors, static = hb.explainer_head_block_args(x, *ws, *ln, 1e-5)
    _close_int8(got, hb.head_int8_plain(*tensors, **static), dtype)


# ----------------------------------------- masked attention (K9, K10)


@pytest.mark.parametrize("mode", ["mul", "add"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 64])
def test_masked_attention_kernel(dev, d, dtype, mode):
    """K9 on the split-head views the model hands it (strided, no copy)
    and on contiguous <N, h, T, D>, against its plain version."""
    from autognothi_tpu_torch.models.common import split_heads
    from autognothi_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(9)
    n, heads, t = 3, 12, 197
    qkv = _rand(g, dev, 3, n, t, heads * d).to(dtype)
    views = [split_heads(x, heads) for x in qkv]  # strides (T*H, d, H, 1)
    dense = [x.contiguous() for x in views]
    mask = _mask(g, dev, n, t, True)
    if mode == "add":
        mask = (1 - mask) * torch.finfo(torch.float32).min
    for q, k, v in (views, dense):
        before = fa.COUNTER.count
        got = fa.masked_attention(q, k, v, mask, mode=mode)
        assert fa.COUNTER.count == before + 1 and got.shape == q.shape
        _close(got, fa.masked_attention_plain(q, k, v, mask, mode=mode),
               dtype)


@pytest.mark.parametrize("mode", ["mul", "add"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 64])
def test_ladder_attention_kernel(dev, d, dtype, mode):
    from autognothi_tpu_torch.ops import ladder_block as lb

    g = torch.Generator().manual_seed(10)
    b, heads, t = 2, 12, 197
    qkvs = [tuple(_rand(g, dev, b, t, heads * d).to(dtype) for _ in range(3))
            for _ in range(2)]
    mask = _mask(g, dev, b, t, True)
    if mode == "add":
        mask = (1 - mask) * torch.finfo(torch.float32).min
    before = lb.COUNTER_ATTENTION.count
    got = lb.ladder_attention(qkvs, mask, heads, mode)
    assert lb.COUNTER_ATTENTION.count == before + 1
    want = lb.ladder_attention_plain(mask, *(x for tr in qkvs for x in tr),
                                     n_heads=heads, mode=mode)
    for x, y in zip(got, want):
        _close(x, y, dtype)


@pytest.mark.parametrize("mode", ["mul", "mul_soft", "add"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,s,nb", [(2, 197, 96, 2), (3, 1, 8, 1),
                                      (2, 17, 48, 3), (2, 33, 128, 2),
                                      (1, 513, 96, 1), (2, 200, 72, 16)])
def test_ladder_attention_one_launch(dev, b, t, s, nb, dtype, mode):
    """K10 at d = 8 on its one-launch route (`csrc/ladder_attention.cu`):
    every branch in one launch at any T, side width (a multiple of 8 up
    to 128) and branch count up to 16, against the plain version; "mul"
    with a 0/1 mask (zero K rows) and with other values (the scores
    multiplied), "add" with BERT's finfo.min bias."""
    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.ops import ladder_block as lb

    g = torch.Generator().manual_seed(11)
    qkvs = [tuple(_rand(g, dev, b, t, s).to(dtype) for _ in range(3))
            for _ in range(nb)]
    mask = _mask(g, dev, b, t, True)
    if mode == "mul_soft":
        mask = mask * (0.5 + torch.rand(b, t, generator=g).to(dev))
    if mode == "add":
        mask = (1 - mask) * torch.finfo(torch.float32).min
    op = "add" if mode == "add" else "mul"
    assert lb.ladder_attention_route(s, s // 8, nb, t) == "narrow"
    calls = []
    narrow = kp.ladder_attention_narrow
    with mock.patch.object(lb, "ladder_attention_narrow",
                           lambda *a: calls.append(1) or narrow(*a)):
        got = lb.ladder_attention(qkvs, mask, s // 8, op)
    assert calls == [1]
    want = lb.ladder_attention_plain(mask, *(x for tr in qkvs for x in tr),
                                     n_heads=s // 8, mode=op)
    for x, y in zip(got, want):
        assert torch.isfinite(x.float()).all()
        _close(x, y, dtype)


def _step_models(dev):
    from autognothi_tpu_torch.models.ltt_vit import LttViTConfig, init_ltt_vit

    cfg = LttViTConfig(
        attention_probs_dropout_prob=0.0, explainer_s_attn_num_layers=1,
        explainer_s_head_hidden_size=64, explainer_normalize=True,
        hidden_dropout_prob=0.0, hidden_size=64, intermediate_size=256,
        layer_norm_eps=1e-12, num_attention_heads=4, num_hidden_layers=2,
        num_labels=5, s_attn_hidden_size=32, s_attn_intermediate_size=128,
        img_channels=3, img_px_size=32, img_patch_size=8)
    srg = init_ltt_vit(cfg, "surrogate", torch.Generator().manual_seed(0))
    exp = init_ltt_vit(cfg, "explainer", torch.Generator().manual_seed(1))
    return cfg, srg.to(dev), exp.to(dev)


@pytest.mark.parametrize("pallas", ["2", "1"])
def test_train_step_kernels_against_plain(dev, pallas, monkeypatch):
    """One explainer step (fp32 teacher) with the kernels against the same
    step in pallas mode "0" (plain math everywhere), on the same masks and
    weights: loss within 1e-4 relative, trainable gradients within 1e-4 x
    max|g| (fp32 sums in another order); the kernel counters show which
    kernels ran."""
    import copy

    from autognothi_tpu_torch.ops import flash_attention as fa
    from autognothi_tpu_torch.ops import ladder_block as lb
    from autognothi_tpu_torch.parallel.train_step import \
        make_explainer_train_step
    from autognothi_tpu_torch.pipeline.training import AdamW
    from autognothi_tpu_torch.recipes.ltt_vit import ltt_vit_recipe

    class Spy(AdamW):
        def update(self, params, grads, lr, update_mask):
            self.grads = {k: v.detach().clone() for k, v in grads.items()
                          if v is not None}
            super().update(params, grads, lr, update_mask)

    monkeypatch.setenv("AUTOGNOTHI_INT8_TEACHER", "0")
    recipe = ltt_vit_recipe()
    cfg, srg, exp = _step_models(dev)
    srg.requires_grad_(False)
    trainable = recipe.trainable(cfg, "explainer")
    g = torch.Generator().manual_seed(2)
    xs = torch.randn(2, 3, 32, 32, generator=g).to(dev)
    masks = torch.randint(0, 2, (2, 4, 16), generator=g,
                          dtype=torch.int32).to(dev)
    null = torch.full((1, 5), 0.2, device=dev)
    step = make_explainer_train_step(recipe, cfg, 16, 4)
    out = {}
    for mode in (pallas, "0"):
        model = copy.deepcopy(exp)
        for name, p in model.named_parameters():
            p.requires_grad_(trainable(name))
        opt = Spy(dict(model.named_parameters()), trainable)
        monkeypatch.setenv("AUTOGNOTHI_PALLAS", mode)
        before = (fa.COUNTER.count, lb.COUNTER.count)
        loss = step(model, opt, srg, null, xs, None, 1e-3,
                    {k: 1.0 for k in opt.names}, 2, masks=masks)
        torch.cuda.synchronize()
        out[mode] = (loss.item(), opt.grads,
                     (fa.COUNTER.count - before[0],
                      lb.COUNTER.count - before[1]))
    (loss, got, calls), (ref_loss, want, ref_calls) = out[pallas], out["0"]
    assert abs(loss - ref_loss) <= 1e-4 * abs(ref_loss), (loss, ref_loss)
    # mode "1", K9: 2 + 2 (teacher) + 2 + 2 (v_1) + 2 + 2 + 1 (forward);
    # mode "2", K5: one per trunk layer in the teacher, v_1 and forward
    assert calls == ((13, 0) if pallas == "1" else (0, 6)), calls
    assert ref_calls == (0, 0)
    g_max = max(v.abs().max().item() for v in want.values())
    for k, v in want.items():
        err = (got[k] - v).abs().max().item()
        assert err <= 1e-4 * g_max, (k, err, g_max)


# ------------------------------------------- LTT BERT shapes (T = 512)


@pytest.mark.parametrize("mode", ["mul", "add"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 64])
def test_attention_core_at_512(dev, d, dtype, mode):
    """T = 512, BERT's length: the core walks its eight 64-key chunks (bf16
    twice, to round p where JAX does).  K9 on split heads against its plain
    version."""
    from autognothi_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(11)
    n, heads, t = 2, 12, 512
    q, k, v = (_rand(g, dev, n, heads, t, d).to(dtype) for _ in range(3))
    mask = _mask(g, dev, n, t, True)
    if mode == "add":
        mask = (1 - mask) * torch.finfo(torch.float32).min
    got = fa.masked_attention(q, k, v, mask, mode=mode)
    _close(got, fa.masked_attention_plain(q, k, v, mask, mode=mode), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bert_attention_blocks_at_512(dev, dtype):
    """K6 and K1 at <2, 512, 768>, "add" bias, LN epilogue.  In fp32 the
    int8 block does not fit the JAX budget and runs the float block (K6);
    in bf16 it is K1."""
    from autognothi_tpu_torch.ops import attention_block as ab

    g = torch.Generator().manual_seed(12)
    b, t, h = 2, 512, 768
    resid = _rand(g, dev, b, t, h).to(dtype)
    ws = tuple(_rand(g, dev, *s, scale=h ** -0.5) for s in [(h, h), (h,)] * 4)
    ln = (1 + _rand(g, dev, h, scale=0.1), _rand(g, dev, h, scale=0.1), 1e-12)
    bias = (1 - _mask(g, dev, b, t, True)) * torch.finfo(torch.float32).min
    for quant in ("none", "int8"):
        before = (ab.COUNTER.count, ab.COUNTER_INT8.count)
        got = ab.attention_block(resid, bias, ws, 12, "add", ln=ln,
                                 ln_position="epilogue", quant=quant)
        int8 = quant == "int8" and dtype == torch.bfloat16
        assert (ab.COUNTER.count - before[0],
                ab.COUNTER_INT8.count - before[1]) == \
            ((0, 1) if int8 else (1, 0))
        plain = ab.attention_block_int8_plain if int8 \
            else ab.attention_block_plain
        want = plain(resid, bias, *ws, ln[0], ln[1], n_heads=12, mode="add",
                     ln_position="epilogue", ln_eps=1e-12)
        (_close_int8 if int8 else _close)(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bert_side_layer_at_512(dev, dtype):
    """The explainer's 96-wide side layer at <2, 512, 96> (12 heads of d =
    8), as the model calls it: the attention block without LN, "add" bias,
    and the MLP block with its LN epilogue, float (K6, K7) and int8 (K1,
    K4), each one launch."""
    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import mlp_block as mb

    g = torch.Generator().manual_seed(15)
    b, t, s = 2, 512, 96
    x = _rand(g, dev, b, t, s).to(dtype)
    ws = tuple(_rand(g, dev, *sh, scale=s ** -0.5) for sh in [(s, s), (s,)] * 4)
    w1, b1 = _rand(g, dev, 4 * s, s, scale=s ** -0.5), _rand(g, dev, 4 * s)
    w2, b2 = _rand(g, dev, s, 4 * s, scale=(4 * s) ** -0.5), _rand(g, dev, s)
    ln = (1 + _rand(g, dev, s, scale=0.1), _rand(g, dev, s, scale=0.1), 1e-12)
    ones, zeros = torch.ones(s, device=dev), torch.zeros(s, device=dev)
    bias = (1 - _mask(g, dev, b, t, True)) * torch.finfo(torch.float32).min
    for quant in ("none", "int8"):
        int8 = quant == "int8"
        counters = (ab.COUNTER_INT8, mb.COUNTER_INT8) if int8 \
            else (ab.COUNTER, mb.COUNTER)
        before = [c.count for c in counters]
        got = ab.attention_block(x, bias, ws, 12, "add", ln=None,
                                 ln_position="epilogue", quant=quant)
        plain = ab.attention_block_int8_plain if int8 \
            else ab.attention_block_plain
        want = plain(x, bias, *ws, ones, zeros, n_heads=12, mode="add",
                     ln_position="none", ln_eps=1e-12)
        (_close_int8 if int8 else _close)(got, want, dtype)
        got = mb.mlp_block(x, w1, b1, w2, b2, ln=ln, ln_position="epilogue",
                           quant=quant)
        plain = mb.mlp_block_int8_plain if int8 else mb.mlp_block_plain
        want = plain(x, w1, b1, w2, b2, ln[0], ln[1], ln_position="epilogue",
                     ln_eps=1e-12)
        (_close_int8 if int8 else _close)(got, want, dtype)
        assert [c.count for c in counters] == [n + 1 for n in before]


@pytest.mark.parametrize("n_tiles", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8q_chain_at_bert_base(dev, dtype, n_tiles, monkeypatch):
    """The int8 split MLP at 768/3072, T = 512: the gate picks 2 tiles, a
    lowered `gates.VMEM_BUDGET_BYTES` 4 and 8; LN prologue, epilogue and
    none: one launch per tile, within the int8 bounds of the plain chain
    (1e-2, at most 1% of values beyond 1e-4 in fp32)."""
    from autognothi_tpu_torch.ops import gates
    from autognothi_tpu_torch.ops import mlp_block as mb

    budget = _SPLIT_BUDGETS[dtype, "int8"][n_tiles]
    if budget is not None:
        monkeypatch.setattr(gates, "VMEM_BUDGET_BYTES", budget)
    assert gates.mlp_block_tiles(512, 768, 3072, dtype, "int8") == n_tiles
    g = torch.Generator().manual_seed(13 + n_tiles)
    resid, ws, ln = _bert_mlp(g, dev, dtype)
    for position in ("prologue", "epilogue", "none"):
        before = mb.COUNTER_INT8_TILED.count
        got = mb.mlp_block(resid, *ws, ln=ln, ln_position=position,
                           quant="int8")
        assert mb.COUNTER_INT8_TILED.count == before + n_tiles
        tensors, static = mb.mlp_block_args(resid, *ws, ln=ln,
                                            ln_position=position)
        want = mb.mlp_block_int8_tiled_plain(*tensors, n_tiles=n_tiles,
                                             **static)
        _close_int8(got, want, dtype)
        if dtype == torch.float32:
            assert _int8_flip_share(got, want, dtype) <= 1e-2


_SPLIT_BUDGETS = {  # (dtype, quant) -> {tiles: the budget that gives them}
    (torch.float32, "int8"): {2: None, 4: 10 * 2 ** 20, 8: 7 * 2 ** 20},
    (torch.bfloat16, "int8"): {2: None, 4: 7 * 2 ** 20, 8: 5 * 2 ** 20},
}


def _bert_mlp(g, dev, dtype, b=2):
    t, h, inter = 512, 768, 3072
    resid = _rand(g, dev, b, t, h).to(dtype)
    w1, b1 = _rand(g, dev, inter, h, scale=h ** -0.5), _rand(g, dev, inter)
    w2, b2 = _rand(g, dev, h, inter, scale=inter ** -0.5), _rand(g, dev, h)
    ln = (1 + _rand(g, dev, h, scale=0.1), _rand(g, dev, h, scale=0.1), 1e-12)
    ws = tuple(x.to(dtype) for x in (w1, b1, w2, b2))
    return resid, ws, ln


def _int8_flip_share(got, want, dtype):
    """The share of values beyond the float tolerance (a flipped code)."""
    bound = TOL[dtype] * max(1.0, want.float().abs().max().item())
    return ((got.float() - want.float()).abs() > bound).float().mean().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ladder_add_post_norm_at_bert_base(dev, dtype):
    """K5 at 768 -> 2 x 96 (12 heads of d = 8), T = 512, BERT's layers."""
    from autognothi_tpu_torch.ops import ladder_block as lb

    g = torch.Generator().manual_seed(14)
    b, t, h, s = 2, 512, 768, 96
    hid = _rand(g, dev, b, t, h).to(dtype)
    sides = [_rand(g, dev, b, t, s).to(dtype) for _ in range(2)]
    shapes = {"map_w": (s, h), "w1": (4 * s, s), "b1": (4 * s,),
              "w2": (s, 4 * s)}
    branches = [{k: _rand(g, dev, *shapes.get(k, (s, s) if k.startswith("w")
                                              else (s,)), scale=0.1)
                 for k in lb.BRANCH_KEYS} for _ in range(2)]
    bias = (1 - _mask(g, dev, b, t, True)) * torch.finfo(torch.float32).min
    got = lb.ladder_block(hid, sides, bias, branches, 12, "add", False,
                          1e-12)
    tensors, static = lb.ladder_block_args(hid, sides, bias, branches, 12,
                                           "add", False, 1e-12)
    for x, y in zip(got, lb.ladder_block_plain(*tensors, **static)):
        _close(x, y, dtype)


# ------------------------------- tensor-core core and GEMM (K9, K7, K8)


def _attention_views(g, dev, n, heads, t, d, dtype, packed):
    """q, k, v as the fused blocks hand them (split-head views of packed
    <N*T, 3H> projections) or as contiguous <N, h, T, D>."""
    if packed:
        qkv = _rand(g, dev, n * t, 3 * heads * d).to(dtype)
        ld = qkv.stride(0)
        return [qkv.as_strided((n, heads, t, d), (t * ld, d, ld, 1),
                               part * heads * d) for part in range(3)]
    return [_rand(g, dev, n, heads, t, d).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("mode", ["mul", "add"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 197, 512])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_tensor_core_attention_grid(dev, d, t, dtype, mode):
    """The core over every head dim it is built for and T at and around
    its 64-key chunks and 64-query tiles, on packed and split-head strides,
    against the plain version (out written as the merged-head view)."""
    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(16)
    n, heads = 2, 3
    mask = _mask(g, dev, n, t, True)
    if mode == "add":
        mask = (1 - mask) * torch.finfo(torch.float32).min
    for packed in (True, False):
        q, k, v = _attention_views(g, dev, n, heads, t, d, dtype, packed)
        out = torch.full((n, t, heads, d), float("nan"), device=dev,
                         dtype=dtype).transpose(1, 2)
        kp.attention_heads(q, k, v, mask, mode, out)
        _close(out, fa.masked_attention_plain(q, k, v, mask, mode=mode),
               dtype)


_GEMM_SHAPES = [(96, 768), (384, 96), (2304, 768), (3072, 768), (768, 3072),
                (2, 3072)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k", _GEMM_SHAPES)
def test_tensor_core_gemm_grid(dev, n, k, dtype):
    """Odd M on both tile sizes, every epilogue, with and without the LN
    prologue; A, out and resid as column slices of wider tensors and W as
    a column slice read through its row stride.  fp32 (3xTF32) is also
    held within 1e-5 x max(1, |ref|) of a float64 product."""
    from autognothi_tpu_torch.kernels import primitives as kp

    g = torch.Generator().manual_seed(17)
    for m in (1, 37, 4099):
        a_wide = _rand(g, dev, m, k + 16).to(dtype)
        a = a_wide[:, 8:8 + k]
        w_wide = _rand(g, dev, n, 2 * k, scale=k ** -0.5).to(dtype)
        w = w_wide[:, k:]
        bias = _rand(g, dev, n)
        r_wide = _rand(g, dev, m, n + 5).to(dtype)
        resid = r_wide[:, 5:]
        lnw, lnb = 1 + _rand(g, dev, k, scale=0.1), _rand(g, dev, k,
                                                          scale=0.1)
        for use_ln in (False, True):
            x = a.double()
            ln = None
            if use_ln:
                mean, rstd = kp.rowstats(a.contiguous(), 1e-12)
                ln = (mean, rstd, lnw, lnb)
                x = (((a.float() - mean[:, None]) * rstd[:, None]) * lnw
                     + lnb).to(dtype).double()
            y = x @ w.double().T + bias.double()
            for epi in (kp.EPI_BIAS, kp.EPI_BIAS_GELU, kp.EPI_BIAS_RESID):
                want = y
                if epi == kp.EPI_BIAS_GELU:
                    want = torch.nn.functional.gelu(want)
                if dtype == torch.float32 and epi == kp.EPI_BIAS:
                    got = kp.gemm(a, w, bias, epi, ln=ln)
                    err = (got.double() - want).abs().max().item()
                    assert err <= 1e-5 * max(1.0, want.abs().max().item()), \
                        (m, use_ln, err)
                want = want.to(dtype)
                if epi == kp.EPI_BIAS_RESID:
                    want = resid + want
                out_wide = torch.zeros(m, n + 3, device=dev, dtype=dtype)
                got = kp.gemm(a, w, bias, epi, ln=ln, out=out_wide[:, 3:],
                              resid=resid if epi >= kp.EPI_BIAS_RESID
                              else None)
                assert got.data_ptr() == out_wide[:, 3:].data_ptr()
                assert not out_wide[:, :3].any()
                _close(got, want, dtype)


def test_gemm_refuses_unaligned_operands(dev):
    from autognothi_tpu_torch.kernels import primitives as kp

    a = torch.zeros(4, 20, device=dev)
    w = torch.zeros(8, 20, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        kp.gemm(a[:, 1:19], w[:, :18], torch.zeros(8, device=dev),
                kp.EPI_BIAS)


@pytest.mark.parametrize("budget", [None, 9 * 2 ** 20, 5 * 2 ** 20])
def test_bf16_float_chain_at_bert_base(dev, budget, monkeypatch):
    """bf16 without int8 at 768/3072, T = 512: the gate splits the MLP and
    each float tile (K8) is one launch, the W2 column slice read in place;
    against the plain chain.  Lowered budgets give 4 and 8 tiles."""
    from autognothi_tpu_torch.ops import gates
    from autognothi_tpu_torch.ops import mlp_block as mb

    if budget is not None:
        monkeypatch.setattr(gates, "VMEM_BUDGET_BYTES", budget)
    g = torch.Generator().manual_seed(18)
    b, t, h, inter = 2, 512, 768, 3072
    dtype = torch.bfloat16
    resid = _rand(g, dev, b, t, h).to(dtype)
    w1, b1 = _rand(g, dev, inter, h, scale=h ** -0.5), _rand(g, dev, inter)
    w2, b2 = _rand(g, dev, h, inter, scale=inter ** -0.5), _rand(g, dev, h)
    ln = (1 + _rand(g, dev, h, scale=0.1), _rand(g, dev, h, scale=0.1), 1e-12)
    n_tiles = gates.mlp_block_tiles(t, h, inter, dtype)
    assert n_tiles == {None: 2, 9 * 2 ** 20: 4, 5 * 2 ** 20: 8}[budget]
    for position in ("prologue", "epilogue"):
        before = mb.COUNTER_TILED.count
        got = mb.mlp_block(resid, w1, b1, w2, b2, ln=ln,
                           ln_position=position)
        assert mb.COUNTER_TILED.count == before + n_tiles
        tensors, static = mb.mlp_block_args(resid, w1, b1, w2, b2, ln=ln,
                                            ln_position=position)
        _close(got, mb.mlp_block_tiled_plain(*tensors, n_tiles=n_tiles,
                                             **static), dtype)


# ------------------------------------- the TMA + wgmma int8 GEMM (K1-K4)


def _int32_sum(a, w):
    """The exact int32 product: `torch._int_mm` where its shape rules allow
    (more than 16 rows), else float64, which holds every partial sum here
    (|acc| <= 127^2 K < 2^53)."""
    if a.shape[0] > 16:
        return torch._int_mm(a, w.T)
    return (a.double() @ w.double().T).to(torch.int32)


@pytest.mark.parametrize("k", [96, 384, 768, 3072])
@pytest.mark.parametrize("n", [96, 384, 768, 2304, 3072])
@pytest.mark.parametrize("m", [1, 63, 64, 197, 4097, 12608])
def test_gemm_i8_wgmma_grid(dev, m, n, k):
    """Every (M, N, K) of the main paths' int8 products and their edges
    (a partial row tile, one row, both tile widths), every epilogue, fp32
    and bf16.  The bias and residual epilogues are bit-identical to the
    same epilogue steps in torch on `torch._int_mm`'s int32 sum (each
    multiply and add rounded on its own, as the kernel's _rn intrinsics);
    the GELU epilogues (the fp32 one, and the fold of K3's d3) within
    `_close_int8` (erf's last bits)."""
    from autognothi_tpu_torch.kernels import primitives as kp

    g = torch.Generator().manual_seed(19)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    a[0], w[0] = 127, 127  # |acc| past 2^24 at K = 3072
    a, w = a.to(dev), w.to(dev)
    sa, sw = _rand(g, dev, m).abs() * 1e-2, _rand(g, dev, n).abs() * 1e-3
    bias = _rand(g, dev, n)
    v = (_int32_sum(a, w).float() * sa[:, None]) * sw + bias
    for dtype in (torch.float32, torch.bfloat16):
        resid = _rand(g, dev, m, n).to(dtype)
        got = kp.gemm_i8(a, sa, w, sw, bias, kp.I8_EPI_BIAS, dtype)
        assert torch.equal(got, v.to(dtype)), (m, n, k, dtype)
        got = kp.gemm_i8(a, sa, w, sw, bias, kp.I8_EPI_BIAS_RESID, dtype,
                         resid=resid)
        want = (resid.float() + v.to(dtype).float()).to(dtype)
        assert torch.equal(got, want), (m, n, k, dtype)
        gelu = torch.nn.functional.gelu(v)
        got = kp.gemm_i8(a, sa, w, sw, bias, kp.I8_EPI_GELU_F32, dtype)
        assert got.dtype == torch.float32
        _close_int8(got, gelu, torch.float32)
        _check_fold(kp, a, sa, w, sw, bias, dtype, gelu, 10)


def _launched(fn):
    """Kernel names of the device launches of one call of `fn`.  The
    profiler warms up on a fill first (it now and then loses the first
    events of a window it starts with) and keeps the second window, the
    call's; the step's own annotation ("ProfilerStep#") is no launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for step in (lambda: torch.zeros(1, device="cuda"), fn):
            step()
            torch.cuda.synchronize()
            prof.step()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")]


def _launched_per_call(fn, reps=3, tries=5):
    """Kernel names of the device launches of one call of `fn`, from a
    window of `reps` calls bracketed by two fills (dropped): the profiler
    now and then loses the first or last event of a window, so a window in
    which a kernel is seen a number of times that is not a whole multiple
    of the calls is profiled again, and `tries` such windows fail."""
    def window():
        torch.zeros(1, device="cuda")
        for _ in range(reps):
            fn()
        torch.zeros(1, device="cuda")

    names = []
    for _ in range(tries):
        names = _launched(window)
        for end in (0, -1):
            if names and "FillFunctor" in names[end]:
                names.pop(end)
        counts = {n: names.count(n) for n in names}
        if counts and all(c % reps == 0 for c in counts.values()):
            return names[:len(names) // reps]
    raise AssertionError(f"the profiler lost events in {tries} windows: "
                         f"{names}")


def _weight_quantizers(names):
    # quant_rows_kernel<T, LN = false, WEIGHT = true>, demangled or not
    return sum("quant_rows_kernel" in s and ("false, true>" in s
                                             or "Lb0ELb1E" in s)
               for s in names)


def test_int8_blocks_quantize_weights_once_per_version(dev):
    """After its first call a K1 call launches no weight quantizer and no
    concatenation, and neither does K4's trunk MLP (K2's) nor a K8q chain
    (whose weight slices are new views at each call); an in-place
    update of a weight (an optimizer step, `copy_`) makes the next call
    quantize that weight again, and the result follows the new weight."""
    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import mlp_block as mb

    g = torch.Generator().manual_seed(20)
    b, t, h, inter = 2, 37, 64, 256
    resid = _rand(g, dev, b, t, h)
    ws = tuple(_rand(g, dev, *s, scale=0.1) for s in [(h, h), (h,)] * 4)
    ln = (1 + _rand(g, dev, h, scale=0.1), _rand(g, dev, h, scale=0.1), 1e-12)
    mask = _mask(g, dev, b, t, True)
    w1, b1 = _rand(g, dev, inter, h, scale=0.1), _rand(g, dev, inter)
    w2, b2 = _rand(g, dev, h, inter, scale=0.05), _rand(g, dev, h)

    def k1():
        return ab.attention_block(resid, mask, ws, 4, "mul", ln=ln,
                                  ln_position="prologue", quant="int8")

    def k4():
        return mb.mlp_block(resid, w1, b1, w2, b2, ln=ln,
                            ln_position="prologue", quant="int8")

    def k8q():  # two tiles: slices of w1 and w2, new views at each call
        return mb.mlp_block_int8_tiled(resid, w1, b1, w2, b2, ln=ln,
                                       ln_position="prologue", n_tiles=2)

    def plain_k1():
        return ab.attention_block_int8_plain(
            resid, mask, *ws, ln[0], ln[1], n_heads=4, mode="mul",
            ln_position="prologue", ln_eps=1e-12)

    # K4's trunk design and a K8q chain quantize x once; their
    # intermediates take no row pass
    for op, activations in ((k1, 2), (k4, 1), (k8q, 1)):
        op()  # warmup: the codes are made here
        names = _launched(op)
        assert _weight_quantizers(names) == 0, names
        assert not any("cat" in s.lower() for s in names), names
        assert sum("quant_rows_kernel" in s for s in names) == activations
    with torch.no_grad():
        ws[0].add_(0.05)       # wq: an optimizer-style step
        ws[6].copy_(ws[6] * -1)  # wo: a checkpoint loaded in place
        w2.mul_(2)
    names = _launched(k1)
    assert _weight_quantizers(names) == 2, names  # Q|K|V once, wo once
    assert _weight_quantizers(_launched(k1)) == 0
    _close_int8(k1(), plain_k1(), torch.float32)
    assert _weight_quantizers(_launched(k4)) == 1
    _close_int8(k4(), mb.mlp_block_int8_plain(
        resid, w1, b1, w2, b2, ln[0], ln[1], ln_position="prologue",
        ln_eps=1e-12), torch.float32)


# ------------------- the float GEMM on TMA + wgmma; the ladder's stages (K6, K5)


def _wg_operands(a, w, mode):
    """gemm_wg's operands of fp32 a <M, K>, w <N, K>: mode "bf16", or
    "fp32" (A split in the kernel's registers, w's tf32 planes)."""
    from autognothi_tpu_torch.ops.weight_codes import tf32_planes

    if mode == "bf16":
        return dict(a=a.bfloat16(), w=w.bfloat16())
    w_hi, w_lo = tf32_planes(w)
    return dict(a=a, w=w_hi, w_lo=w_lo)


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("k", [96, 768, 3072])
@pytest.mark.parametrize("n", [96, 288, 768, 2304])
def test_gemm_wg_grid(dev, n, k, mode):
    """The TMA + wgmma float GEMM over odd M x N x K, with the bias and the
    bias + residual epilogues, against the float64 product of the same
    operands: fp32 (3xTF32) within 1e-5 x max(1, |ref|), bf16 within one
    bf16 rounding (1e-2 x max(1, |ref|))."""
    from autognothi_tpu_torch.kernels import primitives as kp

    g = torch.Generator().manual_seed(30 + n + k)
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    tol = 1e-2 if mode == "bf16" else 1e-5
    for m in (1, 197, 4097):
        a = _rand(g, dev, m, k)
        w = _rand(g, dev, n, k, scale=k ** -0.5)
        bias = _rand(g, dev, n)
        resid = _rand(g, dev, m, n).to(dtype)
        ops = _wg_operands(a, w, mode)
        ref = ops["a"].double() @ w.to(dtype).double().T + bias.double()
        got = kp.gemm_wg(ops["a"], ops["w"], bias, kp.EPI_WG_BIAS,
                         w_lo=ops.get("w_lo"))
        scale = max(1.0, ref.abs().max().item())
        err = (got.double() - ref).abs().max().item()
        assert err <= tol * scale, (m, err, scale)
        got = kp.gemm_wg(ops["a"], ops["w"], bias, kp.EPI_WG_BIAS_RESID,
                         w_lo=ops.get("w_lo"), resids=(resid,))
        want = resid.double() + ref.to(dtype).double()
        err = (got.double() - want).abs().max().item()
        assert err <= tol * max(1.0, want.abs().max().item()), (m, err)


@pytest.mark.parametrize("s,n_branches", [(96, 1), (96, 2), (32, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_wg_side_in_epilogue(dev, dtype, s, n_branches):
    """The split epilogue of the ladder's side-in product: every branch's
    map at once, bias, GELU, cast, its side added, into <nb, M, S>."""
    from autognothi_tpu_torch.ops import ladder_block as lb

    g = torch.Generator().manual_seed(40 + s + n_branches)
    m, h = 4097, 768
    h2 = _rand(g, dev, m, h).to(dtype)
    sides = [_rand(g, dev, m, s).to(dtype) for _ in range(n_branches)]
    map_w = _rand(g, dev, n_branches * s, h, scale=h ** -0.5).to(dtype)
    map_b = _rand(g, dev, n_branches * s)
    _close(lb.side_in_launch(h2, sides, map_w, map_b),
           lb.side_in_plain(h2, sides, map_w, map_b), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_prep_ln_and_the_planes_on_the_card(dev, dtype):
    """The LN row pass rounded to the activation dtype as the plain
    LayerNorm; the weights' tf32 planes, made on the card by the torch plane
    function, bit for bit the CPU's (which tests/test_torch_port_planes.py
    holds against a numpy rounding, ties included)."""
    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.models.common import layer_norm
    from autognothi_tpu_torch.ops.weight_codes import tf32_planes

    g = torch.Generator().manual_seed(50)
    x = _rand(g, dev, 301, 768).to(dtype)
    w, b = 1 + _rand(g, dev, 768, scale=0.1), _rand(g, dev, 768, scale=0.1)
    _close(kp.rows_prep(x, (w, b, 1e-12)), layer_norm(x, w, b, 1e-12), dtype)
    if dtype == torch.float32:
        # ties: values whose 13 low bits are exactly 0x1000
        x[0, :64] = (torch.arange(64, device=dev, dtype=torch.int32)
                     * 0x2000 + 0x3F801000).view(torch.float32)
        for got, want in zip(tf32_planes(x), tf32_planes(x.cpu())):
            assert torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32))


def _ladder_case(g, dev, dtype, n_branches, t, s=96, h=768, b=2,
                 inter=None):
    from autognothi_tpu_torch.ops import ladder_block as lb

    inter = inter or 4 * s
    hid = _rand(g, dev, b, t, h).to(dtype)
    sides = [_rand(g, dev, b, t, s).to(dtype) for _ in range(n_branches)]
    shapes = {"map_w": (s, h), "w1": (inter, s), "b1": (inter,),
              "w2": (s, inter)}
    branches = [{k: _rand(g, dev, *shapes.get(k, (s, s) if k.startswith("w")
                                              else (s,)),
                          scale=0.1 if not k.startswith("ln") else 0.3)
                 for k in lb.BRANCH_KEYS} for _ in range(n_branches)]
    for w in branches:  # the model's weights are in its activation dtype
        w["ln1_w"] += 1
        w["ln2_w"] += 1
        w.update({k: v.to(dtype) for k, v in w.items()})
    return hid, sides, branches


def _check_ladder_stages(dev, dtype, n_branches, kind, t, seed, s=96,
                         inter=None):
    """Each of K5's launches against its stage's plain version on the same
    inputs (the plain chain's own intermediates), then the whole op against
    `ladder_block_plain`.  Side s in s / 8 heads of d = 8; "add" takes its
    bias in the activation dtype, as the BERT model makes it."""
    from autognothi_tpu_torch.ops import ladder_block as lb

    g = torch.Generator().manual_seed(seed)
    heads = s // 8
    mode, pre_norm = ("mul", True) if kind == "mul pre" else ("add", False)
    hid, sides, branches = _ladder_case(g, dev, dtype, n_branches, t, s=s,
                                        inter=inter)
    mask = _mask(g, dev, 2, t, True)
    if mode == "add":
        mask = (1 - mask.to(dtype)) * torch.finfo(dtype).min
    tensors, static = lb.ladder_block_args(hid, sides, mask, branches, heads,
                                           mode, pre_norm, 1e-12)
    pk = lb.ladder_pack(tensors[2:], n_branches, dtype)
    m = 2 * t
    h2 = hid.reshape(m, -1)
    sides2 = [x.reshape(m, -1) for x in sides]
    x = lb.side_in_plain(h2, sides2, pk["map_w"], pk["map_b"])
    _close(lb.side_in_launch(h2, sides2, pk["map_w"], pk["map_b"]), x, dtype)
    qkv_args = (pk["wqkv"], pk["bqkv"], pk["ln1_w"], pk["ln1_b"], 1e-12,
                pre_norm)
    qkv = lb.side_qkv_plain(x, *qkv_args)
    _close(lb.side_qkv_launch(x, *qkv_args), qkv, dtype)
    att_args = (mask, pk["wo"], pk["bo"], pk["ln1_w"], pk["ln1_b"], 1e-12,
                heads, mode, pre_norm)
    x1 = lb.side_attention_plain(x, qkv, *att_args)
    _close(lb.side_attention_launch(x, qkv, *att_args), x1, dtype)
    mlp_args = (pk["w1"], pk["b1"], pk["w2"], pk["b2"], pk["ln2_w"],
                pk["ln2_b"], 1e-12, pre_norm)
    _close(lb.side_mlp_launch(x1, *mlp_args),
           lb.side_mlp_plain(x1, *mlp_args), dtype)
    before = lb.COUNTER.count
    got = lb.ladder_block(hid, sides, mask, branches, heads, mode, pre_norm,
                          1e-12)
    assert lb.COUNTER.count == before + 1
    for y, want in zip(got, lb.ladder_block_plain(*tensors, **static)):
        _close(y, want, dtype)


@pytest.mark.parametrize("t", [1, 63, 64, 65, 197, 512])
@pytest.mark.parametrize("kind", ["mul pre", "add post"])
@pytest.mark.parametrize("n_branches", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ladder_stage_launches(dev, dtype, n_branches, kind, t):
    """K5 at the ViT-B / BERT-base side (96 wide, MLP 384): each launch
    against its stage's plain version, then the whole op."""
    _check_ladder_stages(dev, dtype, n_branches, kind, t, 60 + t + n_branches)


@pytest.mark.parametrize("s,inter", [(8, 16), (24, 40), (32, 64), (48, 192),
                                     (64, 136), (120, 96), (128, 512)])
@pytest.mark.parametrize("kind", ["mul pre", "add post"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ladder_stage_launches_at_other_widths(dev, dtype, kind, s, inter):
    """K5 at every width class (side widths that are multiples of 8 up to
    128: odd multiples of 8, ViT-S 48, ViT-L 128) and MLP widths other than
    4S (the BERT test config's 32 / 64), T = 65 over 2 branches."""
    _check_ladder_stages(dev, dtype, 2, kind, 65, 90 + s + inter, s=s,
                         inter=inter)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ladder_with_more_branches_than_one_side_in_takes(dev, dtype):
    """Six branches: two side-in launches (four branches, then two)."""
    _check_ladder_stages(dev, dtype, 6, "mul pre", 17, 95, s=32)


def test_ladder_refuses_widths_it_has_no_kernel_for(dev):
    """Heads wider than the attention core's widest (d = 256 > 128), heads
    that split no side evenly, and side widths that are no multiple of 8
    raise on the card, naming the shape (d = 4 and d = 128 run since F7's
    repair: `test_ladder_padded_and_wide_heads`)."""
    from autognothi_tpu_torch.ops import ladder_block as lb

    g = torch.Generator().manual_seed(96)
    for s, heads in ((512, 2), (96, 5), (36, 4)):
        hid, sides, branches = _ladder_case(g, dev, torch.float32, 1, 9, s=s)
        with pytest.raises(ValueError, match=f"side {s} in {heads} heads"):
            lb.ladder_block(hid, sides, _mask(g, dev, 2, 9, True), branches,
                            heads, "mul", True, 1e-12)


@pytest.mark.parametrize("s,heads", [(192, 12), (256, 16), (384, 12)])
@pytest.mark.parametrize("kind", ["mul pre", "add post"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ladder_per_branch_route(dev, dtype, kind, s, heads):
    """F7: sides the stage kernels do not take (d = 16 and 32; a side of
    hidden / 4) run the per-branch route (the side-in launch, then each
    branch's side layer on K6's and K7's kernels), held against
    `ladder_block_plain` over 2 branches at T = 197; d = 8 at 96 still
    takes the four stage launches."""
    from autognothi_tpu_torch.ops import ladder_block as lb

    g = torch.Generator().manual_seed(200 + s + heads)
    mode, pre_norm = ("mul", True) if kind == "mul pre" else ("add", False)
    t = 197
    assert lb.ladder_route(s, 4 * s, heads, t) == "per_branch"
    assert lb.ladder_route(96, 384, 12, t) == "stages"
    hid, sides, branches = _ladder_case(g, dev, dtype, 2, t, s=s)
    mask = _mask(g, dev, 2, t, True)
    if mode == "add":
        mask = (1 - mask.to(dtype)) * torch.finfo(dtype).min
    before = (lb.COUNTER.count, lb.COUNTER_PER_BRANCH.count)
    got = lb.ladder_block(hid, sides, mask, branches, heads, mode, pre_norm,
                          1e-12)
    assert (lb.COUNTER.count, lb.COUNTER_PER_BRANCH.count) == \
        (before[0] + 1, before[1] + 1)
    tensors, static = lb.ladder_block_args(hid, sides, mask, branches, heads,
                                           mode, pre_norm, 1e-12)
    for y, want in zip(got, lb.ladder_block_plain(*tensors, **static)):
        _close(y, want, dtype)
    names = _launched_per_call(lambda: lb.ladder_block(
        hid, sides, mask, branches, heads, mode, pre_norm, 1e-12))
    assert not any("ladder" in n for n in names), names
    assert sum("attention_tc_kernel" in n for n in names) == 2, names


def _copies(names):
    return [s for s in names
            if any(w in s.lower() for w in ("copy", "cat", "fill"))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ladder_and_attention_block_launch_counts(dev, dtype):
    """After warmup one ladder step launches four kernels for every branch
    together (1 and 2 branches, the ViT's "mul" mask and BERT's additive
    bias in the activation dtype), and K6 launches no concatenation, copy
    or fill under either mask: the packed weights, planes and fp32 vectors
    are made once per weight version, the mask is read as it comes; an
    in-place update makes the packs again."""
    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import ladder_block as lb

    g = torch.Generator().manual_seed(70)
    keep = _mask(g, dev, 2, 197, True)
    # the ViT's 0/1 mask, and BERT's additive bias in the activation dtype
    # (as `additive_mask_bias` makes it): neither is copied
    masks = {"mul": keep, "add": (1 - keep.to(dtype)) * torch.finfo(dtype).min}
    for n_branches, mode in ((1, "mul"), (2, "mul"), (2, "add")):
        hid, sides, branches = _ladder_case(g, dev, dtype, n_branches, 197)

        def step():
            return lb.ladder_block(hid, sides, masks[mode], branches, 12,
                                   mode, mode == "mul", 1e-12)

        step()
        names = _launched_per_call(step)
        assert len(names) == 4 and not _copies(names), names
        assert sum("ladder_" in s for s in names) == 3, names
        assert sum("gemm_wg_kernel" in s for s in names) == 1, names
    h = 768
    resid = _rand(g, dev, 2, 197, h).to(dtype)
    ws = tuple(_rand(g, dev, *s, scale=0.05) for s in [(h, h), (h,)] * 4)
    ws = tuple(w.to(dtype) for w in ws)
    ln = (1 + _rand(g, dev, h, scale=0.1).to(dtype),
          _rand(g, dev, h, scale=0.1).to(dtype), 1e-12)
    for position, mode in (("prologue", "mul"), ("epilogue", "add")):
        def k6():
            return ab.attention_block(resid, masks[mode], ws, 12, mode,
                                      ln=ln, ln_position=position)

        k6()
        names = _launched_per_call(k6)
        assert not _copies(names), names
        assert sum("gemm_wg_kernel" in s for s in names) == 2, names
    with torch.no_grad():
        ws[0].add_(0.01)
    _close(k6(), ab.attention_block_plain(
        resid, masks["add"], *ws, ln[0], ln[1], n_heads=12, mode="add",
        ln_position="epilogue", ln_eps=1e-12), dtype)


def test_attention_block_at_vit_width(dev):
    """K6 in fp32 at the ViT trunk's width (768, 12 heads, T = 197),
    pre-norm (the LN pass writes A), post-norm and without LN, against the
    plain block."""
    from autognothi_tpu_torch.ops import attention_block as ab

    g = torch.Generator().manual_seed(80)
    h = 768
    resid = _rand(g, dev, 3, 197, h)
    ws = tuple(_rand(g, dev, *s, scale=h ** -0.5) for s in [(h, h), (h,)] * 4)
    ln = (1 + _rand(g, dev, h, scale=0.1), _rand(g, dev, h, scale=0.1), 1e-12)
    mask = _mask(g, dev, 3, 197, True)
    for position in ("prologue", "epilogue", "none"):
        got = ab.attention_block(resid, mask, ws, 12, "mul", ln=ln,
                                 ln_position=position)
        want = ab.attention_block_plain(
            resid, mask, *ws, ln[0], ln[1], n_heads=12, mode="mul",
            ln_position=position, ln_eps=1e-12)
        _close(got, want, torch.float32)


# --------------------- the split MLP tiles: K8q's quantizers, K8 on wgmma


def _i8_operands(g, dev, m, n, k):
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    sa = (torch.rand(m, generator=g) * 1e-2 + 1e-4).to(dev)
    sw = (torch.rand(n, generator=g) * 1e-3 + 1e-5).to(dev)
    return a.to(dev), w.to(dev), sa, sw, _rand(g, dev, n)


@pytest.mark.parametrize("n", [96, 768, 1536])
@pytest.mark.parametrize("m", [1, 63, 197, 4097])
def test_gemm_i8_amax_epilogue_and_the_codes_of_its_output(dev, m, n):
    """I8_EPI_GELU_F32_AMAX writes what I8_EPI_GELU_F32 writes and raises
    each row's amax to the max |GELU| of that row (the blocks' atomics
    land in any order; the max is exact), so the codes and scales made
    from it with the quantizer's arithmetic are bit-identical to
    `quant_rows` on the same fp32 intermediate (the product that makes
    them in its registers is held to the product on `quant_rows`' codes in
    `test_gemm_i8_quantizes_its_fp32_a_on_load`).  The x quantizer zeroes
    the amax buffers in the same launch."""
    from autognothi_tpu_torch.kernels import primitives as kp

    g = torch.Generator().manual_seed(90)
    a, w, sa, sw, bias = _i8_operands(g, dev, m, n, 768)
    amax = torch.full((2, m), float("nan"), device=dev)
    xq, xs = kp.quant_rows(_rand(g, dev, m, 768), zero=amax)
    assert torch.equal(amax, torch.zeros_like(amax))
    for dtype in (torch.float32, torch.bfloat16):
        amax.zero_()
        got = kp.gemm_i8(a, sa, w, sw, bias, kp.I8_EPI_GELU_F32_AMAX, dtype,
                         amax=amax[1])
        want = kp.gemm_i8(a, sa, w, sw, bias, kp.I8_EPI_GELU_F32, dtype)
        assert got.dtype == torch.float32 and torch.equal(got, want)
        assert torch.equal(amax[1], got.abs().amax(dim=1))
        assert torch.equal(amax[0], torch.zeros_like(amax[0]))
        # the recipe on the epilogue's amax: a true division, half to even
        amax_e = amax[1] + 1e-12
        q = torch.round(got * (amax_e.new_tensor(127.0) / amax_e)[:, None])
        q_ref, s_ref = kp.quant_rows(got)
        assert torch.equal(q.to(torch.int8), q_ref)
        assert torch.equal(amax_e * (1.0 / 127.0), s_ref)
    with pytest.raises(ValueError, match="amax"):
        kp.gemm_i8(a, sa, w, sw, bias, kp.I8_EPI_GELU_F32, torch.float32,
                   amax=amax[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k", [(96, 96), (768, 1536), (768, 384),
                                 (200, 3072), (192, 768), (384, 96)])
@pytest.mark.parametrize("m", [1, 63, 197, 4097])
def test_gemm_i8_quantizes_its_fp32_a_on_load(dev, m, n, k, dtype):
    """The W2 product of a K8q tile, A quantized in the consumers'
    registers from its row maxima: bit-identical to the same GEMM on
    `quant_rows`' codes and scales of A (the same codes, the same int32
    sums, the same epilogue), also for A read through a row stride wider
    than K (a column slice); 192-wide tiles at N = 768, 96-wide at the
    others."""
    from autognothi_tpu_torch.kernels import primitives as kp

    g = torch.Generator().manual_seed(91)
    _, w, _, sw, bias = _i8_operands(g, dev, m, n, k)
    wide = _rand(g, dev, m, k + 32, scale=0.3)
    wide[0, :k] = 0  # an all-zero row: scale 1e-12 / 127, codes 0
    resid = _rand(g, dev, m, n).to(dtype)
    for a in (wide[:, :k].contiguous(), wide[:, 16:16 + k]):
        amax = a.abs().amax(dim=1)
        got = kp.gemm_i8_qa(a, amax, w, sw, bias, dtype, resid=resid)
        want = kp.gemm_i8(*kp.quant_rows(a), w, sw, bias,
                          kp.I8_EPI_BIAS_RESID, dtype, resid=resid)
        assert torch.equal(got, want), (m, n, k, dtype)


@pytest.mark.parametrize("bn", [0, 96, 128, 192, 256])
@pytest.mark.parametrize("n,k", [(1536, 768), (768, 1536), (96, 768),
                                 (200, 96)])
@pytest.mark.parametrize("m", [1, 63, 4096])
def test_gemm_wg_bias_gelu_epilogue(dev, m, n, k, bn):
    """EPI_WG_BIAS_GELU in bf16 (a K8 tile's W1 product) against the
    float64 product with `_kernel_sepx`'s rounding point: bias and exact
    GELU on the fp32 sum, then bf16; every tile width, within 1e-2 x
    max(1, |ref|) (the bf16 rounding of the output and of the operands
    that the reference shares)."""
    from autognothi_tpu_torch.kernels import primitives as kp

    g = torch.Generator().manual_seed(93)
    a = _rand(g, dev, m, k).bfloat16()
    w = _rand(g, dev, n, k, scale=k ** -0.5).bfloat16()
    bias = _rand(g, dev, n)
    got = kp.gemm_wg(a, w, bias, kp.EPI_WG_BIAS_GELU, bn=bn)
    v = a.double() @ w.double().T + bias.double()
    ref = (0.5 * v * (1 + torch.erf(v / 2 ** 0.5))).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    err = (got.double() - ref.double()).abs().max().item()
    assert err <= 1e-2 * max(1.0, ref.double().abs().max().item()), err


@pytest.mark.parametrize("bn", [96, 128, 192, 256])
def test_gemm_wg_reads_a_column_slice_of_w_in_place(dev, bn):
    """A K8 tile's W2 product: the column slice W2[:, 1536:3072] of a
    <768, 3072> bf16 weight read by TMA through its row stride, with the
    bias + residual epilogue, equal to the product on the slice's
    contiguous copy."""
    from autognothi_tpu_torch.kernels import primitives as kp

    g = torch.Generator().manual_seed(94)
    w2 = _rand(g, dev, 768, 3072, scale=3072 ** -0.5).bfloat16()
    inter = _rand(g, dev, 4096, 1536).bfloat16()
    bias, resid = _rand(g, dev, 768), _rand(g, dev, 4096, 768).bfloat16()
    sl = w2[:, 1536:]
    assert not sl.is_contiguous()
    got = kp.gemm_wg(inter, sl, bias, kp.EPI_WG_BIAS_RESID, resids=(resid,),
                     bn=bn)
    want = kp.gemm_wg(inter, sl.contiguous(), bias, kp.EPI_WG_BIAS_RESID,
                      resids=(resid,), bn=bn)
    assert torch.equal(got, want)
    ref = resid.double() + (inter.double() @ sl.double().T
                            + bias.double()).bfloat16().double()
    err = (got.double() - ref).abs().max().item()
    assert err <= 1e-2 * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_chain_launches(dev, dtype):
    """After warmup a 2-tile K8q chain runs one x quantizer (which zeroes
    the row-max buffers: no fill), no row reduction over an intermediate,
    no weight quantizer, no copy or fill, and two int8 GEMMs per tile; a
    bf16 K8 tile runs two wgmma GEMM kernels and no `gemm.cu` kernel."""
    from autognothi_tpu_torch.ops import mlp_block as mb

    g = torch.Generator().manual_seed(96)
    resid, ws, ln = _bert_mlp(g, dev, dtype, b=1)
    position = "epilogue" if dtype == torch.float32 else "none"

    def k8q():
        return mb.mlp_block(resid, *ws, ln=ln, ln_position=position,
                            quant="int8")

    k8q()
    names = _launched_per_call(k8q)
    assert sum("quant_rows_kernel" in s for s in names) == 1, names
    assert _weight_quantizers(names) == 0, names
    assert not _copies(names), names
    assert sum("gemm_i8_wgmma_kernel" in s for s in names) == 4, names
    if dtype == torch.bfloat16:
        def k8():
            return mb.mlp_block(resid, *ws, ln=ln, ln_position="none")

        k8()
        names = _launched_per_call(k8)
        assert sum("gemm_wg_kernel" in s for s in names) == 4, names
        assert not any("gemm_tc_kernel" in s for s in names), names
        assert not _copies(names), names


# ------------------ K4's two designs and K3 without its fp32 intermediate


def config_mlp_widths():
    """Every (H, I) at which a configuration of the repo
    (`experiments/*/.hparams.json`) runs an MLP block: the trunk's hidden
    and intermediate sizes, and an LTT side's (`s_attn_hidden_size` and
    `s_attn_intermediate_size` where given, else an eighth of the trunk's,
    the ratio of the repo's LTT configurations, 96 / 768)."""
    import json
    import pathlib

    widths = set()
    root = pathlib.Path(__file__).resolve().parents[1] / "experiments"
    for path in sorted(root.glob("*/.hparams.json")):
        net = json.loads(path.read_text())["net"]["params"]
        h, inter = net["hidden_size"], net["intermediate_size"]
        widths.add((h, inter))
        widths.add((net.get("s_attn_hidden_size", h // 8),
                    net.get("s_attn_intermediate_size", inter // 8)))
    return sorted(widths)


def config_head_shapes():
    """Every explainer head (T, h_in, inter, classes) of a configuration of
    the repo (`experiments/*/.hparams.json`): the vanilla and froyo heads on
    the trunk's hidden state, the LTT heads on the side's, at the
    configuration's token count (the ViT's patches + CLS, BERT's
    `max_position_embeddings`)."""
    import json
    import pathlib

    shapes = set()
    root = pathlib.Path(__file__).resolve().parents[1] / "experiments"
    for path in sorted(root.glob("*/.hparams.json")):
        net = json.loads(path.read_text())["net"]["params"]
        t = net.get("max_position_embeddings") or \
            (net["img_px_size"] // net["img_patch_size"]) ** 2 + 1
        if "explainer_head_hidden_size" in net:
            shapes.add((t, net["hidden_size"],
                        net["explainer_head_hidden_size"], net["num_labels"]))
        if "explainer_s_head_hidden_size" in net:
            shapes.add((t, net["s_attn_hidden_size"],
                        net["explainer_s_head_hidden_size"],
                        net["num_labels"]))
    return sorted(shapes)


def _k4_weights(g, dev, h, inter):
    return (_rand(g, dev, inter, h, scale=h ** -0.5), _rand(g, dev, inter),
            _rand(g, dev, h, inter, scale=inter ** -0.5), _rand(g, dev, h))


def _h_codes(kp, x, q1, s1, b1, dtype, ln=None):
    """The codes and scales `quant_rows` makes of gelu(the int8 W1 / d1
    product) of x, the intermediate through device memory."""
    inter = kp.gemm_i8(*kp.quant_rows(x, ln=ln), q1, s1, b1,
                       kp.I8_EPI_GELU_F32, dtype)
    return kp.quant_rows(inter)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("position", ["prologue", "epilogue", "none"])
@pytest.mark.parametrize("h,inter", [(96, 384), (128, 512)])
def test_k4_narrow_block(dev, h, inter, position, dtype):
    """The narrow K4 (one launch) at the side widths, 3 x 197 rows (not a
    multiple of the 64-row block): the intermediate's codes and scales it
    makes are `quant_rows`' of the intermediate bit for bit; without the LN
    epilogue its output is bit for bit the int8 GEMM's residual epilogue
    on those codes; against the plain block within the int8 bounds (1e-2,
    at most 1% of values beyond 1e-4 in fp32); one launch, no copy."""
    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.ops import mlp_block as mb
    from autognothi_tpu_torch.ops.weight_codes import vec32, weight_codes

    assert mb.k4_design(h, inter) == "narrow"
    g = torch.Generator().manual_seed(100)
    b, t = 3, 197
    resid = _rand(g, dev, b, t, h).to(dtype)
    w1, b1, w2, b2 = _k4_weights(g, dev, h, inter)
    ln = (1 + _rand(g, dev, h, scale=0.1), _rand(g, dev, h, scale=0.1), 1e-12)
    x = resid.reshape(b * t, h)
    (q1, s1), (q2, s2) = (weight_codes((w,), dtype) for w in (w1, w2))
    hq = torch.empty(b * t, inter, device=dev, dtype=torch.int8)
    hs = torch.empty(b * t, device=dev)
    got = kp.mlp_narrow(x, q1, s1, b1, q2, s2, b2, ln=ln,
                        ln_position=position, codes=(hq, hs))
    want_q, want_s = _h_codes(kp, x, q1, s1, b1, dtype,
                              ln=ln if position == "prologue" else None)
    assert torch.equal(hq, want_q) and torch.equal(hs, want_s)
    if position != "epilogue":
        assert torch.equal(got, kp.gemm_i8(hq, hs, q2, s2, b2,
                                           kp.I8_EPI_BIAS_RESID, dtype,
                                           resid=x))

    def op():
        return mb.mlp_block(resid, w1, b1, w2, b2, ln=ln,
                            ln_position=position, quant="int8")

    before = mb.COUNTER_INT8.count
    out = op()
    assert mb.COUNTER_INT8.count == before + 1
    assert torch.equal(out.reshape(b * t, h), got)
    want = mb.mlp_block_int8_plain(resid, w1, b1, w2, b2, ln[0], ln[1],
                                   ln_position=position, ln_eps=1e-12)
    _close_int8(out, want, dtype)
    if dtype == torch.float32:
        assert _int8_flip_share(out, want, dtype) <= 1e-2
    names = _launched_per_call(op)
    assert len(names) == 1 and "mlp_narrow_kernel" in names[0], names
    assert vec32(b1).dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,inter,b,t,position", [
    (768, 3072, 256, 197, "prologue"),   # the int8 teacher's trunk MLP
    (768, 3072, 4, 197, "epilogue"),
    (1024, 4096, 2, 197, "prologue")])
def test_k4_trunk_block(dev, h, inter, b, t, position, dtype):
    """The trunk K4 (x's codes with the row-max buffer zeroed in the same
    launch, W1 with the amax epilogue, W2 quantizing on load): against the
    plain block within the int8 bounds, at the teacher's 50,432 rows too;
    three launches, and BERT's post-norm LN a fourth.  K4's own launch:
    at 1024/4096 the op takes the JAX budget's K8q split (F5), so the
    block is called as K2 calls it."""
    from autognothi_tpu_torch.ops import mlp_block as mb

    assert mb.k4_design(h, inter) == "trunk"
    g = torch.Generator().manual_seed(101)
    resid = _rand(g, dev, b, t, h).to(dtype)
    w1, b1, w2, b2 = _k4_weights(g, dev, h, inter)
    ln = (1 + _rand(g, dev, h, scale=0.1), _rand(g, dev, h, scale=0.1), 1e-12)

    def op():
        return mb.mlp_block_int8_launch(resid, w1, b1, w2, b2, ln[0], ln[1],
                                        ln_position=position, ln_eps=1e-12)

    got = op()
    want = mb.mlp_block_int8_plain(resid, w1, b1, w2, b2, ln[0], ln[1],
                                   ln_position=position, ln_eps=1e-12)
    _close_int8(got, want, dtype)
    if dtype == torch.float32:
        assert _int8_flip_share(got, want, dtype) <= 1e-2
    del want
    names = _launched_per_call(op)
    assert len(names) == (4 if position == "epilogue" else 3), names
    assert sum("quant_rows_kernel" in s for s in names) == 1, names
    assert sum("gemm_i8_wgmma_kernel" in s for s in names) == 2, names
    assert not _copies(names), names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,has_ln", [(10, True), (2, False)])
def test_k3_head_at_full_width(dev, c, has_ln, dtype):
    """K3 at 96-3072-3072-C on 2 x 197 rows (ViT's head with LN, C = 10;
    BERT's without, C = 2): d1 writes h's codes and scales, bit for bit
    `quant_rows`' of the fp32 h; the head within the int8 bounds of its
    plain version; at most three launches, none of them `csrc/gemm.cu`'s
    and no copy."""
    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.ops import head_block as hb
    from autognothi_tpu_torch.ops.weight_codes import weight_codes

    g = torch.Generator().manual_seed(103)
    b, t, h_in, inter = 2, 197, 96, 3072
    x = _rand(g, dev, b, t, h_in).to(dtype)
    ws = (_rand(g, dev, inter, h_in, scale=h_in ** -0.5), _rand(g, dev, inter),
          _rand(g, dev, inter, inter, scale=inter ** -0.5),
          _rand(g, dev, inter), _rand(g, dev, c, inter, scale=inter ** -0.5),
          _rand(g, dev, c))
    ln = ((1 + _rand(g, dev, h_in, scale=0.1), _rand(g, dev, h_in, scale=0.1))
          if has_ln else (None, None))
    x2 = x.reshape(b * t, h_in)
    q1, s1 = weight_codes((ws[0],), ws[0].dtype)
    ln_k = (*ln, 1e-5) if has_ln else None
    hq, hs = kp.head_d1(x2, q1, s1, ws[1], ln=ln_k)
    want_q, want_s = _h_codes(kp, x2, q1, s1, ws[1], dtype, ln=ln_k)
    assert torch.equal(hq, want_q) and torch.equal(hs, want_s)

    def op():
        return hb.explainer_head_block(x, *ws, *ln, 1e-5)

    before = hb.COUNTER.count
    got = op()
    assert hb.COUNTER.count == before + 1 and got.shape == (b, t, c)
    tensors, static = hb.explainer_head_block_args(x, *ws, *ln, 1e-5)
    want = hb.head_int8_plain(*tensors, **static)
    _close_int8(got, want, dtype)
    if dtype == torch.float32:
        assert _int8_flip_share(got, want, dtype) <= 1e-2
    names = _launched_per_call(op)
    assert len(names) <= 3, names
    assert not any("gemm_tc_kernel" in s for s in names), names
    assert not _copies(names), names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("h_in,inter,c", [(768, 3072, 10), (192, 768, 10),
                                          (768, 3072, 2)])
def test_k3_wide_route(dev, h_in, inter, c, has_ln, dtype):
    """K3 at the vanilla heads' inputs (F11: ViT-B and BERT-base 768 ->
    3072, ViT-T 192 -> 768), on 2 x 197 rows, with and without LN, takes
    the wide route: d1 as the row quantizer, the int8 GEMM with the fp32
    GELU epilogue and the row quantizer of h, whose codes and scales are
    `quant_rows`' of the same h bit for bit; the head within the int8
    bounds of its plain version, one counted call, five launches, none of
    them `csrc/gemm.cu`'s and no copy."""
    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.ops import head_block as hb
    from autognothi_tpu_torch.ops.weight_codes import vec32, weight_codes

    assert hb.k3_route(h_in, inter, c) == "wide"
    g = torch.Generator().manual_seed(106)
    b, t = 2, 197
    x = _rand(g, dev, b, t, h_in).to(dtype)
    ws = (_rand(g, dev, inter, h_in, scale=h_in ** -0.5), _rand(g, dev, inter),
          _rand(g, dev, inter, inter, scale=inter ** -0.5),
          _rand(g, dev, inter), _rand(g, dev, c, inter, scale=inter ** -0.5),
          _rand(g, dev, c))
    ln = ((1 + _rand(g, dev, h_in, scale=0.1), _rand(g, dev, h_in, scale=0.1))
          if has_ln else (None, None))
    x2 = x.reshape(b * t, h_in)
    ln_k = (vec32(ln[0]), vec32(ln[1]), 1e-5) if has_ln else None
    hq, hs = hb._d1_wide(x2, ws[0], ws[1], ln_k)
    q1, s1 = weight_codes((ws[0],), ws[0].dtype)
    xq, xs = kp.quant_rows(x2, ln=ln_k)
    h = kp.gemm_i8(xq, xs, q1, s1, vec32(ws[1]), kp.I8_EPI_GELU_F32, dtype)
    want_q, want_s = kp.quant_rows(h)
    assert torch.equal(hq, want_q) and torch.equal(hs, want_s)

    def op():
        return hb.explainer_head_block(x, *ws, *ln, 1e-5)

    before = hb.COUNTER.count
    got = op()
    assert hb.COUNTER.count == before + 1 and got.shape == (b, t, c)
    tensors, static = hb.explainer_head_block_args(x, *ws, *ln, 1e-5)
    want = hb.head_int8_plain(*tensors, **static)
    _close_int8(got, want, dtype)
    if dtype == torch.float32:
        assert _int8_flip_share(got, want, dtype) <= 1e-2
    names = _launched_per_call(op)
    assert len(names) == 5, names
    assert sum("quant_rows_kernel" in s for s in names) == 2, names
    assert not any("gemm_tc_kernel" in s for s in names), names
    assert not _copies(names), names


@pytest.mark.parametrize("shift", [-3.0, -20.0])
def test_k3_d1_codes_where_negative_values_may_hold_the_max(dev, shift):
    """d1's max pass evaluates GELU only where a value can hold the row's
    max; a row whose largest value v has gelu(v) <= 0.171 takes a pass over
    every value.  With d1's bias shifted down (-3: some rows so, some not;
    -20: every row) h's codes and scales stay `quant_rows`' bit for bit."""
    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.ops.weight_codes import weight_codes

    g = torch.Generator().manual_seed(105)
    m, h_in, inter = 197, 96, 3072
    x = _rand(g, dev, m, h_in)
    x[:40] *= 0.05  # rows whose values stay near the bias
    w1 = _rand(g, dev, inter, h_in, scale=h_in ** -0.5)
    b1 = _rand(g, dev, inter, scale=0.5) + shift
    q1, s1 = weight_codes((w1,), torch.float32)
    hq, hs = kp.head_d1(x, q1, s1, b1)
    want_q, want_s = _h_codes(kp, x, q1, s1, b1, torch.float32)
    assert torch.equal(hq, want_q) and torch.equal(hs, want_s)


def test_k3_fold_refuses_more_classes_than_it_takes(dev):
    """The d3 fold takes up to `I8_MAX_FOLD` classes; a head with more
    raises ValueError on the card (no fallback)."""
    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.ops import head_block as hb

    g = torch.Generator().manual_seed(104)
    c = kp.I8_MAX_FOLD + 1
    x = _rand(g, dev, 1, 5, 32)
    ws = (_rand(g, dev, 64, 32), _rand(g, dev, 64), _rand(g, dev, 64, 64),
          _rand(g, dev, 64), _rand(g, dev, c, 64), _rand(g, dev, c))
    with pytest.raises(ValueError, match=f"at most {kp.I8_MAX_FOLD}"):
        hb.explainer_head_block(x, *ws, None, None, 1e-5)


def test_k4_design_rule_matches_the_kernels_built(dev):
    """`k4_design` says "narrow" exactly where the narrow kernel is built,
    over every MLP width of the repo's configurations and their sides."""
    from autognothi_tpu_torch.kernels.build import load
    from autognothi_tpu_torch.ops import mlp_block as mb

    for h, inter in config_mlp_widths():
        assert (mb.k4_design(h, inter) == "narrow") == bool(
            load().ag_mlp_narrow_supports(h, inter)), (h, inter)


# --------------------------------------- F8: T past 512; F7: d = 4, 128


@pytest.mark.parametrize("mode", ["mul", "add"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [577, 1025])
@pytest.mark.parametrize("d", [8, 64])
def test_attention_core_past_512(dev, d, t, dtype, mode):
    """F8: T = 577 (ViT-B/16@384) and 1025: the key loop walks 10 and 17
    chunks of 64 (bf16 twice); K9 on split heads, and the core on packed
    views, against the plain version."""
    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(t + d)
    n, heads = 2, 4
    mask = _mask(g, dev, n, t, True)
    if mode == "add":
        mask = (1 - mask) * torch.finfo(torch.float32).min
    q, k, v = (_rand(g, dev, n, heads, t, d).to(dtype) for _ in range(3))
    before = fa.COUNTER.count
    got = fa.masked_attention(q, k, v, mask, mode=mode)
    assert fa.COUNTER.count == before + 1
    _close(got, fa.masked_attention_plain(q, k, v, mask, mode=mode), dtype)
    q, k, v = _attention_views(g, dev, n, heads, t, d, dtype, True)
    out = torch.full((n, t, heads, d), float("nan"), device=dev,
                     dtype=dtype).transpose(1, 2)
    kp.attention_heads(q, k, v, mask, mode, out)
    _close(out, fa.masked_attention_plain(q, k, v, mask, mode=mode), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [577, 1025])
def test_attention_blocks_past_512(dev, t, dtype):
    """F8: K6 and K1 at ViT-B/16@384's trunk <2, 577, 768> (and T = 1025),
    the ViT's "mul" mask with the LN prologue and BERT's "add" bias with
    the LN epilogue, against their plain versions; where
    `gates.attention_block_fits` admits the int8 block (bf16) it is K1,
    elsewhere the float block runs, as in JAX."""
    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import gates

    g = torch.Generator().manual_seed(t)
    b, h = 2, 768
    resid = _rand(g, dev, b, t, h).to(dtype)
    ws = tuple(_rand(g, dev, *s, scale=h ** -0.5) for s in [(h, h), (h,)] * 4)
    ln = (1 + _rand(g, dev, h, scale=0.1), _rand(g, dev, h, scale=0.1), 1e-12)
    keep = _mask(g, dev, b, t, True)
    for mode, position in (("mul", "prologue"), ("add", "epilogue")):
        mask = keep if mode == "mul" else \
            (1 - keep) * torch.finfo(torch.float32).min
        for quant in ("none", "int8"):
            int8 = quant == "int8" and gates.attention_block_fits(
                t, h, dtype, quant)
            before = (ab.COUNTER.count, ab.COUNTER_INT8.count)
            got = ab.attention_block(resid, mask, ws, 12, mode, ln=ln,
                                     ln_position=position, quant=quant)
            assert (ab.COUNTER.count - before[0],
                    ab.COUNTER_INT8.count - before[1]) == \
                ((0, 1) if int8 else (1, 0))
            plain = ab.attention_block_int8_plain if int8 \
                else ab.attention_block_plain
            want = plain(resid, mask, *ws, ln[0], ln[1], n_heads=12,
                         mode=mode, ln_position=position, ln_eps=1e-12)
            (_close_int8 if int8 else _close)(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,t", [(4, 17), (4, 577), (12, 197), (96, 65),
                                 (128, 197), (128, 577)])
def test_attention_core_padded_and_wide_heads(dev, d, t, dtype):
    """F7: head widths the core is not compiled for (4, 12, 96) run
    zero-padded to the next compiled one (8, 16, 128) with the true
    1/sqrt(d), and d = 128 has its own instance; on packed views (as the
    blocks hand them: d = 4 bf16 is not 16-byte aligned) and on split
    heads, against the plain version."""
    from autognothi_tpu_torch.kernels import primitives as kp
    from autognothi_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(7 * d + t)
    n, heads = 2, 3
    for mode in ("mul", "add"):
        mask = _mask(g, dev, n, t, True)
        if mode == "add":
            mask = (1 - mask) * torch.finfo(torch.float32).min
        for packed in (True, False):
            q, k, v = _attention_views(g, dev, n, heads, t, d, dtype, packed)
            out = torch.full((n, t, heads, d), float("nan"), device=dev,
                             dtype=dtype).transpose(1, 2)
            kp.attention_heads(q, k, v, mask, mode, out)
            _close(out, fa.masked_attention_plain(q, k, v, mask, mode=mode),
                   dtype)


@pytest.mark.parametrize("kind", ["mul pre", "add post"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,heads,t", [(16, 4, 17), (96, 24, 197),
                                       (256, 2, 197), (192, 12, 577)])
def test_ladder_padded_and_wide_heads(dev, s, heads, t, dtype, kind):
    """F7's rest and F8 on K5: the mini configurations' side (16 in 4
    heads of d = 4, T = 17), d = 4 at a side of 96, d = 128 (256 in 2
    heads), and d = 16 at T = 577 take the per-branch route on the card,
    against `ladder_block_plain` over 2 branches; one attention launch per
    branch."""
    from autognothi_tpu_torch.ops import ladder_block as lb

    g = torch.Generator().manual_seed(300 + s + heads + t)
    mode, pre_norm = ("mul", True) if kind == "mul pre" else ("add", False)
    assert lb.ladder_route(s, 4 * s, heads, t) == "per_branch"
    hid, sides, branches = _ladder_case(g, dev, dtype, 2, t, s=s)
    mask = _mask(g, dev, 2, t, True)
    if mode == "add":
        mask = (1 - mask.to(dtype)) * torch.finfo(dtype).min
    before = lb.COUNTER_PER_BRANCH.count
    got = lb.ladder_block(hid, sides, mask, branches, heads, mode, pre_norm,
                          1e-12)
    assert lb.COUNTER_PER_BRANCH.count == before + 1
    tensors, static = lb.ladder_block_args(hid, sides, mask, branches, heads,
                                           mode, pre_norm, 1e-12)
    for y, want in zip(got, lb.ladder_block_plain(*tensors, **static)):
        _close(y, want, dtype)
    names = _launched_per_call(lambda: lb.ladder_block(
        hid, sides, mask, branches, heads, mode, pre_norm, 1e-12))
    assert sum("attention_tc_kernel" in n for n in names) == 2, names


# --------------------------------- LTT BERT training at BERT-base@512


def _plain_dispatch(launch, plain, counter, tensors, static, grad=None):
    """`kernels.primitives.dispatch` as it routes CPU tensors (the plain
    version, with `grad` as its gradient where one is wanted), on the
    card."""
    import functools

    from autognothi_tpu_torch.kernels.primitives import _KernelFn

    if grad is None or not (torch.is_grad_enabled()
                            and any(t.requires_grad for t in tensors)):
        return plain(*tensors, **static)
    return _KernelFn.apply(functools.partial(plain, **static),
                           functools.partial(grad, **static), *tensors)


def _route_plain(monkeypatch):
    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import flash_attention as fa
    from autognothi_tpu_torch.ops import head_block as hb
    from autognothi_tpu_torch.ops import ladder_block as lb
    from autognothi_tpu_torch.ops import mlp_block as mb

    for mod in (ab, fa, hb, lb, mb):
        monkeypatch.setattr(mod, "dispatch", _plain_dispatch)


def _bert_counts():
    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import ladder_block as lb
    from autognothi_tpu_torch.ops import mlp_block as mb

    return {c.name: c.count for c in (ab.COUNTER, mb.COUNTER, lb.COUNTER,
                                      mb.COUNTER_INT8_TILED)}


def _bert_base(dev, sections):
    """A random LTT BERT-base@512 (experiments/bert_base_tayp_ltt widths,
    12 layers, dropout 0) in each section; the trunk's and the side's heads
    biased apart, so that the surrogate stage's KL is not float noise."""
    import json
    import pathlib

    from autognothi_tpu_torch.models.ltt_bert import (LttBertConfig,
                                                      init_ltt_bert)

    hp = json.loads((pathlib.Path(__file__).resolve().parents[1]
                     / "experiments" / "bert_base_tayp_ltt"
                     / ".hparams.json").read_text())
    cfg = LttBertConfig(**dict(hp["net"]["params"],
                               attention_probs_dropout_prob=0.0,
                               hidden_dropout_prob=0.0))
    models = {}
    for i, section in enumerate(sections):
        m = init_ltt_bert(cfg, section, torch.Generator().manual_seed(40 + i))
        with torch.no_grad():
            m.classifier.bias.copy_(torch.tensor([2.0, -2.0]))
            if hasattr(m, "s_attn_classifier"):
                m.s_attn_classifier.bias.copy_(torch.tensor([-2.0, 2.0]))
        models[section] = m.to(dev)
    return cfg, models


def _bert_batch(dev, b=2, t=512, m=2):
    g = torch.Generator().manual_seed(41)
    ids = torch.randint(5, 30000, (b, t), generator=g)
    ids[:, 0] = 2
    labels = torch.randint(0, 2, (b,), generator=g)
    mask = (torch.rand(b, t - 1, generator=g)
            > torch.rand(b, 1, generator=g)).to(torch.int32)
    masks = torch.randint(0, 2, (b, m, t - 1), generator=g,
                          dtype=torch.int32)
    return ids.to(dev), labels.to(dev), mask.to(dev), masks.to(dev)


@pytest.mark.parametrize("stage", ["classifier", "surrogate", "explainer"])
def test_bert_stage_steps_against_plain(dev, stage, monkeypatch):
    """One classifier, surrogate and explainer step at BERT-base@512 (B =
    2, M = 2, 12 layers, fp32 teachers) with the kernels in the
    differentiated forward (K6 and K7 with the LN epilogue, K5 "add"
    post-norm, under autograd) against the same step on the plain
    versions: loss within 1e-4 relative, every trainable gradient within
    1e-4 x max|g|, the updated parameters within 1e-6 where |g| is ten
    times that bound (tests/test_torch_port_stages.py's rule)."""
    import copy

    from autognothi_tpu_torch.parallel.train_step import \
        make_explainer_train_step
    from autognothi_tpu_torch.pipeline.train_classifier import \
        classifier_loss
    from autognothi_tpu_torch.pipeline.train_surrogate import (
        surrogate_loss, surrogate_teacher)
    from autognothi_tpu_torch.pipeline.training import (AdamW,
                                                        make_train_step)
    from autognothi_tpu_torch.recipes.ltt_bert import ltt_bert_recipe

    class Spy(AdamW):
        def update(self, params, grads, lr, update_mask):
            self.grads = {k: v.detach().clone() for k, v in grads.items()
                          if v is not None}
            super().update(params, grads, lr, update_mask)

    monkeypatch.setenv("AUTOGNOTHI_PALLAS", "2")
    monkeypatch.setenv("AUTOGNOTHI_INT8", "0")
    monkeypatch.setenv("AUTOGNOTHI_INT8_TEACHER", "0")
    recipe = ltt_bert_recipe()
    teacher_section = {"classifier": None, "surrogate": "classifier",
                       "explainer": "surrogate"}[stage]
    cfg, models = _bert_base(dev, [stage] + ([teacher_section]
                                             if teacher_section else []))
    ids, labels, mask, masks = _bert_batch(dev)
    ones = torch.ones_like(mask)
    w = torch.ones(2, device=dev)
    trainable = recipe.trainable(cfg, stage)
    out = {}
    for which in ("kernels", "plain"):
        if which == "plain":
            _route_plain(monkeypatch)
        model = copy.deepcopy(models[stage])
        for name, p in model.named_parameters():
            p.requires_grad_(trainable(name))
        opt = Spy(dict(model.named_parameters()), trainable)
        update = {k: 1.0 for k in opt.names}
        before = _bert_counts()
        if stage == "explainer":
            srg = models["surrogate"].requires_grad_(False)
            step = make_explainer_train_step(recipe, cfg, 511, 2)
            loss = step(model, opt, srg, torch.full((1, 2), 0.4, device=dev),
                        ids, None, 5e-5, update, 12, masks=masks)
        elif stage == "classifier":
            loss, _ = make_train_step(classifier_loss(recipe, cfg, True))(
                model, opt, 5e-5, update, ids, ones, labels, None, 12, w)
        else:
            orig = surrogate_teacher(recipe, cfg)(models["classifier"], ids,
                                                  ones)
            loss, _ = make_train_step(surrogate_loss(recipe, cfg, True))(
                model, opt, 5e-5, update, ids, mask, orig, labels, None, 12,
                w)
        torch.cuda.synchronize()
        calls = {k: v - before[k] for k, v in _bert_counts().items()}
        out[which] = (loss.item(), opt.grads, dict(model.named_parameters()),
                      calls)
    (loss, got, got_p, calls), (ref, want, want_p, ref_calls) = \
        out["kernels"], out["plain"]
    assert abs(loss - ref) <= 1e-4 * abs(ref), (loss, ref)
    # every trunk layer K6 + K7 and every ladder step K5 (the explainer's
    # side layer adds one K6 + K7 to each of its forwards)
    assert calls["ladder_block"] >= 12 and calls["attention_block"] >= 12 \
        and calls["mlp_block"] >= 12, calls
    assert not any(ref_calls.values()), ref_calls
    g_max = max(v.abs().max().item() for v in want.values())
    for k, v in want.items():
        err = (got[k] - v).abs().max().item()
        assert err <= 1e-4 * g_max, (k, err, g_max)
        # AdamW's first update is about lr sign(g): where a gradient is
        # within the bound of 0 its sign, and the update, is not settled;
        # held where |g| is ten times the bound
        moved = v.abs() > 1e-3 * g_max
        if moved.any():
            assert (got_p[k] - want_p[k])[moved].abs().max().item() \
                <= 1e-6, k


def test_bert_ladder_with_fewer_active_layers(dev, monkeypatch):
    """K5 "add" post-norm in a surrogate forward at BERT-base@512 with
    ltt_active_layers 1 and 5 of 12 against the plain versions: K5 runs at
    every layer (the gate keeps the update of the first k), the outputs
    agree, and they differ from the full depth's."""
    from autognothi_tpu_torch.recipes.ltt_bert import fw_surrogate

    monkeypatch.setenv("AUTOGNOTHI_PALLAS", "2")
    monkeypatch.setenv("AUTOGNOTHI_INT8", "0")
    cfg, models = _bert_base(dev, ["surrogate"])
    ids, _, mask, _ = _bert_batch(dev)
    got = {}
    with torch.no_grad():
        for active in (1, 5, 12):
            before = _bert_counts()["ladder_block"]
            got[active] = fw_surrogate(cfg, models["surrogate"], ids, mask,
                                       ltt_active_layers=active)[0]
            assert _bert_counts()["ladder_block"] == before + 12
        _route_plain(monkeypatch)
        for active in (1, 5):
            want = fw_surrogate(cfg, models["surrogate"], ids, mask,
                                ltt_active_layers=active)[0]
            _close(got[active], want, torch.float32)
            assert (got[active] - got[12]).abs().max().item() > 1e-6


def test_bert_int8_teacher_sweep_against_plain(dev, monkeypatch):
    """The explainer step's teacher at BERT-base@512 (B = 2 x M = 2) in
    pallas mode "2" with the int8 teacher: the float trunk attention (K6,
    the JAX budget), the 2-tile int8 MLP (K8q) and K5, against the same
    sweep on the plain versions, within the int8 bound (1e-2 x max(1,
    max|ref|): a flipped code moves a row by a quantization step)."""
    from autognothi_tpu_torch.parallel.train_step import _teacher
    from autognothi_tpu_torch.recipes.ltt_bert import ltt_bert_recipe

    monkeypatch.setenv("AUTOGNOTHI_PALLAS", "2")
    monkeypatch.delenv("AUTOGNOTHI_INT8_TEACHER", raising=False)
    cfg, models = _bert_base(dev, ["surrogate"])
    ids, _, _, masks = _bert_batch(dev)
    recipe = ltt_bert_recipe()
    before = _bert_counts()
    got = _teacher(recipe, cfg, models["surrogate"], ids, masks)
    torch.cuda.synchronize()
    calls = {k: v - before[k] for k, v in _bert_counts().items()}
    # the coalitions' and v_1's forwards: 12 layers each
    assert calls == {"attention_block": 24, "mlp_block": 0,
                     "ladder_block": 24, "mlp_block_int8_tiled": 48}, calls
    _route_plain(monkeypatch)
    want = _teacher(recipe, cfg, models["surrogate"], ids, masks)
    for x, y in zip(got, want):
        err = (x - y).abs().max().item()
        assert err <= 1e-2 * max(1.0, y.abs().max().item()), err


# ------------------------------------------- the duo and KernelSHAP paths


def _shipped_params(name: str, **overrides) -> dict:
    import json
    import pathlib

    hp = json.loads((pathlib.Path(__file__).resolve().parents[1]
                     / "experiments" / name / ".hparams.json").read_text())
    return dict(hp["net"]["params"], attention_probs_dropout_prob=0.0,
                hidden_dropout_prob=0.0, **overrides)


def _duo(dev, family: str, layers: int = 2):
    """A random duo final and its explainer at the shipped widths
    (ViT-B/16@224, BERT-base@512), `layers` deep, dropout 0, and two
    inputs."""
    import numpy as np

    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.recipes import (duo_vanilla_bert,
                                              duo_vanilla_vit)

    recipe = (duo_vanilla_vit.duo_vanilla_vit_recipe() if family == "vit"
              else duo_vanilla_bert.duo_vanilla_bert_recipe())
    name = "vit_base_imagenette_vanilla" if family == "vit" \
        else "bert_base_tayp_duo_vanilla"
    cfg = recipe.t_config(**_shipped_params(name, num_hidden_layers=layers))
    flat = recipe.init_final(cfg, torch.Generator().manual_seed(50))
    flat["surrogate_null"] = np.full_like(flat["surrogate_null"], 0.1)
    final = from_jax_params(flat, cfg, dev, section="final")
    explainer = from_jax_params(
        {k[len("explainer."):]: v for k, v in flat.items()
         if k.startswith("explainer.")}, cfg, dev, section="explainer")
    g = torch.Generator().manual_seed(51)
    if family == "vit":
        xs = torch.rand((2, 3, 224, 224), generator=g)
    else:
        xs = torch.randint(5, cfg.vocab_size, (2, 512), generator=g)
        xs[:, 0] = 2
    return recipe, cfg, final, explainer, xs.to(dev)


def _all_counts():
    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import head_block as hb
    from autognothi_tpu_torch.ops import mlp_block as mb

    return {c.name: c.count for c in (ab.COUNTER, ab.COUNTER_INT8,
                                      mb.COUNTER, mb.COUNTER_INT8,
                                      mb.COUNTER_INT8_TILED, hb.COUNTER)}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("family", ["vit", "bert"])
def test_duo_final_against_plain(dev, family, int8, monkeypatch):
    """The duo final (2 layers a tower at full width: 5 attention and 5
    MLP blocks, the explainer's layer among them) fp32 and W8A8 with the
    kernels against its plain versions: fp32 within 1e-4, W8A8 within the
    int8 bound; duo BERT's outputs are raw logits, duo ViT's sum to 1."""
    monkeypatch.setenv("AUTOGNOTHI_PALLAS", "2")
    monkeypatch.setenv("AUTOGNOTHI_INT8", "1" if int8 else "0")
    recipe, cfg, final, _, xs = _duo(dev, family)
    before = _all_counts()
    with torch.no_grad():
        got = recipe.fw_final(cfg, final, xs)
    torch.cuda.synchronize()
    calls = {k: v - before[k] for k, v in _all_counts().items()
             if v - before[k]}
    blocks = 5
    if not int8:
        assert calls == {"attention_block": blocks, "mlp_block": blocks}
    elif family == "vit":
        assert calls == {"attention_block_int8": blocks,
                         "mlp_block_int8": blocks, "head_block": 1}, calls
    else:  # the JAX budget: a float attention and the 2-tile K8q
        assert calls == {"attention_block": blocks,
                         "mlp_block_int8_tiled": 2 * blocks,
                         "head_block": 1}, calls
    _route_plain(monkeypatch)
    with torch.no_grad():
        want = recipe.fw_final(cfg, final, xs)
    assert got[1].shape == (2, cfg.num_labels,
                            196 if family == "vit" else 511)
    for g, w in zip(got, want):
        (_close_int8 if int8 else _close)(g, w, torch.float32)
    sums = got[0].sum(-1)
    if family == "vit":
        assert (sums - 1).abs().max().item() < 1e-4
    else:
        assert (sums - 1).abs().max().item() > 1e-3


@pytest.mark.parametrize("family", ["vit", "bert"])
def test_duo_grad_probe_against_plain(dev, family, monkeypatch):
    """The dual-task probe (two `torch.autograd.grad` calls through the
    kernel ops, whose backward recomputes the plain versions) against the
    probe on the plain versions: each gradient within 1e-4 x its max."""
    monkeypatch.setenv("AUTOGNOTHI_PALLAS", "2")
    monkeypatch.setenv("AUTOGNOTHI_INT8", "0")
    recipe, cfg, _, explainer, xs = _duo(dev, family)
    explainer.requires_grad_(False)
    p = recipe.n_players(cfg)
    g = torch.Generator().manual_seed(52)
    c = cfg.num_labels
    ones = torch.ones((2, p), dtype=torch.int32, device=dev)
    v_1 = torch.softmax(torch.randn(2, c, generator=g), -1).to(dev)
    null = torch.full((1, c), 1.0 / c, device=dev)
    zs = torch.randint(0, c, (2,), generator=g).to(dev)
    masks = torch.randint(0, 2, (2, 3, p), generator=g,
                          dtype=torch.int32).to(dev)
    v_s = torch.softmax(torch.randn(6, c, generator=g), -1).to(dev)
    probe = recipe.measurements.allow_dual_task_similarity.grad_probe
    args = (cfg, explainer, xs, ones, v_1, null, zs, masks, null, v_s, v_1)
    before = _all_counts()
    got = probe(*args)
    torch.cuda.synchronize()
    assert _all_counts()["attention_block"] > before["attention_block"]
    _route_plain(monkeypatch)
    want = probe(*args)
    for x, y in zip(got, want):
        assert x.shape == y.shape == (2, xs.shape[1] if family == "bert"
                                      else 197, cfg.hidden_size)
        err = (x - y).abs().max().item()
        assert err <= 1e-4 * y.abs().max().item(), err


@pytest.mark.parametrize("int8", [False, True])
def test_kernel_shap_classifier_slab_against_plain(dev, int8, monkeypatch):
    """One slab of KernelSHAP's classifier sweep (64 composed rows of 512
    tokens at BERT-base width, 2 layers) with the kernels against plain:
    fp32 K6 + K7 a layer, W8A8 (fp32 parameters) K6 + two K8q tiles."""
    import numpy as np

    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.recipes.kernel_shap_bert import (
        CLASSIFIER_SLAB, classifier_on_rows, kernel_shap_bert_recipe)

    monkeypatch.setenv("AUTOGNOTHI_PALLAS", "2")
    monkeypatch.setenv("AUTOGNOTHI_INT8", "1" if int8 else "0")
    recipe = kernel_shap_bert_recipe()
    cfg = recipe.t_config(**_shipped_params(
        "bert_base_tayp_kernel_shap", num_hidden_layers=2))
    flat = recipe.init_final(cfg, torch.Generator().manual_seed(53))
    model = from_jax_params(flat, cfg, dev, section="final")
    rows = np.random.RandomState(54).randint(
        5, cfg.vocab_size, (CLASSIFIER_SLAB, 512)).astype(np.int64)
    before = _all_counts()
    got = classifier_on_rows(cfg, model.classifier)(rows)
    torch.cuda.synchronize()
    calls = {k: v - before[k] for k, v in _all_counts().items()
             if v - before[k]}
    assert calls == ({"attention_block": 2, "mlp_block_int8_tiled": 4}
                     if int8 else {"attention_block": 2, "mlp_block": 2}), \
        calls
    _route_plain(monkeypatch)
    want = classifier_on_rows(cfg, model.classifier)(rows)
    assert got.shape == want.shape == (CLASSIFIER_SLAB, 2)
    (_close_int8 if int8 else _close)(torch.from_numpy(got),
                                      torch.from_numpy(want), torch.float32)


def test_k3_wide_route_bert_head_bf16_at_512(dev):
    """K3's wide route at the duo BERT's head in bf16: <8, 512, 768> ->
    3072 -> 3072 -> 2 without LN, against its plain version within the
    bf16 int8 bound, five launches."""
    from autognothi_tpu_torch.ops import head_block as hb

    g = torch.Generator().manual_seed(55)
    h_in, inter, c = 768, 3072, 2
    x = _rand(g, dev, 8, 512, h_in).to(torch.bfloat16)
    ws = tuple(w.to(torch.bfloat16) for w in (
        _rand(g, dev, inter, h_in, scale=h_in ** -0.5), _rand(g, dev, inter),
        _rand(g, dev, inter, inter, scale=inter ** -0.5),
        _rand(g, dev, inter), _rand(g, dev, c, inter, scale=inter ** -0.5),
        _rand(g, dev, c)))
    assert hb.k3_route(h_in, inter, c) == "wide"

    def op():
        return hb.explainer_head_block(x, *ws, None, None, 1e-5)

    got = op()
    tensors, static = hb.explainer_head_block_args(x, *ws, None, None, 1e-5)
    want = hb.head_int8_plain(*tensors, **static)
    assert got.shape == (8, 512, c)
    _close_int8(got, want, torch.bfloat16)
    assert len(_launched_per_call(op)) == 5


# -------------------------------- ViT-L/16@224 (1024 wide, 16 heads)

_VIT_L = dict(b=8, t=197, h=1024, heads=16, inter=4096)
# (op counter, quant, dtype) of each block on the served ViT-L's paths:
# the JAX gates' routes at T = 197 (`ops/gates.py`)
_VIT_L_BLOCKS = {
    "K6 fp32": ("attention_block", "none", torch.float32),
    "K6 bf16": ("attention_block", "none", torch.bfloat16),
    "K1 fp32": ("attention_block_int8", "int8", torch.float32),
    "K1 bf16": ("attention_block_int8", "int8", torch.bfloat16),
    "K7 fp32": ("mlp_block", "none", torch.float32),
    "K8q 2 tiles fp32": ("mlp_block_int8_tiled", "int8", torch.float32),
    "K4 bf16": ("mlp_block_int8", "int8", torch.bfloat16),
    "K8 2 tiles bf16": ("mlp_block_tiled", "none", torch.bfloat16),
}


def _vit_l_counts():
    from autognothi_tpu_torch.ops import flash_attention as fa
    from autognothi_tpu_torch.ops import mlp_block as mb

    return dict(_all_counts(), **{c.name: c.count
                                  for c in (mb.COUNTER_TILED, fa.COUNTER)})


@pytest.mark.parametrize("case", list(_VIT_L_BLOCKS))
def test_vit_large_blocks_against_plain(dev, case, monkeypatch):
    """Each block of the ViT-L paths at B = 8, T = 197, 1024 wide, 16
    heads, MLP 4096, LN prologue: the route the gate picks (its counter
    and no other: the MLP chains one launch a tile), within the float or
    int8 bounds of its plain version."""
    from autognothi_tpu_torch.ops import attention_block as ab
    from autognothi_tpu_torch.ops import mlp_block as mb

    name, quant, dtype = _VIT_L_BLOCKS[case]
    b, t, h, heads, inter = (_VIT_L[k] for k in ("b", "t", "h", "heads",
                                                  "inter"))
    g = torch.Generator().manual_seed(150)
    x = _rand(g, dev, b, t, h).to(dtype)
    ln = (1 + _rand(g, dev, h, scale=0.1), _rand(g, dev, h, scale=0.1), 1e-12)
    if name.startswith("attention"):
        ws = tuple(_rand(g, dev, *s, scale=h ** -0.5).to(dtype)
                   for s in [(h, h), (h,)] * 4)
        mask = _mask(g, dev, b, t, True)
        op = lambda: ab.attention_block(x, mask, ws, heads, "mul", ln=ln,  # noqa
                                        ln_position="prologue", quant=quant)
    else:
        ws = (_rand(g, dev, inter, h, scale=h ** -0.5).to(dtype),
              _rand(g, dev, inter, scale=0.1).to(dtype),
              _rand(g, dev, h, inter, scale=inter ** -0.5).to(dtype),
              _rand(g, dev, h, scale=0.1).to(dtype))
        op = lambda: mb.mlp_block(x, *ws, ln=ln, ln_position="prologue",  # noqa
                                  quant=quant)
    before = _vit_l_counts()
    got = op()
    torch.cuda.synchronize()
    calls = {k: v - before[k] for k, v in _vit_l_counts().items()
             if v - before[k]}
    assert calls == {name: 2 if "2 tiles" in case else 1}, calls
    _route_plain(monkeypatch)
    want = op()
    (_close_int8 if quant == "int8" else _close)(got, want, dtype)
    if quant == "int8" and dtype == torch.float32:
        assert _int8_flip_share(got, want, dtype) <= 1e-2


@pytest.mark.parametrize("mode", ["mul", "add"])
def test_vit_large_masked_attention_against_plain(dev, mode):
    """K9 at ViT-L's <8, 16, 197, 64> (mode "1"), fp32."""
    from autognothi_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(151)
    q, k, v = (_rand(g, dev, 8, 16, 197, 64) for _ in range(3))
    keep = _mask(g, dev, 8, 197, True)
    row = keep if mode == "mul" else (1 - keep) * torch.finfo(
        torch.float32).min
    before = fa.COUNTER.count
    got = fa.masked_attention(q, k, v, row, mode=mode)
    assert fa.COUNTER.count == before + 1
    _close(got, fa.masked_attention_plain(q, k, v, row, mode=mode),
           torch.float32)


@pytest.mark.parametrize("path", ["fp32", "int8", "int8 bf16", "bf16",
                                  "mode 1"])
def test_vit_large_final_against_plain(dev, path, monkeypatch):
    """A random vanilla ViT-L/16@224 final, 2 layers a tower (7 attention
    and 7 MLP blocks), at B = 2 on each served path against its plain
    versions: the kernel calls of the path's routes, fp32 within 1e-4,
    W8A8 within the int8 bound, bf16 within 3e-2; the W8A8 head is the
    eager denses (no K3)."""
    import numpy as np

    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.recipes import vanilla_vit

    monkeypatch.setenv("AUTOGNOTHI_PALLAS", "1" if path == "mode 1" else "2")
    monkeypatch.setenv("AUTOGNOTHI_INT8", "1" if "int8" in path else "0")
    recipe = vanilla_vit.vanilla_vit_recipe()
    cfg = recipe.t_config(**_shipped_params("vit_large_imagenette_vanilla",
                                            num_hidden_layers=2))
    flat = recipe.init_final(cfg, torch.Generator().manual_seed(152))
    flat["surrogate_null"] = np.full_like(flat["surrogate_null"], 0.1)
    dtype = torch.bfloat16 if "bf16" in path else torch.float32
    final = from_jax_params(flat, cfg, dev, dtype, section="final")
    xs = torch.rand((2, 3, 224, 224),
                    generator=torch.Generator().manual_seed(153)
                    ).to(dev, dtype)
    before = _vit_l_counts()
    with torch.no_grad():
        got = recipe.fw_final(cfg, final, xs)
    torch.cuda.synchronize()
    calls = {k: v - before[k] for k, v in _vit_l_counts().items()
             if v - before[k]}
    assert calls == {
        "fp32": {"attention_block": 7, "mlp_block": 7},
        "int8": {"attention_block_int8": 7, "mlp_block_int8_tiled": 14},
        "int8 bf16": {"attention_block_int8": 7, "mlp_block_int8": 7},
        "bf16": {"attention_block": 7, "mlp_block_tiled": 14},
        "mode 1": {"masked_attention": 7}}[path], calls
    _route_plain(monkeypatch)
    with torch.no_grad():
        want = recipe.fw_final(cfg, final, xs)
    assert got[1].shape == (2, 10, 196)
    for g, w in zip(got, want):
        (_close_int8 if "int8" in path else _close)(g, w, dtype)


# ------------------------------------------ the export's custom ops (M9)

_EXPORT_INT8_OPS = ("attention_block_int8", "mlp_block_int8",
                    "mlp_block_int8_tiled", "mlp_ladder_block", "head_block")


def _vit_op_args(name, g, dev):
    """(tensors, static) of export op `name` at the LTT ViT-B/16@224 shapes
    (B = 2, T = 197: trunk 768 / 3072 in 12 heads, side 96 / 384 in 12
    heads of d = 8, head 96 -> 3072 -> 3072 -> 10), from the ops' own
    `*_args` functions."""
    from autognothi_tpu_torch.ops import (attention_block as ab,
                                          head_block as hb,
                                          ladder_block as lb,
                                          mlp_block as mb)

    b, t, h, inter, s, heads = 2, 197, 768, 3072, 96, 12

    def r(*shape, scale=0.05):
        return _rand(g, dev, *shape, scale=scale)

    def branch():
        return {"map_w": r(s, h), "map_b": r(s), "ln1_w": 1 + r(s),
                "ln1_b": r(s), "wq": r(s, s), "bq": r(s), "wk": r(s, s),
                "bk": r(s), "wv": r(s, s), "bv": r(s), "wo": r(s, s),
                "bo": r(s), "ln2_w": 1 + r(s), "ln2_b": r(s),
                "w1": r(4 * s, s), "b1": r(4 * s), "w2": r(s, 4 * s),
                "b2": r(s)}

    x = r(b, t, h, scale=1.0)
    mask = _mask(g, dev, b, t, True)
    ln = (1 + r(h), r(h), 1e-12)
    sides = [r(b, t, s, scale=1.0) for _ in range(2)]
    if name in ("attention_block", "attention_block_int8"):
        return ab.attention_block_args(x, mask, [r(*sh) for sh in
                                                 [(h, h), (h,)] * 4],
                                       heads, "mul", ln, "prologue")
    if name in ("mlp_block", "mlp_block_int8"):
        return mb.mlp_block_args(x, r(inter, h), r(inter), r(h, inter),
                                 r(h), ln, "prologue")
    if name in ("mlp_block_tiled", "mlp_block_int8_tiled"):
        w1, w2 = r(inter, h), r(h, inter)  # the first of two tiles
        return (x, r(b, t, h, scale=1.0), w1[:inter // 2], r(inter // 2),
                w2[:, :inter // 2], r(h)), {}
    if name == "chain_layer_norm":
        return (x, 1 + r(h), r(h)), dict(eps=1e-12)
    if name == "ladder_block":
        return lb.ladder_block_args(x, sides, mask, [branch(), branch()],
                                    heads, "mul", True, 1e-12)
    if name == "mlp_ladder_block":
        trunk = dict(zip(lb.TRUNK_MLP_KEYS, (r(inter, h), r(inter),
                                             r(h, inter), r(h), 1 + r(h),
                                             r(h))))
        return lb.mlp_ladder_block_args(x, sides, mask, trunk,
                                        [branch(), branch()], heads, "mul",
                                        1e-12)
    if name == "ladder_attention":
        return (mask, *(r(b, t, s, scale=1.0) for _ in range(6))), dict(
            n_heads=heads, mode="mul")
    if name == "head_block":
        return hb.explainer_head_block_args(
            sides[0], r(inter, s), r(inter), r(inter, inter), r(inter),
            r(10, inter), r(10), 1 + r(s), r(s), 1e-12)
    if name == "masked_attention":
        q, k, v = (r(b, heads, t, 64, scale=1.0) for _ in range(3))
        return (q, k, v, (1 - mask) * torch.finfo(torch.float32).min), \
            dict(mode="add")
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "attention_block", "attention_block_int8", "mlp_block", "mlp_block_int8",
    "mlp_block_tiled", "mlp_block_int8_tiled", "chain_layer_norm",
    "ladder_block", "mlp_ladder_block", "ladder_attention", "head_block",
    "masked_attention"])
def test_export_op_cuda_registration_against_plain(dev, name):
    """Each `autognothi::*` custom op (the export's `--kernels` program) on
    CUDA tensors: one launch counted on its counter, its outputs the
    fake implementation's shapes and dtypes, within the kernel tolerance of
    its plain version, and equal to the live launcher's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from autognothi_tpu_torch.kernels import library

    op = library.OPS[name]
    launch, plain, counter = op.resolve()
    tensors, static = _vit_op_args(name, torch.Generator().manual_seed(160),
                                   dev)
    custom = getattr(torch.ops.autognothi, name)
    before = counter.count
    with torch.inference_mode():
        got = custom(list(tensors), **static)
        live = launch(*tensors, **static)
        want = plain(*tensors, **static)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    live = list(live) if isinstance(live, tuple) else [live]
    want = list(want) if isinstance(want, tuple) else [want]
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        fakes = custom([mode.from_tensor(x) for x in tensors], **static)
    assert [(f.shape, f.dtype, f.stride()) for f in fakes] == \
        [(x.shape, x.dtype, x.stride()) for x in got]
    close = _close_int8 if name in _EXPORT_INT8_OPS else _close
    for g_, l_, w_ in zip(got, live, want):
        assert torch.equal(g_, l_), name
        close(g_, w_, torch.float32)


def _export_counts() -> dict:
    from autognothi_tpu_torch.kernels import library

    return {name: op.resolve()[2].count for name, op in library.OPS.items()}


def _calls_a_slab(service, before: dict) -> dict:
    """The kernel calls since `before` over the slabs that ran through the
    kernels (eager and captured ones; a replayed slab calls none)."""
    ran = (service.slab_counts["eager_slabs"]
           + service.slab_counts["graph_captures"])
    return {k: (v - before[k]) / ran
            for k, v in _export_counts().items() if v != before[k]}


def test_w8a8_kernels_artifact_bit_identical_to_live_serving(dev, tmp_path,
                                                             monkeypatch):
    """A random LTT ViT-B/16@224 final (2 of the 12 layers, full widths)
    exported with `--kernels` under AUTOGNOTHI_INT8=1 and served from the
    artifact at B = 8: the kernel calls of a slab are the live path's, and
    every answer equals live serving's bit for bit."""
    import json
    import pathlib

    import numpy as np

    from autognothi_tpu_torch import RECIPE_VERSION
    from autognothi_tpu_torch.models.ltt_vit import (LttViTConfig,
                                                     init_ltt_vit_final)
    from autognothi_tpu_torch.params import save_params, to_flat
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.export import export_final
    from autognothi_tpu_torch.pipeline.serve import ExplainService

    monkeypatch.setenv("AUTOGNOTHI_INT8", "1")
    monkeypatch.delenv("AUTOGNOTHI_PALLAS", raising=False)
    params = dict(_shipped_params("vit_base_imagenette_vanilla"))
    params = {k: params[k] for k in ("hidden_size", "intermediate_size",
                                     "num_attention_heads",
                                     "layer_norm_eps", "img_channels",
                                     "img_px_size", "img_patch_size")}
    params.update(attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0,
                  num_hidden_layers=2, num_labels=10,
                  explainer_s_attn_num_layers=1,
                  explainer_s_head_hidden_size=3072,
                  explainer_normalize=True, s_attn_hidden_size=96,
                  s_attn_intermediate_size=384)
    hp = json.loads((pathlib.Path(__file__).resolve().parents[1]
                     / "experiments" / "vit_base_imagenette_vanilla"
                     / ".hparams.json").read_text())
    hp["net"] = {"kind": "ltt_vit", "version": RECIPE_VERSION,
                 "base_model": "random_init", "params": params}
    exp = tmp_path / "ltt_vit"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp))
    model = init_ltt_vit_final(LttViTConfig(**params),
                               torch.Generator().manual_seed(161))
    save_params(exp / "final-epoch-0.ckpt", to_flat(model))
    rng = np.random.RandomState(162)
    payloads = [{"images": rng.rand(3, 3, 224, 224).tolist()},
                {"images_u8": rng.randint(0, 256, (9, 3, 224, 224)
                                          ).tolist()}]
    with ExpEnv(exp) as env:
        meta = export_final(env, tmp_path / "k.agx", 8, platforms=["cuda"],
                            kernels=True)
        assert meta["quant"] == "int8"
        answers, calls, replays = [], [], []
        for artifact in (None, tmp_path / "k.agx"):
            service = ExplainService(env, batch_size=8, device="cuda",
                                     artifact=artifact)
            try:
                before = _export_counts()
                service.warmup()
                answers.append([service.explain(p) for p in payloads])
                torch.cuda.synchronize()
                calls.append(_calls_a_slab(service, before))
                replays.append(service.slab_counts["graph_replays"])
            finally:
                service.close()
    # live: warmup's two keys captured, then 3 slabs replayed
    assert replays == [2 + 3, 0], replays
    assert calls[0] == calls[1], calls
    assert calls[0]["attention_block_int8"] == 3
    for live, art in zip(*answers):
        for key in ("logits", "attributions"):
            assert np.array_equal(np.asarray(live[key]),
                                  np.asarray(art[key])), key


def test_world_of_one_over_nccl_is_the_one_device_path(dev, tmp_path,
                                                       monkeypatch):
    """A world of one process through the CLI's own initialisation
    (AUTOGNOTHI_DIST_* on 127.0.0.1, NCCL): at the LTT ViT-B/16@224 widths
    (2 of the 12 layers), one explainer step at B = 8 x M = 32 is bit-
    identical to the same step before the world, and a W8A8 serve of 3
    slabs of 8 answers bit for bit as before, with the same kernel calls
    a slab."""
    import copy
    import json
    import pathlib
    import socket

    import numpy as np
    import torch.distributed as dist

    from autognothi_tpu_torch import RECIPE_VERSION
    from autognothi_tpu_torch.models.ltt_vit import (LttViTConfig,
                                                     init_ltt_vit,
                                                     init_ltt_vit_final)
    from autognothi_tpu_torch.ops.shapley import mask_shapley
    from autognothi_tpu_torch.parallel.distributed import (
        maybe_initialize_distributed, process_info)
    from autognothi_tpu_torch.parallel.mesh import setup_data_parallel
    from autognothi_tpu_torch.parallel.train_step import \
        make_explainer_train_step
    from autognothi_tpu_torch.params import save_params, to_flat
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import ExplainService
    from autognothi_tpu_torch.pipeline.training import AdamW
    from autognothi_tpu_torch.recipes.ltt_vit import ltt_vit_recipe

    monkeypatch.delenv("AUTOGNOTHI_PALLAS", raising=False)
    monkeypatch.setenv("AUTOGNOTHI_INT8", "0")
    params = {k: v for k, v in _shipped_params(
        "vit_base_imagenette_vanilla").items() if k in (
            "hidden_size", "intermediate_size", "num_attention_heads",
            "layer_norm_eps", "img_channels", "img_px_size",
            "img_patch_size", "attention_probs_dropout_prob",
            "hidden_dropout_prob")}
    params.update(num_hidden_layers=2, num_labels=10,
                  explainer_s_attn_num_layers=1,
                  explainer_s_head_hidden_size=3072,
                  explainer_normalize=True, s_attn_hidden_size=96,
                  s_attn_intermediate_size=384)
    cfg = LttViTConfig(**params)
    recipe = ltt_vit_recipe()
    n_players = recipe.n_players(cfg)
    srg = init_ltt_vit(cfg, "surrogate", torch.Generator().manual_seed(171)
                       ).to(dev).requires_grad_(False)
    start = init_ltt_vit(cfg, "explainer", torch.Generator().manual_seed(172)
                         ).to(dev)
    trainable = recipe.trainable(cfg, "explainer")
    g = torch.Generator().manual_seed(173)
    xs = torch.rand((8, 3, 224, 224), generator=g).to(dev)
    masks = mask_shapley(g, 8 * 32, n_players).reshape(8, 32, n_players
                                                       ).to(dev)
    null = torch.full((1, 10), 0.1, device=dev)

    def one_step(mesh):
        model = copy.deepcopy(start)
        for name, p in model.named_parameters():
            p.requires_grad_(trainable(name))
        params = dict(model.named_parameters())
        step = make_explainer_train_step(recipe, cfg, n_players, 32,
                                         mesh=mesh)
        loss = step(model, AdamW(params, trainable), srg, null, xs, None,
                    5e-5, {k: 1.0 for k in params}, 2, masks=masks)
        return loss.item(), {k: v.clone() for k, v in
                             model.state_dict().items()}

    hp = json.loads((pathlib.Path(__file__).resolve().parents[1]
                     / "experiments" / "vit_base_imagenette_vanilla"
                     / ".hparams.json").read_text())
    hp["net"] = {"kind": "ltt_vit", "version": RECIPE_VERSION,
                 "base_model": "random_init", "params": params}
    exp = tmp_path / "ltt_vit"
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp))
    save_params(exp / "final-epoch-0.ckpt", to_flat(init_ltt_vit_final(
        cfg, torch.Generator().manual_seed(174))))
    rng = np.random.RandomState(175)
    payloads = [{"images": rng.rand(3, 3, 224, 224).tolist()},
                {"images_u8": rng.randint(0, 256, (9, 3, 224, 224)
                                          ).tolist()}]
    def serve_w8a8():
        monkeypatch.setenv("AUTOGNOTHI_INT8", "1")
        with ExpEnv(exp) as env:
            service = ExplainService(env, batch_size=8, device="cuda")
            try:
                before = _export_counts()
                service.warmup()
                answers = [service.explain(p) for p in payloads]
                torch.cuda.synchronize()
                calls = _calls_a_slab(service, before)
                # warmup's two keys captured, then 3 slabs replayed
                assert service.slab_counts["graph_replays"] == 2 + 3
            finally:
                service.close()
        monkeypatch.setenv("AUTOGNOTHI_INT8", "0")
        return answers, calls

    want_step, want_serve = one_step(None), serve_w8a8()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("AUTOGNOTHI_DIST_COORD", f"127.0.0.1:{port}")
    monkeypatch.setenv("AUTOGNOTHI_DIST_NPROCS", "1")
    monkeypatch.setenv("AUTOGNOTHI_DIST_PROC_ID", "0")
    assert maybe_initialize_distributed(device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        assert process_info()["process_count"] == 1
        mesh, _, _ = setup_data_parallel(dev)
        assert mesh is None
        got_step, got_serve = one_step(mesh), serve_w8a8()
    finally:
        dist.destroy_process_group()
    assert got_step[0] == want_step[0]
    for k, v in want_step[1].items():
        assert torch.equal(got_step[1][k], v), k
    assert got_serve[1] == want_serve[1]
    assert got_serve[1]["attention_block_int8"] == 3
    for live, world in zip(want_serve[0], got_serve[0]):
        for key in ("logits", "attributions"):
            assert np.array_equal(np.asarray(live[key]),
                                  np.asarray(world[key])), key


# --------------------------------------------- served slabs as CUDA graphs


def _served_exp(tmp_path, family: str, layers: int = 2):
    """An experiment `ExplainService` loads: a random LTT ViT-B/16@224 or
    LTT BERT-base@512 final (`layers` of the 12 layers, full widths,
    dropout 0), BERT's with a small WordPiece vocabulary."""
    import json
    import pathlib
    import string

    from autognothi_tpu_torch import RECIPE_VERSION
    from autognothi_tpu_torch.params import save_params, to_flat

    root = pathlib.Path(__file__).resolve().parents[1] / "experiments"
    if family == "vit":
        from autognothi_tpu_torch.models.ltt_vit import (LttViTConfig,
                                                         init_ltt_vit_final)

        hp = json.loads((root / "vit_base_imagenette_vanilla"
                         / ".hparams.json").read_text())
        params = {k: v for k, v in hp["net"]["params"].items() if k in (
            "hidden_size", "intermediate_size", "num_attention_heads",
            "layer_norm_eps", "img_channels", "img_px_size",
            "img_patch_size")}
        params.update(num_labels=10, explainer_s_attn_num_layers=1,
                      explainer_s_head_hidden_size=3072,
                      explainer_normalize=True, s_attn_hidden_size=96,
                      s_attn_intermediate_size=384)
        kind = "ltt_vit"
    else:
        from autognothi_tpu_torch.models.ltt_bert import (LttBertConfig,
                                                          init_ltt_bert)

        hp = json.loads((root / "bert_base_tayp_ltt" / ".hparams.json"
                         ).read_text())
        params = dict(hp["net"]["params"])
        kind = "ltt_bert"
    params.update(attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0,
                  num_hidden_layers=layers)
    hp["net"] = {"kind": kind, "version": RECIPE_VERSION,
                 "base_model": "random_init", "params": params}
    exp = tmp_path / kind
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp))
    g = torch.Generator().manual_seed(231)
    if family == "vit":
        final = init_ltt_vit_final(LttViTConfig(**params), g)
    else:
        final = init_ltt_bert(LttBertConfig(**params), "final", g)
        (exp / "tokenizer").mkdir()
        (exp / "tokenizer" / "vocab.txt").write_text("\n".join(
            ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
            + [c for ch in string.ascii_lowercase for c in (ch, "##" + ch)])
            + "\n")
    save_params(exp / "final-epoch-0.ckpt", to_flat(final))
    return exp


def _slabs(kind: str, n: int, seed: int, rows: int = 8):
    """n distinct host slabs of one key: u8 or f32 images, or token ids."""
    import numpy as np

    rng = np.random.RandomState(seed)
    if kind == "vit_u8":
        return [rng.randint(0, 256, (rows, 3, 224, 224)).astype(np.uint8)
                for _ in range(n)]
    if kind == "vit_f32":
        return [rng.rand(rows, 3, 224, 224).astype(np.float32)
                for _ in range(n)]
    out = []
    for _ in range(n):
        ids = rng.randint(5, 30000, (rows, 512)).astype(np.int64)
        ids[:, 0] = 2
        out.append(ids)
    return out


def _launches():
    """Each kernel op's calls so far, by its counter's name."""
    from autognothi_tpu_torch.kernels.build import LaunchCounter
    from autognothi_tpu_torch.ops import (attention_block, flash_attention,
                                          head_block, ladder_block,
                                          mlp_block)

    return {c.name: c.count
            for m in (attention_block, flash_attention, head_block,
                      ladder_block, mlp_block)
            for c in vars(m).values() if isinstance(c, LaunchCounter)}


def _eager(service, slab):
    """A slab through the service's eager path alone, on the host."""
    from autognothi_tpu_torch.pipeline.serve import fetch

    return fetch(service._forward(service._dequant(
        torch.as_tensor(slab).to(service.device))))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kind", ["vit_u8", "vit_f32", "bert"])
def test_replayed_slabs_are_bit_identical_to_eager(dev, tmp_path,
                                                   monkeypatch, kind, int8):
    """Two distinct slabs of one key at B = 8 (2 of the 12 layers, full
    widths), fp32 and W8A8: the first runs eagerly, the second is captured
    and replayed, then both replay, queued back to back before any is
    fetched; every answer equals the eager path's bit for bit."""
    import numpy as np

    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import ExplainService, fetch

    monkeypatch.setenv("AUTOGNOTHI_INT8", "1" if int8 else "0")
    monkeypatch.delenv("AUTOGNOTHI_PALLAS", raising=False)
    exp = _served_exp(tmp_path, "bert" if kind == "bert" else "vit")
    s1, s2 = _slabs(kind, 2, 232)
    with ExpEnv(exp) as env:
        service = ExplainService(env, batch_size=8, device="cuda")
        try:
            assert service.replays
            want = [_eager(service, s) for s in (s1, s2)]
            outs = [service._run_slab(s) for s in (s1, s2, s1, s2)]
            got = [fetch(o) for o in outs]
            counts = dict(service.slab_counts)
        finally:
            service.close()
    assert counts == {"graph_captures": 1, "graph_replays": 3,
                      "eager_slabs": 1, "graph_fallbacks": 0}, counts
    for i, outs in enumerate(got):
        assert len(outs) == len(want[i % 2]) == 2
        for g_, w_ in zip(outs, want[i % 2]):
            assert g_.dtype == np.float32 and np.array_equal(g_, w_), i


@pytest.mark.parametrize("kind", ["vit_u8", "bert"])
def test_captured_slab_counts_the_eager_slabs_launches_and_a_replay_none(
        dev, tmp_path, monkeypatch, kind):
    """The kernel ops' `LaunchCounter`s count the calls that went to a
    kernel: the captured slab's equal the eager slab's (W8A8, whose routes
    count most), and a replay, which calls no op, adds none of its own
    while `graph_replays` counts it."""
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import ExplainService, fetch

    monkeypatch.setenv("AUTOGNOTHI_INT8", "1")
    monkeypatch.delenv("AUTOGNOTHI_PALLAS", raising=False)
    exp = _served_exp(tmp_path, "bert" if kind == "bert" else "vit")
    s1, s2 = _slabs(kind, 2, 233)
    deltas, replays = [], []
    with ExpEnv(exp) as env:
        service = ExplainService(env, batch_size=8, device="cuda")
        try:
            for slab in (s1, s2, s1, s2):  # eager, captured, replays
                before = _launches()
                fetch(service._run_slab(slab))
                deltas.append({k: v - before[k]
                               for k, v in _launches().items()
                               if v != before[k]})
                replays.append(service.slab_counts["graph_replays"])
            torch.cuda.synchronize()
        finally:
            service.close()
    assert deltas[0] and deltas[1] == deltas[0], deltas
    assert deltas[2:] == [{}, {}], deltas
    assert replays == [0, 1, 2, 3]


def test_service_replays_consecutive_distinct_slabs_at_depth_2(
        dev, tmp_path, monkeypatch):
    """Twelve distinct full slabs submitted at once through the batcher
    (depth 2: the completer fetches slab n while slab n + 1 replays): every
    answer equals an eager service's on the same rows, bit for bit."""
    import threading

    import numpy as np

    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import ExplainService

    monkeypatch.setenv("AUTOGNOTHI_INT8", "0")
    monkeypatch.delenv("AUTOGNOTHI_PALLAS", raising=False)
    exp = _served_exp(tmp_path, "vit")
    slabs = _slabs("vit_u8", 12, 234)
    answers = []
    with ExpEnv(exp) as env:
        for replays in (False, True):
            service = ExplainService(env, batch_size=8, device="cuda")
            service.replays = replays
            got = {}

            def client(i, service=service, got=got):
                got[i] = service._batcher.submit(slabs[i])

            try:
                service.warmup()
                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(len(slabs))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300)
                    assert not t.is_alive()
                counts = dict(service.slab_counts)
            finally:
                service.close()
            answers.append(got)
            if replays:  # warmup: the f32 and u8 null slabs, eager + capture
                assert counts == {"graph_captures": 2, "graph_replays": 14,
                                  "eager_slabs": 2, "graph_fallbacks": 0}
            else:
                assert counts["eager_slabs"] == 2 + 12
    for i in range(len(slabs)):
        for e, r in zip(answers[0][i], answers[1][i]):
            assert np.array_equal(e, r), i


def test_a_key_whose_capture_fails_stays_eager(dev, tmp_path, monkeypatch):
    """A forward that syncs with the host cannot be captured: its key falls
    back to eager once, is counted once, and answers as before."""
    import numpy as np

    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import ExplainService, fetch

    monkeypatch.setenv("AUTOGNOTHI_INT8", "0")
    monkeypatch.delenv("AUTOGNOTHI_PALLAS", raising=False)
    exp = _served_exp(tmp_path, "vit")
    s1, s2 = _slabs("vit_u8", 2, 235)
    with ExpEnv(exp) as env:
        service = ExplainService(env, batch_size=8, device="cuda")
        fw = service._fw

        def syncing(model, xs):
            outs = fw(model, xs)
            outs[0].sum().item()  # a host sync inside the slab's work
            return outs

        service._fw = syncing
        try:
            want = [_eager(service, s) for s in (s1, s2)]
            got = [fetch(service._run_slab(s)) for s in (s1, s2, s1, s2)]
            counts = dict(service.slab_counts)
        finally:
            service.close()
    assert counts == {"graph_captures": 0, "graph_replays": 0,
                      "eager_slabs": 4, "graph_fallbacks": 1}, counts
    for i, outs in enumerate(got):
        for g_, w_ in zip(outs, want[i % 2]):
            assert np.array_equal(g_, w_), i
