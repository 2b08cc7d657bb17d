"""Plain PyTorch building blocks of the references.

Written from the published layer equations and the AutoGnothi model
description; it imports nothing of the program under test.  Everything
computes in float32 unless `bits` asks for the W8A8 arithmetic the
configuration states:

- weights quantized per output channel: scale = max|w| / qmax + 1e-12,
  code = round(w / scale), rounded half to even;
- activations quantized per row (token): amax = max|x| + 1e-12, code =
  round(x * (qmax / amax)), scale = amax * (1 / qmax);
- the integer product exact (float64 holds every partial sum of the
  inner widths used here), dequantized and biased in float32.

qmax is 127 for int8 and 7 for int4 (the control's precision).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def float32_matmuls(tf32: bool = False):
    """Matrix products in full float32 (TF32 off), or in TF32 for the
    control; the previous settings are restored."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def quant_cols(w: torch.Tensor, bits: int):
    """Per-output-channel codes of a (out, in) weight -> (codes, scale)."""
    w = w.float()
    scale = w.abs().amax(dim=1) / qmax(bits) + 1e-12
    return torch.round(w / scale[:, None]), scale


def quant_rows(x: torch.Tensor, bits: int):
    """Per-row codes over the last axis -> (codes, scale <..., 1>)."""
    amax = x.float().abs().amax(dim=-1, keepdim=True) + 1e-12
    inv = amax.new_tensor(qmax(bits)) / amax
    return torch.round(x.float() * inv), amax * (1.0 / qmax(bits))


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           bits: Optional[int] = None) -> torch.Tensor:
    """x @ w.T + b: float32, or W`bits`A`bits` with the exact integer sum."""
    if bits is None:
        return F.linear(x, w, b)
    xq, xs = quant_rows(x, bits)
    wq, ws = quant_cols(w, bits)
    acc = torch.matmul(xq.reshape(-1, xq.shape[-1]).double(),
                       wq.double().T).float()
    acc = acc.reshape(*xq.shape[:-1], wq.shape[0])
    out = acc * xs * ws
    return out if b is None else out + b.float()


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU."""
    return F.gelu(x)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, heads: int, mode: str) -> torch.Tensor:
    """Multi-head attention over <B, T, H> projections.  mode "mul": the
    0/1 <B, T> mask multiplies the scaled scores (a masked key scores 0,
    the ViT side of AutoGnothi); "add": the <B, T> bias is added (BERT)."""
    b, t, h = q.shape
    d = h // heads

    def split(y):
        return y.reshape(b, t, heads, d).transpose(1, 2)

    scores = torch.matmul(split(q), split(k).transpose(-1, -2)) \
        * (1.0 / math.sqrt(d))
    m = mask.float()[:, None, None, :]
    scores = scores * m if mode == "mul" else scores + m
    ctx = torch.matmul(torch.softmax(scores, dim=-1), split(v))
    return ctx.transpose(1, 2).reshape(b, t, h)


def self_attention(x: torch.Tensor, mask: torch.Tensor, p: dict, pre: str,
                   heads: int, mode: str, bits: Optional[int]
                   ) -> torch.Tensor:
    """OutProj(Attn(Q, K, V)) of `x` under the names `<pre>attention.self.
    {query,key,value}` and `<pre>attention.output.dense`; the products in
    `bits`."""
    sa = pre + "attention.self."
    q, k, v = (linear(x, p[sa + n + ".weight"], p[sa + n + ".bias"], bits)
               for n in ("query", "key", "value"))
    ctx = attention(q, k, v, mask, heads, mode)
    out = pre + "attention.output.dense."
    return linear(ctx, p[out + "weight"], p[out + "bias"], bits)


def mlp(x: torch.Tensor, p: dict, pre: str, bits: Optional[int]
        ) -> torch.Tensor:
    """`<pre>output.dense`(GELU(`<pre>intermediate.dense`(x)))."""
    inter = gelu(linear(x, p[pre + "intermediate.dense.weight"],
                        p[pre + "intermediate.dense.bias"], bits))
    return linear(inter, p[pre + "output.dense.weight"],
                  p[pre + "output.dense.bias"], bits)


def ln(x: torch.Tensor, p: dict, pre: str, eps: float) -> torch.Tensor:
    return layer_norm(x, p[pre + "weight"], p[pre + "bias"], eps)


def cls_probs(x: torch.Tensor, p: dict, pre: str) -> torch.Tensor:
    """The `<pre>` classifier on the CLS row, softmaxed."""
    return torch.softmax(linear(x[:, 0, :], p[pre + "weight"],
                                p[pre + "bias"]), dim=-1)


def normalize_shapley(pred: torch.Tensor, grand: torch.Tensor,
                      null: torch.Tensor) -> torch.Tensor:
    """The additive efficiency projection over all T tokens (CLS
    included): each class's values shift to sum to grand - null."""
    diff = (grand[:, None, :] - null.reshape(1, 1, -1)) \
        - pred.sum(dim=1, keepdim=True)
    return pred + diff / pred.shape[1]
