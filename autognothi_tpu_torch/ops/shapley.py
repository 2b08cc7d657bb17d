"""Shapley estimation math (port of `autognothi_tpu/ops/shapley.py`).

- `mask_shapley` samples coalition sizes from the Shapley kernel
  distribution p(k) ~ 1/(k(n-k)), k = 1..n-1, thresholds uniform noise at
  idx/n = (k-1)/n (the reference quirk the JAX package keeps, not k/n),
  and pairs every mask with its complement.
- `loss_shapley` is the weighted regression n * MSE(null + mask.phi, v_s).
- `loss_logits_kl_divergence` keeps the reference's argument orientation,
  KL(current || ref) with batchmean reduction.
- `normalize_shapley_explanation` is the additive efficiency projection
  over the token axis, CLS included.

Samplers draw from a `torch.Generator` on its own device; JAX's random
streams cannot be reproduced, so the laws are what the two share.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "shapley_kernel_probs",
    "mask_shapley",
    "loss_shapley",
    "normalize_shapley_explanation",
    "loss_logits_kl_divergence",
    "mask_purely_uniform",
    "mask_uniform_selective",
]


def shapley_kernel_probs(n_players: int) -> torch.Tensor:
    """p(k) ~ 1/(k(n-k)) over coalition sizes k = 1..n-1, normalized, fp32."""
    k = torch.arange(1, n_players, dtype=torch.float32)
    probs = 1.0 / (k * (n_players - k))
    return probs / probs.sum()


def mask_shapley(generator: torch.Generator, n_mask_samples: int,
                 n_players: int, paired: bool = True) -> torch.Tensor:
    """Sample <n_mask_samples, n_players> int32 0/1 coalition masks on the
    generator's device.  paired=True (the training default) draws half the
    samples and interleaves each with its complement: [m0, ~m0, m1, ...]."""
    if paired:
        if n_mask_samples % 2 != 0:
            raise ValueError("paired sampling requires even n_mask_samples")
        n_draw = n_mask_samples // 2
    else:
        n_draw = n_mask_samples
    dev = generator.device
    probs = shapley_kernel_probs(n_players).to(dev)
    # coalition-size index in [0, n_players-2]; threshold at idx / n_players
    size_idx = torch.multinomial(probs, n_draw, replacement=True,
                                 generator=generator).float()[:, None]
    noise = torch.rand((n_draw, n_players), generator=generator, device=dev)
    masks = (noise > size_idx / n_players).to(torch.int32)
    if paired:
        masks = torch.stack([masks, 1 - masks], dim=1).reshape(
            n_draw * 2, n_players)
    return masks


def loss_shapley(
    mask: torch.Tensor,   # <batch, n_mask_samples, n_players>
    v_0: torch.Tensor,    # <1, n_classes>  surrogate on the null input
    v_s: torch.Tensor,    # <batch * n_mask_samples, n_classes>
    v_1: torch.Tensor,    # <batch, n_classes>  (unused, kept for parity)
    phi: torch.Tensor,    # <batch, n_classes, n_players>
    weights: Optional[torch.Tensor] = None,  # <batch> 0/1; None = all real
) -> torch.Tensor:
    """FastSHAP-style regression n_players * MSE(v0 + mask.phi, v_s), in
    fp32.  `weights` marks real batch rows (0 = padding): the weighted
    mean over the rows' M x C terms equals the unpadded mean."""
    del v_1
    batch, n_mask_samples, n_players = mask.shape
    values_pred = phi.transpose(1, 2).float()
    approx = v_0.float().reshape(1, 1, -1) + torch.einsum(
        "bmp,bpc->bmc", mask.float(), values_pred)
    sq = (approx.reshape(batch * n_mask_samples, -1) - v_s.float()) ** 2
    if weights is None:
        return n_players * sq.mean()
    w = weights.float()
    per_row = sq.reshape(batch, -1).sum(dim=1)
    denom = w.sum() * (n_mask_samples * sq.shape[-1])
    return n_players * (w * per_row).sum() / torch.clamp(denom, min=1.0)


def normalize_shapley_explanation(
    pred: torch.Tensor,   # <batch, n_tokens, n_classes>
    grand: torch.Tensor,  # <batch, n_classes>
    null: torch.Tensor,   # <1, n_classes>
) -> torch.Tensor:
    """Additive efficiency projection: shift each column so per-class sums
    equal grand - null."""
    n_tokens = pred.shape[1]
    diff = (grand[:, None, :] - null.reshape(1, 1, -1)) \
        - pred.sum(dim=1, keepdim=True)
    return pred + diff / n_tokens


def loss_logits_kl_divergence(ref: torch.Tensor, current: torch.Tensor,
                              weights: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The reference-oriented KL (batchmean):
    F.kl_div(input=log_softmax(ref), target=softmax(current)) =
    mean_b sum_c p_cur (log p_cur - log p_ref).  `weights` <batch> marks
    real rows (0 = padding): weighted batchmean."""
    log_p_ref = torch.log_softmax(ref, dim=-1)
    log_p_cur = torch.log_softmax(current, dim=-1)
    per_item = (torch.softmax(current, dim=-1)
                * (log_p_cur - log_p_ref)).sum(dim=-1)
    if weights is None:
        return per_item.mean()
    w = weights.to(per_item.dtype)
    return (w * per_item).sum() / torch.clamp(w.sum(), min=1.0)


def mask_purely_uniform(generator: torch.Generator, batch_size: int,
                        n_features: int) -> torch.Tensor:
    """Random int32 masks whose masked-out count is ~uniform over [0, n]."""
    dev = generator.device
    noise = torch.rand((batch_size, n_features), generator=generator,
                       device=dev)
    threshold = torch.rand((batch_size, 1), generator=generator, device=dev)
    return (noise > threshold).to(torch.int32)


def mask_uniform_selective(generator: torch.Generator, batch_size: int,
                           n_features: int, n_masked: int) -> torch.Tensor:
    """int32 masks with exactly `n_masked` zeros per row, positions
    uniform."""
    noise = torch.rand((batch_size, n_features), generator=generator,
                       device=generator.device)
    ranks = noise.argsort(dim=-1).argsort(dim=-1)
    return (ranks >= n_masked).to(torch.int32)
