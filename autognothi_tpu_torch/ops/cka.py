"""Centered Kernel Alignment (linear and RBF) between representation batches
(port of `autognothi_tpu/ops/cka.py`).

Per batch item, on <heads, features> matrices: HSIC is sum(centering(Kx) *
centering(Ky)), the double centering written as mean subtractions (H K H =
K - row_mean - col_mean + grand_mean); the RBF bandwidth defaults to
sigma^2 = the lower-middle median of the nonzero pairwise squared
distances (torch.median's element for an even count).  The items are a
batch dimension (JAX `vmap`s a per-item function).  Plain tensor math:
the JAX package has no kernel here either.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["linear_cka", "kernel_cka"]


def _center(gram: torch.Tensor) -> torch.Tensor:
    """<B, n, n> -> each item's gram matrix double-centered."""
    row = gram.mean(dim=-2, keepdim=True)
    col = gram.mean(dim=-1, keepdim=True)
    grand = gram.mean(dim=(-2, -1), keepdim=True)
    return gram - row - col + grand


def _hsic(kx: torch.Tensor, ky: torch.Tensor) -> torch.Tensor:
    return (_center(kx) * _center(ky)).sum(dim=(-2, -1))


def _gram(x: torch.Tensor) -> torch.Tensor:
    return x @ x.transpose(-1, -2)


def _rbf(x: torch.Tensor, sigma: Optional[float]) -> torch.Tensor:
    gram = _gram(x)
    diag = torch.diagonal(gram, dim1=-2, dim2=-1)
    sq_dist = (diag[..., :, None] - gram) + (diag[..., None, :] - gram)
    if sigma is None:
        flat = sq_dist.reshape(sq_dist.shape[0], -1)
        nonzero = flat != 0
        # median over the nonzero entries: zeros sort last as +inf
        ordered = torch.sort(torch.where(nonzero, flat,
                                         torch.full_like(flat, torch.inf)),
                             dim=-1).values
        count = nonzero.sum(dim=-1)
        mid = torch.clamp((count - 1) // 2, 0, flat.shape[-1] - 1)
        sig_sq = ordered.gather(-1, mid[:, None])[:, :, None]
    else:
        sig_sq = torch.tensor(sigma, dtype=x.dtype, device=x.device) ** 2
    return torch.exp(sq_dist * (-0.5 / sig_sq))


def linear_cka(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<batch, heads, a> cka <batch, heads, b> -> <batch>."""
    kx, ky = _gram(x), _gram(y)
    return _hsic(kx, ky) / (torch.sqrt(_hsic(kx, kx))
                            * torch.sqrt(_hsic(ky, ky)))


def kernel_cka(x: torch.Tensor, y: torch.Tensor,
               sigma: Optional[float] = None) -> torch.Tensor:
    """RBF-kernel CKA per batch item -> <batch>."""
    kx, ky = _rbf(x, sigma), _rbf(y, sigma)
    return _hsic(kx, ky) / (torch.sqrt(_hsic(kx, kx))
                            * torch.sqrt(_hsic(ky, ky)))
