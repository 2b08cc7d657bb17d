"""KernelSHAP without the `shap` dependency (a copy of the numpy module
`autognothi_tpu/ops/kernel_shap.py`; the port imports nothing of the JAX
package).

- `kmeans_compress`: k-means over the raw training rows, centroids snapped
  per column to the nearest observed value (so token ids stay valid ids),
  weights = cluster sizes, the behaviour of `shap.kmeans`.  The recipe
  passes UNIFORM background weights to `kernel_shap` instead of these
  cluster sizes, as the reference hands KernelExplainer a bare background
  array.
- `kernel_shap`: the weighted-least-squares Shapley estimator: coalitions
  drawn from the Shapley kernel over sizes (the small sizes enumerated
  while the budget allows, sampled after), masked inputs composed as
  x*z + background*(1-z), model outputs pushed through the logit link,
  and the constrained WLS solved in closed form by eliminating the last
  player (sum phi = g(f(x)) - g(f_null)).

The model callback takes the whole coalition x background sweep at once;
the recipe runs it in fixed-shape slabs on the device.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, List, Tuple

import numpy as np

__all__ = ["kmeans_compress", "kernel_shap"]


def kmeans_compress(
    data: np.ndarray, k: int, rounds: int = 10, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (centroids <k, M> snapped to observed column values, weights <k>)."""
    rng = np.random.RandomState(seed)
    data_f = data.astype(np.float64)
    n = data_f.shape[0]
    k = min(k, n)
    centers = data_f[rng.choice(n, k, replace=False)]
    labels = np.zeros(n, dtype=np.int64)
    for _ in range(rounds):
        dists = ((data_f[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        labels = dists.argmin(axis=1)
        for j in range(k):
            member = data_f[labels == j]
            if len(member):
                centers[j] = member.mean(axis=0)
    # snap each coordinate to the nearest observed value in that column
    for col in range(data_f.shape[1]):
        values = np.unique(data_f[:, col])
        idx = np.abs(values[None, :] - centers[:, [col]]).argmin(axis=1)
        centers[:, col] = values[idx]
    weights = np.bincount(labels, minlength=k).astype(np.float64)
    return centers.astype(data.dtype), weights


def _logit(p: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    p = np.clip(p, eps, 1 - eps)
    return np.log(p / (1 - p))


def _sample_coalitions(
    m: int, n_samples: int, rng: np.random.RandomState
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (coalitions <n, m> of 0/1, kernel weights <n>), following the
    enumerate-small-sizes-then-sample allocation of KernelExplainer."""
    n_samples = max(n_samples, 2)
    sizes = list(range(1, m))
    # kernel weight per size (shared across its coalitions)
    size_w = np.array([(m - 1) / (s * (m - s)) for s in sizes])
    size_w /= size_w.sum()

    rows: List[np.ndarray] = []
    weights: List[float] = []
    remaining = n_samples
    remaining_w = 1.0
    # enumerate sizes from both ends simultaneously: s and its complement
    # m-s.  Stop at m//2 so each size is visited exactly ONCE — going one
    # further (the shap bound is ceil((M-1)/2) = m//2) re-enumerates
    # already-covered sizes for odd m, duplicating their rows and doubling
    # their total WLS weight (biased phi) while burning budget
    half = m // 2
    enumerated = set()
    for s in range(1, half + 1):
        paired = (s != m - s) and (m - s) <= m - 1
        count = math.comb(m, s) * (2 if paired else 1)
        if count > remaining:
            break
        for combo in itertools.combinations(range(m), s):
            z = np.zeros(m, dtype=np.int64)
            z[list(combo)] = 1
            rows.append(z)
            weights.append(size_w[s - 1] / math.comb(m, s))
            if paired:
                rows.append(1 - z)
                weights.append(size_w[m - s - 1] / math.comb(m, m - s))
        enumerated.add(s)
        if paired:
            enumerated.add(m - s)
        remaining -= count
        remaining_w -= size_w[s - 1] + (size_w[m - s - 1] if paired else 0.0)
        if remaining <= 0:
            break

    left_sizes = [s for s in sizes if s not in enumerated]
    if left_sizes and remaining > 0:
        lw = np.array([size_w[s - 1] for s in left_sizes])
        lw /= lw.sum()
        picked = rng.choice(len(left_sizes), size=remaining, p=lw)
        per_sample_w = max(remaining_w, 1e-12) / remaining
        for pick in picked:
            s = left_sizes[pick]
            z = np.zeros(m, dtype=np.int64)
            z[rng.choice(m, s, replace=False)] = 1
            rows.append(z)
            weights.append(per_sample_w)

    return np.stack(rows), np.asarray(weights, dtype=np.float64)


def kernel_shap(
    fn: Callable[[np.ndarray], np.ndarray],  # <n, M> rows -> <n, C> probs
    background: np.ndarray,  # <k, M>
    bg_weights: np.ndarray,  # <k>
    x: np.ndarray,  # <M>
    n_samples: int,
    seed: int = 0,
) -> np.ndarray:
    """-> <C, M> per-class Shapley values under the logit link."""
    rng = np.random.RandomState(seed)
    m = x.shape[0]
    bw = bg_weights / bg_weights.sum()

    f_null = (fn(background) * bw[:, None]).sum(axis=0)  # <C>
    f_x = fn(x[None])[0]  # <C>
    phi0 = _logit(f_null)
    total = _logit(f_x) - phi0  # <C>

    if m == 1:
        # single player: no proper coalitions exist — the efficiency
        # constraint alone determines phi (the whole logit difference)
        return total[:, None]

    coalitions, kernel_w = _sample_coalitions(m, n_samples, rng)
    n_coal = coalitions.shape[0]
    k = background.shape[0]

    # compose masked inputs: x where z=1, background row where z=0
    z_exp = np.repeat(coalitions, k, axis=0)  # <n*k, M>
    bg_exp = np.tile(background, (n_coal, 1))
    samples = np.where(z_exp == 1, x[None, :], bg_exp)
    outs = fn(samples).reshape(n_coal, k, -1)  # <n, k, C>
    ey = (outs * bw[None, :, None]).sum(axis=1)  # <n, C>
    ey_adj = _logit(ey) - phi0[None, :]  # <n, C>

    # constrained WLS: eliminate the last player
    z = coalitions.astype(np.float64)
    ey_adj2 = ey_adj - z[:, [-1]] * total[None, :]
    etmp = z[:, :-1] - z[:, [-1]]
    wtmp = etmp * kernel_w[:, None]
    lhs = etmp.T @ wtmp  # <M-1, M-1>
    rhs = wtmp.T @ ey_adj2  # <M-1, C>
    phi_head = np.linalg.lstsq(lhs, rhs, rcond=None)[0]  # <M-1, C>
    phi_last = total[None, :] - phi_head.sum(axis=0, keepdims=True)
    phi = np.concatenate([phi_head, phi_last], axis=0)  # <M, C>
    return phi.T  # <C, M>
