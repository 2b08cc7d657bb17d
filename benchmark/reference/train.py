"""Plain reference of the explainer train step of AutoGnothi (FastSHAP's
Shapley regression on a ladder-side-tuned explainer):

    v_s  = surrogate(x masked by each of the M coalitions)   (no gradient)
    v_1  = surrogate(x with every player on)                  (no gradient)
    phi  = explainer(x), normalised so each class sums to v_1 - null
    loss = P * mean over (b, m, c) of (null + mask . phi - v_s)^2
    AdamW on the explainer's parameters outside the frozen trunk
         (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-2, decoupled)

The teacher runs in the arithmetic the configuration states for it
(`bits`), the explainer in float32; gradients by autograd.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-2


def shapley_masks(gen: torch.Generator, b: int, m: int, players: int,
                  device) -> torch.Tensor:
    """<b, m, players> int32 coalitions: sizes from the Shapley kernel
    p(k) ~ 1/(k(n-k)), k = 1..n-1, each mask followed by its complement."""
    k = torch.arange(1, players, dtype=torch.float32, device=device)
    probs = 1.0 / (k * (players - k))
    size = torch.multinomial(probs / probs.sum(), b * m // 2,
                             replacement=True, generator=gen)
    noise = torch.rand((b * m // 2, players), generator=gen, device=device)
    # the first `size + 1` players of a random order are on
    order = noise.argsort(dim=1).argsort(dim=1)
    masks = (order <= size[:, None]).to(torch.int32)
    return torch.stack([masks, 1 - masks], dim=1).reshape(b, m, players)


def shapley_loss(masks: torch.Tensor, null: torch.Tensor, v_s: torch.Tensor,
                 phi: torch.Tensor) -> torch.Tensor:
    b, m, players = masks.shape
    approx = null.reshape(1, 1, -1) + torch.einsum(
        "bmp,bcp->bmc", masks.float(), phi)
    return players * (approx.reshape(b * m, -1) - v_s).square().mean()


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor]):
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], lr: float) -> None:
        b1, b2 = BETAS
        self.count += 1
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[k].mul_(b2).add_(g * g, alpha=1 - b2)
            upd = (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + EPS)
            p.add_(-lr * (upd + WEIGHT_DECAY * p))


@torch.no_grad()
def teacher_values(ref, cfg: dict, srg: Dict[str, torch.Tensor],
                   pixels: torch.Tensor, masks: torch.Tensor,
                   bits: Optional[int], chunk: int) -> tuple:
    """The teacher of one step -> (v_s <B*M, C>, v_1 <B, C>), `chunk`
    images a block."""
    v_s = torch.cat([
        ref.surrogate_values(srg, cfg, pixels[i:i + chunk],
                             masks[i:i + chunk], bits)
        for i in range(0, len(pixels), chunk)])
    ones = masks.new_ones((masks.shape[0], 1, masks.shape[2]))
    return v_s, ref.surrogate_values(srg, cfg, pixels, ones, bits)


def steps(ref, cfg: dict, srg: Dict[str, torch.Tensor],
          exp: Dict[str, torch.Tensor], trainable: List[str],
          null: torch.Tensor, batches: List[tuple], lr: float,
          teacher_bits: Optional[int], chunk: int,
          explainer_scope: Callable = None,
          loss_fn: Callable = None, teacher: List[tuple] = None) -> dict:
    """Follow the step over `batches` [(pixels, masks)] from the weights
    `exp` (not modified) -> losses, the first step's gradients, the
    trained parameters after the last step and each step's teacher values.
    `explainer_scope` and `loss_fn` let a control or a fault replace the
    explainer's arithmetic or the loss; `teacher` [(v_s, v_1)], where
    given, takes the reference teacher's place, so that the explainer's
    stage is followed alone on given teacher values."""
    import contextlib

    scope = explainer_scope or contextlib.nullcontext
    params = {k: v.detach().clone() for k, v in exp.items()}
    live = {k: params[k].requires_grad_(True) for k in trainable}
    opt = AdamW(live)
    losses, first_grads, taught = [], None, []
    for i, (pixels, masks) in enumerate(batches):
        v_s, v_1 = teacher[i] if teacher is not None else teacher_values(
            ref, cfg, srg, pixels, masks, teacher_bits, chunk)
        taught.append((v_s, v_1))
        with scope():
            phi = ref.explainer_values(params, cfg, pixels, v_1, null)
            loss = (loss_fn or shapley_loss)(masks, null, v_s, phi)
        grads = torch.autograd.grad(loss, list(live.values()))
        grads = dict(zip(live, grads))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        opt.update(live, grads, lr)
        losses.append(loss.item())
    return {"losses": losses, "grads": first_grads,
            "params": {k: v.detach() for k, v in live.items()},
            "teacher": taught}


def half_batch_loss(masks, null, v_s, phi) -> torch.Tensor:
    """A fault: half of the batch left out, the mean taken over the rest."""
    half = masks.shape[0] // 2
    return shapley_loss(masks[:half], null, v_s[:half * masks.shape[1]],
                        phi[:half])


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             keep: List[str]) -> tuple:
    """The worst leaf's gap of norms: |‖got‖ - ‖want‖| over the larger of
    ‖want‖ and the median leaf's ‖want‖ -> (gap, its leaf)."""
    norms = {k: float(want[k].norm()) for k in keep}
    median = sorted(norms.values())[len(norms) // 2]
    worst = (0.0, "")
    for k in keep:
        gap = abs(float(got[k].norm()) - norms[k]) / max(norms[k], median)
        worst = max(worst, (gap, k))
    return worst


def leaf_diff(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep: List[str]) -> tuple:
    """The worst leaf's norm of the difference, ‖got - want‖, over the
    larger of ‖want‖ and the median leaf's ‖want‖ -> (gap, its leaf)."""
    norms = {k: float(want[k].norm()) for k in keep}
    median = sorted(norms.values())[len(norms) // 2]
    worst = (0.0, "")
    for k in keep:
        gap = float((got[k] - want[k]).norm()) / max(norms[k], median)
        worst = max(worst, (gap, k))
    return worst


def median_leaf_gap(got, want, keep: List[str]) -> float:
    """The median over leaves of the same gap of norms."""
    norms = {k: float(want[k].norm()) for k in keep}
    median = sorted(norms.values())[len(norms) // 2]
    gaps = sorted(abs(float(got[k].norm()) - norms[k]) / max(norms[k], median)
                  for k in keep)
    return gaps[len(gaps) // 2]
