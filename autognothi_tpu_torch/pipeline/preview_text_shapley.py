"""Monte-Carlo permutation Shapley values of the surrogate, printed per
token beside the text (port of `autognothi_tpu/pipeline/
preview_text_shapley.py`).

    python -m autognothi_tpu_torch __preview_text_shapley__ <experiment_dir> \\
        [--dataset KIND] --device cuda

Each repetition walks one random permutation of the players: its P + 1
cumulative coalitions (row s holds the first s players of the
permutation) go through the surrogate as one coalition batch
(`recipe.fw_surrogate_coalitions`, else the input repeated along the
batch), in slabs of at most `slab` rows, and each player's marginal
contribution to the sharpened value v = log(p / (1 - p + 1e-6)) of the
re-softmaxed output is scattered back to it.  The permutations of test
sample i are drawn from a `torch.Generator` seeded with
`derive_seed(config.seed, "preview_text_shapley[sample=i]")`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..data.loader import DatasetLoader
from ..recipes.types import surrogate_coalition_values
from ..utils.devices import resolve_device
from ..utils.seeding import iterative_generator
from .env import ExpEnv
from .resources import get_recipe, load_cfg_dataset, load_epoch_model, load_misc
from .run_text_explanation import (print_label, print_text_attr,
                                   real_tokenize_text)

SLAB_ROWS = 128  # coalition rows per surrogate call


def coalition_values(recipe, m_config, srg_model, xs: torch.Tensor,
                     masks: torch.Tensor, slab: int = SLAB_ROWS
                     ) -> torch.Tensor:
    """The surrogate on xs <1, ...> under each coalition of masks <N, P>
    -> <N, C>, `slab` rows a call."""
    return torch.cat([
        surrogate_coalition_values(recipe, m_config, srg_model, xs,
                                   masks[None, a:a + slab])
        for a in range(0, masks.shape[0], slab)]).float()


def montecarlo_shapley(recipe, m_config, srg_model, xs: torch.Tensor,
                       perms: torch.Tensor, slab: int = SLAB_ROWS
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """xs <1, ...>, perms <reps, P> (each a permutation of the players) ->
    (sv <C, P>, v0 <C> and vN <C> of the last repetition)."""
    reps, n_players = perms.shape
    steps = torch.arange(n_players + 1, device=xs.device)[:, None]
    sv = None
    for perm in perms.to(xs.device):
        order_pos = torch.argsort(perm)  # player -> position in perm
        masks = (order_pos[None, :] < steps).to(torch.int32)  # <P+1, P>
        probs = coalition_values(recipe, m_config, srg_model, xs, masks,
                                 slab)
        p = torch.softmax(probs, dim=1)
        v = torch.log(p / (1 - p + 1e-6))  # <P+1, C>
        d = torch.zeros_like(v[1:])
        d[perm] = v[1:] - v[:-1]  # marginal contributions, by player
        sv = d if sv is None else sv + d
    sv = sv / reps
    return (sv.T.cpu().numpy(), v[0].cpu().numpy(), v[-1].cpu().numpy())


def draw_permutations(seed: int, sample: int, reps: int,
                      n_players: int) -> torch.Tensor:
    """The `reps` permutations of test sample `sample` <reps, P>."""
    gen = iterative_generator(seed, f"preview_text_shapley[sample={sample}]")
    return torch.stack([torch.randperm(n_players, generator=gen)
                        for _ in range(reps)])


def preview_text_shapley(env: ExpEnv,
                         d_loader: Optional[DatasetLoader] = None,
                         reps: int = 8, device: str = "cuda") -> None:
    config = env.config
    recipe, m_config = get_recipe(config)
    dev = resolve_device(device)
    if d_loader is None:
        d_loader = load_cfg_dataset(config.dataset)

    _, srg_model = load_epoch_model(env, recipe, "surrogate", dev)
    m_misc = load_misc(env, recipe, m_config)
    gen_input = recipe.gen_input(m_config, m_misc)
    n_players = recipe.n_players(m_config)

    for i, (_inputs, _targets) in enumerate(d_loader.test(1)):
        xs, zs = gen_input(_inputs, _targets)
        perms = draw_permutations(config.seed, i, reps, n_players)
        with torch.inference_mode():
            sv, _v0, _vn = montecarlo_shapley(
                recipe, m_config, srg_model,
                torch.from_numpy(xs[:1]).to(dev), perms)
        tokens = real_tokenize_text([int(t) for t in xs[0]],
                                    m_misc.tokenizer)
        label = int(np.asarray(zs)[0])
        for cls in range(min(2, sv.shape[0])):
            pairs = [(w, float(sv[cls, idx])) for idx, w in tokens
                     if idx < sv.shape[1]]
            print_label(cls, label)
            print_text_attr(pairs)
            print("")
        print("")
