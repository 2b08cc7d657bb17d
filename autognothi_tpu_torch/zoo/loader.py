"""Base-model acquisition (port of `autognothi_tpu/zoo/loader.py`, limited
to the bases that need no download).

- `random_init` returns (None, None): the caller draws fresh parameters
  from the experiment seed.
- `ft_<name>`: a locally fine-tuned classifier stored as `params.npz` (a
  flat dict in the classifier layout) with an optional `tokenizer/`
  directory, under `$AUTOGNOTHI_ZOO/<name>` or, without that variable,
  `~/.cache/autognothi/zoo/<name>`: the JAX package's store; where that
  store lacks it, read-only from `zoo/store/<name>` inside this package,
  as the JAX loader falls back to its own (a source checkout's bundle).
- The Hugging Face hub bases (`gg_vit_*`, `bert_tayp`, `prj_bert_*`,
  `gg_bert_*`) need the hub's checkpoints and `transformers`; the port
  loads neither, so naming one raises, saying what is missing.
"""

from __future__ import annotations

import os
import pathlib
from typing import Any, Dict, Optional, Tuple

import numpy as np

_STORE = pathlib.Path(
    os.environ.get("AUTOGNOTHI_ZOO")
    or pathlib.Path.home() / ".cache" / "autognothi" / "zoo")
_PKG_STORE = pathlib.Path(__file__).parent / "store"

# the hub bases of the JAX package: name -> hub id
HUB_IDS = {
    "bert_tayp": "textattack/bert-base-uncased-yelp-polarity",
    "prj_bert_mini": "prajjwal1/bert-mini",
    "prj_bert_small": "prajjwal1/bert-small",
    "prj_bert_medium": "prajjwal1/bert-medium",
    "gg_bert_base": "google-bert/bert-base-uncased",
    "gg_bert_large": "google-bert/bert-large-uncased",
    "gg_vit_tiny": "WinKawaks/vit-tiny-patch16-224",
    "gg_vit_small": "WinKawaks/vit-small-patch16-224",
    "gg_vit_base": "google/vit-base-patch16-224",
    "gg_vit_large": "google/vit-large-patch16-224",
}


def _load_local_ft(name: str) -> Tuple[Dict[str, np.ndarray], Any]:
    store = _STORE / name
    if not (store / "params.npz").exists() and (
            _PKG_STORE / name / "params.npz").exists():
        store = _PKG_STORE / name  # read-only fallback
    if not (store / "params.npz").exists():
        raise FileNotFoundError(
            f"fine-tuned base model '{name}' not found under {_STORE / name} "
            f"(or the bundled {_PKG_STORE / name}): `pretrain_classifier` "
            f"writes it there")
    with np.load(store / "params.npz", allow_pickle=False) as data:
        params = {k: data[k] for k in data.files}
    tokenizer = None
    if (store / "tokenizer").exists():
        from ..data.tokenizer import load_tokenizer

        tokenizer = load_tokenizer(store / "tokenizer")
    return params, tokenizer


def load_params(base_model: str, num_labels: int
                ) -> Tuple[Optional[Dict[str, np.ndarray]], Any]:
    """-> (flat numpy state dict, or None for a random init; tokenizer or
    None).  `num_labels` is the hub classifiers' head width (unused by the
    bases the port loads)."""
    del num_labels
    if base_model == "random_init":
        return None, None
    if base_model.startswith("ft_"):
        return _load_local_ft(base_model)
    if base_model in HUB_IDS:
        raise NotImplementedError(
            f"base model {base_model!r} is the Hugging Face checkpoint "
            f"{HUB_IDS[base_model]!r}, loaded with `transformers`; the port "
            f"loads neither (use base_model 'random_init' or a local "
            f"'ft_*' store)")
    raise ValueError(f"unknown base model: {base_model}")
