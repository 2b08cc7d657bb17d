"""The data adapters the BERT recipes share (port of `_null_ids` and
`_gen_input` of `autognothi_tpu/recipes/vanilla_bert.py`)."""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Tuple

import numpy as np

from ..data.tokenizer import encode_batch, load_tokenizer


@dataclasses.dataclass
class BertMisc:
    tokenizer: Any


def load_misc(m_path: pathlib.Path, cfg: Any) -> BertMisc:
    """The experiment's WordPiece vocabulary, `<exp>/tokenizer/vocab.txt`."""
    return BertMisc(tokenizer=load_tokenizer(pathlib.Path(m_path)
                                             / "tokenizer"))


def null_ids(cfg: Any, misc: BertMisc) -> np.ndarray:
    """Token ids of the empty string, padded to the model's length: <1, T>
    (`:132-135`)."""
    return encode_batch(misc.tokenizer, [""], cfg.max_position_embeddings)


def gen_input(cfg: Any, misc: BertMisc):
    """-> collate(raw_xs, raw_ys): texts -> int64 ids <B, T>, labels
    (`:210-216`)."""
    def collate(raw_xs, raw_ys) -> Tuple[np.ndarray, np.ndarray]:
        ids = encode_batch(misc.tokenizer, list(raw_xs),
                           cfg.max_position_embeddings)
        return ids, np.asarray(raw_ys, dtype=np.int64)

    return collate
