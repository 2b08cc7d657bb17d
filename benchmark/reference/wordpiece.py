"""A plain WordPiece encoder with BERT-uncased semantics, frozen into the
benchmark: lowercase, strip accents, split on whitespace and punctuation,
greedy longest-match pieces with the `##` continuation, [CLS] ... [SEP],
truncated to the model's length and padded with [PAD].  The reference
derives the served rows' token ids with it, from the texts alone."""

from __future__ import annotations

import unicodedata
from typing import Dict, List

import numpy as np

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def basic_tokenize(text: str) -> List[str]:
    text = unicodedata.normalize("NFD", text.lower())
    out: List[str] = []
    word = ""
    for ch in text:
        cat = unicodedata.category(ch)
        if cat == "Mn":
            continue
        if ch.isspace() or cat.startswith(("P", "S")):
            if word:
                out.append(word)
                word = ""
            if not ch.isspace():
                out.append(ch)
        else:
            word += ch
    if word:
        out.append(word)
    return out


class WordPiece:
    def __init__(self, vocab: List[str]):
        self.ids: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        self.pad, self.unk, self.cls, self.sep = (
            self.ids[t] for t in ("[PAD]", "[UNK]", "[CLS]", "[SEP]"))

    def pieces(self, word: str) -> List[int]:
        if len(word) > 100:
            return [self.unk]
        out: List[int] = []
        start = 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                piece = word[start:end] if start == 0 \
                    else "##" + word[start:end]
                if piece in self.ids:
                    cur = self.ids[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            out.append(cur)
            start = end
        return out

    def encode(self, text: str, length: int) -> np.ndarray:
        ids = [self.cls]
        for word in basic_tokenize(text):
            ids.extend(self.pieces(word))
        ids = ids[:length - 1] + [self.sep]
        return np.asarray(ids + [self.pad] * (length - len(ids)),
                          dtype=np.int64)
