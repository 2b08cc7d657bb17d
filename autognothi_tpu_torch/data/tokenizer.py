"""WordPiece tokenizer, BERT-uncased semantics (port of
`autognothi_tpu/data/tokenizer.py`).

Reads `<experiment>/tokenizer/vocab.txt`: lowercasing, accent stripping,
whitespace and punctuation splitting, greedy longest-match WordPiece with
the `##` continuation, [CLS] ... [SEP] framing, padded or truncated to the
model's length.  `encode_batch` runs the native C++ core
(`native/wordpiece.cpp`, built at first use) where every text is ASCII
without a NUL, and this pure-Python algorithm otherwise; both give the
same ids, and `ENCODES` counts the texts each path encoded.  The JAX
package may also load a Hugging Face tokenizer; the port does not (the
machine with the card has no `transformers`).  `build_vocab` derives a
vocabulary from a corpus.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
import unicodedata
from collections import Counter
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MASK]

# texts encoded by each path of `encode_batch` in this process
ENCODES = {"native": 0, "python": 0}
_encodes_lock = threading.Lock()


def _count(path: str, n: int) -> None:
    with _encodes_lock:
        ENCODES[path] += n


def reset_encodes() -> None:
    with _encodes_lock:
        for k in ENCODES:
            ENCODES[k] = 0


def _basic_tokenize(text: str) -> List[str]:
    """Lowercase, strip accents, split on whitespace and punctuation."""
    text = unicodedata.normalize("NFD", text.lower())
    out: List[str] = []
    word = ""
    for ch in text:
        cat = unicodedata.category(ch)
        if cat == "Mn":  # accent
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


class WordPieceTokenizer:
    def __init__(self, vocab: List[str]):
        self.vocab = list(vocab)
        self.token_to_id: Dict[str, int] = {t: i for i, t in
                                            enumerate(self.vocab)}
        for sp in SPECIALS:
            if sp not in self.token_to_id:
                raise ValueError(f"vocab missing special token {sp}")
        self.pad_id = self.token_to_id[PAD]
        self.unk_id = self.token_to_id[UNK]
        self.cls_id = self.token_to_id[CLS]
        self.sep_id = self.token_to_id[SEP]
        self._native = None
        self._native_handle = None

    def _native_tokenizer(self) -> Optional[int]:
        """The C++ core's handle for this vocabulary, built and loaded at
        first use; None where the core is unavailable."""
        if self._native is not None:
            return self._native_handle
        from ..native import build_and_load

        self._native = build_and_load("wordpiece") or False
        if self._native:
            lib = self._native
            lib.wp_create.restype = ctypes.c_void_p
            lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.wp_encode_batch.restype = ctypes.c_int64
            lib.wp_encode_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.wp_destroy.argtypes = [ctypes.c_void_p]
            blob = "\n".join(self.vocab).encode("utf-8")
            self._native_handle = lib.wp_create(blob, len(blob)) or None
        return self._native_handle

    def encode_batch_native(self, texts: List[str],
                            max_length: int) -> Optional[np.ndarray]:
        """The C++ batch encode -> ids <B, max_length> int64; None where
        the core is unavailable, a text is not ASCII (the Python path
        strips accents, which ASCII never needs) or holds a NUL (the
        record separator of the wire blob), or the core encoded fewer
        texts than asked (`:66-112` of the JAX module)."""
        if not all(t.isascii() and "\x00" not in t for t in texts):
            return None
        handle = self._native_tokenizer()
        if handle is None:
            return None
        blob = b"\x00".join(t.encode() for t in texts) + b"\x00"
        out = np.empty((len(texts), max_length), dtype=np.int64)
        got = self._native.wp_encode_batch(
            handle, blob, len(blob), len(texts), max_length,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out if got == len(texts) else None

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def all_special_ids(self) -> List[int]:
        return [self.token_to_id[t] for t in SPECIALS]

    def decode(self, token_id: int) -> str:
        """One id -> its vocabulary entry (a `##` piece keeps its `##`)."""
        return self.vocab[int(token_id)]

    @classmethod
    def load(cls, path: pathlib.Path) -> "WordPieceTokenizer":
        path = pathlib.Path(path)
        vocab_file = path / "vocab.txt" if path.is_dir() else path
        with open(vocab_file, "r", encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        return cls(vocab)

    def save(self, path: pathlib.Path) -> None:
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        with open(path / "vocab.txt", "w", encoding="utf-8") as f:
            f.write("\n".join(self.vocab) + "\n")

    def _wordpiece(self, word: str, max_chars: int = 100) -> List[int]:
        if len(word) > max_chars:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur: Optional[int] = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.token_to_id:
                    cur = self.token_to_id[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str,
               max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (input_ids <max_length>, attention_mask <max_length>):
        [CLS] ... [SEP], truncated to max_length, then padded."""
        ids: List[int] = [self.cls_id]
        for word in _basic_tokenize(text):
            ids.extend(self._wordpiece(word))
        ids = ids[:max_length - 1]
        ids.append(self.sep_id)
        attn = [1] * len(ids) + [0] * (max_length - len(ids))
        ids += [self.pad_id] * (max_length - len(ids))
        return (np.asarray(ids, dtype=np.int64),
                np.asarray(attn, dtype=np.int64))


def build_vocab(texts: Iterable[str], max_size: int = 2000) -> List[str]:
    """Specials, then every character and its `##` piece, then whole words
    by falling count (ties by spelling) up to max_size."""
    words: Counter = Counter()
    for text in texts:
        words.update(_basic_tokenize(text))
    vocab: List[str] = list(SPECIALS)
    seen = set(vocab)
    for ch in sorted({ch for w in words for ch in w}):
        for piece in (ch, f"##{ch}"):
            if piece not in seen:
                vocab.append(piece)
                seen.add(piece)
    for w, _n in sorted(words.items(), key=lambda kv: (-kv[1], kv[0])):
        if len(vocab) >= max_size:
            break
        if w not in seen:
            vocab.append(w)
            seen.add(w)
    return vocab


def load_tokenizer(path: pathlib.Path) -> WordPieceTokenizer:
    """The WordPiece tokenizer of a directory holding `vocab.txt`."""
    return WordPieceTokenizer.load(path)


def encode_batch(tokenizer: WordPieceTokenizer, texts: List[str],
                 max_length: int) -> np.ndarray:
    """-> input_ids <B, max_length> int64: the native core where it takes
    the batch, else the Python path (the same ids)."""
    texts = list(texts)
    native = tokenizer.encode_batch_native(texts, max_length)
    if native is not None:
        _count("native", len(texts))
        return native
    _count("python", len(texts))
    return np.stack([tokenizer.encode(t, max_length)[0] for t in texts])
