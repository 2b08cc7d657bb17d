"""The port's native WordPiece core (`autognothi_tpu_torch/native/`): the
same ids as the pure-Python path over the bundled sample set and edge
cases (empty text, non-ASCII, NUL, over-long words, unknown pieces, every
ASCII character), the library built under the git-ignored `build/` and
never beside its source, the counters of native and Python encodes, and a
failed build that is reported, not hidden.

The JAX package's copy of the core counts only C's `isspace` as
whitespace, so it splits none of the ASCII separators 0x1c-0x1f that the
Python path splits (ROADMAP F13); the port's copy counts them as Python
does, and `test_every_ascii_character_matches_python` pins both.
"""

import json
import pathlib
from unittest import mock

import numpy as np
import pytest

from autognothi_tpu_torch import native
from autognothi_tpu_torch.data import tokenizer as tok

REPO = pathlib.Path(__file__).resolve().parents[1]
SAMPLES = [s["inputs"] for s in json.loads(
    (REPO / "autognothi_tpu_torch/data/nlp_samples.json").read_text())]


@pytest.fixture(scope="module")
def tokenizer() -> tok.WordPieceTokenizer:
    return tok.WordPieceTokenizer(tok.build_vocab(SAMPLES, max_size=400))


def _python(tk, texts, length):
    return np.stack([tk.encode(t, length)[0] for t in texts])


EDGES = [
    "",
    "   ",
    "unseen words trigger subword splits!",
    "punctuation, splitting; works? (yes) -- $5.99",
    "x" * 101,                      # over-long word: [UNK]
    "a" * 100 + " b",               # exactly 100 characters: pieces
    "qqqzzz ~~~ ^^^ |||",           # pieces the vocabulary lacks
    "THE Service WAS outstanding",
    "tabs\tand\nnewlines\r\x0b\x0cend",
    "the service was outstanding " * 20,  # truncated
]


@pytest.mark.parametrize("length", [8, 32, 512])
def test_native_ids_match_python(tokenizer, length):
    texts = SAMPLES + EDGES
    got = tokenizer.encode_batch_native(texts, length)
    assert got is not None, native.build_errors
    assert got.dtype == np.int64 and got.shape == (len(texts), length)
    np.testing.assert_array_equal(got, _python(tokenizer, texts, length))


def test_every_ascii_character_matches_python(tokenizer):
    """Each ASCII character but NUL inside and around a word; the JAX
    package's core differs at 0x1c-0x1f (F13)."""
    from autognothi_tpu.data.tokenizer import \
        WordPieceTokenizer as JaxTokenizer

    texts = [f"ab{chr(i)}cd {chr(i)}x" for i in range(1, 128)]
    got = tokenizer.encode_batch_native(texts, 16)
    np.testing.assert_array_equal(got, _python(tokenizer, texts, 16))
    jax_core = JaxTokenizer(tokenizer.vocab).encode_batch_native(texts, 16)
    if jax_core is None:
        pytest.skip("the JAX package's core did not build on this host")
    differs = [i + 1 for i in range(len(texts))
               if not np.array_equal(jax_core[i], got[i])]
    assert differs == [0x1c, 0x1d, 0x1e, 0x1f]


def test_fallbacks_give_the_python_ids(tokenizer):
    for text in ("café au lait", "evil\x00text"):
        assert tokenizer.encode_batch_native([text, "plain"], 16) is None
        tok.reset_encodes()
        out = tok.encode_batch(tokenizer, [text, "plain"], 16)
        np.testing.assert_array_equal(
            out, _python(tokenizer, [text, "plain"], 16))
        assert tok.ENCODES == {"native": 0, "python": 2}


def test_counters(tokenizer):
    tok.reset_encodes()
    tok.encode_batch(tokenizer, SAMPLES[:5], 32)
    tok.encode_batch(tokenizer, ["ümlaut"], 32)
    assert tok.ENCODES == {"native": 5, "python": 1}
    tok.reset_encodes()
    assert tok.ENCODES == {"native": 0, "python": 0}


def test_library_lies_under_build_never_beside_the_source(tokenizer):
    assert tokenizer.encode_batch_native(["x"], 4) is not None
    lib = native.library_path("wordpiece")
    assert lib.exists()
    assert lib.parent.parent == REPO / "build" / "native"
    assert not list(native.HERE.glob("*.so"))
    # only sources beside the loader: the WordPiece and the image cores
    assert sorted(p.name for p in native.HERE.iterdir()
                  if p.suffix != ".pyc" and p.name != "__pycache__") == \
        ["__init__.py", "imageproc.cpp", "wordpiece.cpp"]
    # the build is keyed by the source: another source, another directory
    with mock.patch.object(native, "FLAGS", native.FLAGS + ("-g",)):
        assert native.library_path("wordpiece") != lib


def test_a_failed_build_is_reported_once_and_the_python_path_runs(
        tokenizer, capsys):
    def broken(stem):
        raise RuntimeError("g++ exit 1\nwordpiece.cpp:1: error: broken")

    with mock.patch.dict(native._libs, clear=True), \
            mock.patch.object(native, "_build", broken), \
            mock.patch.dict(native.build_errors, clear=True):
        fresh = tok.WordPieceTokenizer(tokenizer.vocab)
        assert fresh.encode_batch_native(["plain"], 8) is None
        assert fresh.encode_batch_native(["plain"], 8) is None
        tok.reset_encodes()
        out = tok.encode_batch(fresh, ["plain text"], 8)
        assert tok.ENCODES == {"native": 0, "python": 1}
        assert "error: broken" in native.build_errors["wordpiece"]
    err = capsys.readouterr().err
    assert err.count("the wordpiece core is unavailable") == 1
    assert "error: broken" in err
    np.testing.assert_array_equal(out, _python(tokenizer, ["plain text"], 8))
