"""What both serving drivers share: the served final built from the seed,
the text generator of the text models, the sample of answers kept for the
comparison, and the comparison itself.

The final's weights are drawn on the device (`weights.py`) under the
checkpoint names and written as the program's npz checkpoint into an
experiment directory under TMPDIR, which the program's `ExplainService`
loads as a deployment would; the directory is removed when the run ends.
The benchmark keeps its own copy of the weights for the reference."""

from __future__ import annotations

import json
import math
import pathlib
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import core, weights
from .reference import common as ref_common

# the seed of the text models' vocabulary: a property of the deployment,
# the same in every run
VOCAB_SEED = 20260
LETTERS = "abcdefghijklmnopqrstuvwxyz"
PUNCT = [",", ".", "!", "?", ";", "'"]


class Served:
    """The program's service for one run, and the benchmark's weights."""

    def __init__(self, run: core.Run):
        from autognothi_tpu_torch import RECIPE_VERSION
        from autognothi_tpu_torch.pipeline.env import ExpEnv
        from autognothi_tpu_torch.pipeline.serve import ExplainService

        self.run = run
        cell = run.cell
        self.ref = core.module("reference", cell.family)
        self.params = weights.make(self.ref.param_specs(cell.model, "final"),
                                   run.seed, run.device)
        self._tmp = tempfile.TemporaryDirectory(prefix="bench_exp_")
        exp = pathlib.Path(self._tmp.name)
        (exp / ".hparams.json").write_text(json.dumps({
            "seed": 0, "net": {"kind": cell.family, "version": RECIPE_VERSION,
                               "params": cell.model}}))
        self.words: Optional[List[str]] = None
        if cell.config.get("vocab_words"):
            self.words, vocab = make_vocab(cell.config["vocab_words"],
                                           cell.model["vocab_size"])
            (exp / "tokenizer").mkdir()
            (exp / "tokenizer" / "vocab.txt").write_text("\n".join(vocab)
                                                         + "\n")
            self.vocab = vocab
        t0 = time.perf_counter()
        self.ckpt_bytes = weights.to_npz(self.params,
                                         exp / "final-epoch-0.ckpt")
        run.log(f"final: {len(self.params)} tensors, "
                f"{sum(p.numel() for p in self.params.values())} parameters,"
                f" {self.ckpt_bytes} bytes written in "
                f"{time.perf_counter() - t0:.2f} s")
        self.env = ExpEnv(exp)
        self.batch = int(cell.spec["serve"]["batch_size"])
        self.service = ExplainService(self.env, self.batch,
                                      device=str(run.device))
        self.service.warmup()

    def batcher_counts(self) -> dict:
        b = self.service._batcher
        return {"rows": b.row_count, "slabs": b.slab_count,
                "requests": b.request_count}

    def close(self) -> None:
        """Drain and free the program's side; the weights stay."""
        if self.service is not None:
            self.service.close()
            self.service = None
            self.env.close()
        self._tmp.cleanup()


def make_vocab(n_words: int, max_size: int):
    """The deployment's word list and WordPiece vocabulary: specials, every
    letter and its `##` piece, the punctuation, then the words; at most
    `max_size` entries."""
    rng = np.random.default_rng(VOCAB_SEED)
    lengths = rng.integers(2, 11, size=n_words)
    letters = rng.integers(0, 26, size=int(lengths.sum()))
    words, at = [], 0
    for n in lengths:
        words.append("".join(LETTERS[i] for i in letters[at:at + n]))
        at += n
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += [c for ch in LETTERS for c in (ch, "##" + ch)] + PUNCT
    seen = set(vocab)
    for w in words:
        if len(vocab) >= max_size:
            break
        if w not in seen:
            vocab.append(w)
            seen.add(w)
    return [w for w in words if w in seen], vocab


def make_text(rng: np.random.Generator, words: List[str], n: int) -> str:
    """n words: Zipf-ranked vocabulary words, one in ten a fresh letter
    string that the vocabulary splits into pieces, punctuation now and
    then, some capitals."""
    ranks = np.minimum(rng.zipf(1.2, size=n), len(words)) - 1
    fresh = rng.random(n) < 0.1
    out = []
    for i in range(n):
        if fresh[i]:
            w = "".join(rng.choice(list(LETTERS), size=rng.integers(3, 13)))
        else:
            w = words[ranks[i]]
        if rng.random() < 0.05:
            w = w.capitalize()
        out.append(w)
        if rng.random() < 0.08:
            out.append(PUNCT[rng.integers(len(PUNCT))])
    return " ".join(out)


def fixed_draws(mix_seed: int, n: int, law: dict) -> np.ndarray:
    """n draws of a mix's law from the mix's own seed: the same multiset in
    every run, which the run's seed only reorders."""
    rng = np.random.default_rng(mix_seed)
    kind = law["law"]
    if kind == "log_uniform_int":
        x = np.exp(rng.uniform(math.log(law["min"]),
                               math.log(law["max"] + 1), size=n))
        return np.clip(np.floor(x), law["min"], law["max"]).astype(np.int64)
    if kind == "uniform_int":
        return rng.integers(law["min"], law["max"] + 1, size=n)
    if kind == "lognormal_int":
        x = rng.lognormal(math.log(law["median"]), law["sigma"], size=n)
        return np.clip(np.rint(x), law["min"], law["max"]).astype(np.int64)
    if kind == "exponential":
        return rng.exponential(law["mean"], size=n)
    raise ValueError(f"unknown law {kind!r}")


class Sample:
    """The answers kept for the comparison: each answered request with
    probability `p` drawn from the seed, and the first of the largest
    size, up to `max_rows` rows."""

    def __init__(self, seed: int, p: float, max_rows: int, largest: int):
        self._rng = np.random.default_rng([seed, 7])
        self.p, self.max_rows, self.largest = p, max_rows, largest
        self.kept: List[dict] = []
        self.rows = 0
        self._have_largest = False
        self._lock = threading.Lock()

    def offer(self, inputs, response: dict) -> None:
        n = len(response["logits"])
        with self._lock:
            take = self._rng.random() < self.p
            if n >= self.largest and not self._have_largest:
                take, self._have_largest = True, True
            if not take or self.rows + n > self.max_rows:
                return
            self.rows += n
            self.kept.append({
                "inputs": inputs,
                "logits": np.asarray(response["logits"], np.float32),
                "attributions": np.asarray(response["attributions"],
                                           np.float32)})


def compare(served_probs: np.ndarray, served_attr: np.ndarray,
            ref_probs: torch.Tensor, ref_attr: torch.Tensor) -> Dict:
    """-> the widest gaps: of a class probability, and of an attribution
    as a share of its row's largest reference attribution."""
    rp, ra = ref_probs.float().cpu().numpy(), ref_attr.float().cpu().numpy()
    prob_gap = float(np.abs(served_probs - rp).max())
    scale = np.abs(ra).reshape(len(ra), -1).max(axis=1)
    row_gap = np.abs(served_attr - ra).reshape(len(ra), -1).max(axis=1)
    return {"prob_gap": prob_gap,
            "attr_gap": float((row_gap / np.maximum(scale, 1e-30)).max())}


def reference_outputs(run: core.Run, params, fn, inputs: List,
                      chunk: int, tf32: bool = False, **kw):
    """The reference over the kept rows in chunks, after the program's
    state is freed -> (probs, attributions) as stacked tensors."""
    probs, attrs = [], []
    with torch.no_grad(), ref_common.float32_matmuls(tf32):
        for i in range(0, len(inputs), chunk):
            p, a = fn(params, run.cell.model, inputs[i:i + chunk], **kw)
            probs.append(p.cpu())
            attrs.append(a.cpu())
    return torch.cat(probs), torch.cat(attrs)


def checks_from(gaps: Dict[str, float], limits: Dict[str, float]
                ) -> List[dict]:
    return [{"name": k, "value": gaps[k], "limit": limits[k]}
            for k in sorted(limits)]
