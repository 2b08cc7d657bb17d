"""Dataset loaders: the port's own copy of the parts of
`autognothi_tpu/data/loader.py` it runs: `DatasetLoader`, the offline
synthetic `cv_samples` set (numpy only, the same images for the same
arguments), the bundled text sets (`nlp_samples`, this package's copy of
the JAX package's `nlp_samples.json`; `yelp_polarity_mini`, which falls
back to it) and `yelp_polarity` from a local `datasets` cache only.
`imagenette` is not ported yet."""

from __future__ import annotations

import dataclasses
import json
import pathlib
import random
from typing import Any, Callable, Iterable, List, Optional, Tuple

import numpy as np

_HERE = pathlib.Path(__file__).parent


@dataclasses.dataclass
class DatasetLoader:
    # batch_size -> ...(Xs, Ys, Xs_raw, Ys_raw)
    #     nlp: Xs = Xs_raw := List[str], Ys = Ys_raw := List[int]
    #     cv: Xs := List[np <3,H,W>], Ys := List[int]
    train_raw: Callable[[int], Iterable[Tuple[Any, Any, Any, Any]]]
    test_raw: Callable[[int], Iterable[Tuple[Any, Any, Any, Any]]]

    def train(self, batch_size: int) -> Iterable[Tuple[Any, Any]]:
        for xs, ys, _xr, _yr in self.train_raw(batch_size):
            yield xs, ys

    def test(self, batch_size: int) -> Iterable[Tuple[Any, Any]]:
        for xs, ys, _xr, _yr in self.test_raw(batch_size):
            yield xs, ys


def load_cv_samples(train_size: int = 32, test_size: int = 16,
                    img_px_size: int = 32, num_classes: int = 4,
                    seed: int = 1234) -> DatasetLoader:
    """Fully offline synthetic image classification set: each class is a
    distinct low-frequency pattern + noise.  Deterministic in `seed`."""

    def make(count: int, salt: int):
        rng = np.random.RandomState(seed + salt)
        xs, ys = [], []
        yy, xx = np.mgrid[0:img_px_size, 0:img_px_size].astype(np.float32)
        yy, xx = yy / img_px_size, xx / img_px_size
        for i in range(count):
            label = i % num_classes
            phase = 2 * np.pi * label / num_classes
            base = np.sin(2 * np.pi * (xx + yy) + phase)
            img = np.stack([base, np.cos(2 * np.pi * xx + phase),
                            np.sin(2 * np.pi * yy - phase)])
            img = img + 0.25 * rng.randn(3, img_px_size, img_px_size)
            xs.append(img.astype(np.float32))
            ys.append(label)
        return xs, ys

    train_xs, train_ys = make(train_size, 0)
    test_xs, test_ys = make(test_size, 1)

    def it(xs, ys):
        def loader(batch_size: int):
            for i in range(0, len(xs), batch_size):
                bx, by = xs[i:i + batch_size], ys[i:i + batch_size]
                yield bx, by, [x.copy() for x in bx], list(by)

        return loader

    return DatasetLoader(train_raw=it(train_xs, train_ys),
                         test_raw=it(test_xs, test_ys))


# ------------------------------------------------------------ text sets


def _json_nlp_loader(path: pathlib.Path) -> DatasetLoader:
    """A bundled JSON list of {"inputs": text, "targets": label}: train and
    test iterate the same samples, in order (`:212-223`)."""
    with open(path, "r", encoding="utf-8") as f:
        samples = json.load(f)

    def it(batch_size: int) -> Iterable[Tuple[Any, Any, Any, Any]]:
        for i in range(0, len(samples), batch_size):
            chunk = samples[i:i + batch_size]
            xs = [s["inputs"] for s in chunk]
            ys = [s["targets"] for s in chunk]
            yield xs, ys, list(xs), list(ys)

    return DatasetLoader(train_raw=it, test_raw=it)


def load_nlp_samples() -> DatasetLoader:
    """The 24 labelled sentences bundled with the package."""
    return _json_nlp_loader(_HERE / "nlp_samples.json")


def load_yelp_polarity_mini() -> DatasetLoader:
    """A mini yelp-polarity set where one is bundled
    (`yelp_polarity_mini.json`), else the sample set (`:226-235`)."""
    mini = _HERE / "yelp_polarity_mini.json"
    if mini.exists():
        return _json_nlp_loader(mini)
    return load_nlp_samples()


def _subset_ids(n: int, pick: int, *, seed: Optional[int]) -> List[int]:
    """A seeded (or, with no seed, run-random) subset of range(n)."""
    ids = list(range(n))
    gen = random.Random(seed if seed is not None
                        else random.randint(0, 2**32))
    gen.shuffle(ids)
    return ids[:pick]


def load_yelp_polarity(train_size: int, test_size: int,
                       test_seed: int) -> DatasetLoader:
    """fancyzhx/yelp_polarity from a local `datasets` cache (`save_to_disk`)
    at `data/yelp_polarity` in this package, where the JAX package keeps
    its own.  The port downloads nothing: without that cache, or without
    the `datasets` package, it raises, naming what is missing."""
    cache = _HERE / "yelp_polarity"
    if not cache.exists():
        raise FileNotFoundError(
            f"dataset 'yelp_polarity' needs its local `datasets` cache at "
            f"{cache} (the port downloads nothing: save the set there with "
            f"`datasets`' save_to_disk, or use 'nlp_samples')")
    try:
        from datasets import load_from_disk
    except ImportError as err:
        raise ImportError(
            f"dataset 'yelp_polarity' is the `datasets` cache at {cache}, "
            f"which needs the `datasets` package") from err
    ds = load_from_disk(str(cache))

    def make_it(split: str, size: int, seed: Optional[int]):
        def it(batch_size: int):
            data = ds[split]
            sub = data.select(_subset_ids(len(data), size, seed=seed))
            for batch in sub.iter(batch_size):
                xs, ys = [], []
                for t, label in zip(batch["text"], batch["label"]):
                    if isinstance(t, str) and isinstance(label, int) \
                            and 0 <= label < 2 and len(t) >= 32:
                        xs.append(t)
                        ys.append(label)
                if xs:
                    yield xs, ys, list(xs), list(ys)

        return it

    return DatasetLoader(train_raw=make_it("train", train_size, None),
                         test_raw=make_it("test", test_size, test_seed))
