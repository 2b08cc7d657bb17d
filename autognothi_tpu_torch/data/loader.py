"""Dataset loaders: the port's own copy of the parts of
`autognothi_tpu/data/loader.py` it runs, `DatasetLoader` and the offline
synthetic `cv_samples` set (numpy only, the same images for the same
arguments).  Every other dataset kind is not ported yet."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Tuple

import numpy as np


@dataclasses.dataclass
class DatasetLoader:
    # batch_size -> ...(Xs, Ys, Xs_raw, Ys_raw)
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
