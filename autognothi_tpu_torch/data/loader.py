"""Dataset loaders and the CV transforms: the port's own copy of
`autognothi_tpu/data/loader.py`.  `DatasetLoader`, the offline synthetic
`cv_samples` set (numpy only, the same images for the same arguments),
the bundled text sets (`nlp_samples`, this package's copy of the JAX
package's `nlp_samples.json`; `yelp_polarity_mini`, which falls back to
it), and `yelp_polarity` and `imagenette` from a local `datasets` cache
only: the port downloads nothing, and a set without its cache raises,
naming what is missing.

The CV transform chain (`CvTransforms`, `apply_cv_transforms`) runs on
<C, H, W> float arrays on the host; its bilinear resize is the native C++
core (`native/imageproc.cpp`, built with g++ at first use) where it
builds, and the same align-corners grid in numpy otherwise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import pathlib
import random
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

_HERE = pathlib.Path(__file__).parent

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)


# ------------------------------------------------------------- transforms

# each transform's fields and their types, as the JAX package's TypedDicts
# (`:43-79`); every field of a transform that is given is required
_CV_FIELDS: Dict[str, Dict[str, Callable[[Any], Any]]] = {
    "resize": {"height": int, "width": int},
    "random_crop": {"height": int, "width": int,
                    "scale": lambda v: (float(v[0]), float(v[1])),
                    "p": float},
    "center_crop": {"height": int, "width": int},
    "horizontal_flip": {"p": float},
    "vertical_flip": {"p": float},
    "color_jitter": {"brightness": float, "contrast": float,
                     "saturation": float, "hue": float},
}


@dataclasses.dataclass(frozen=True)
class CvTransforms:
    """The dataset block's `transforms`: each entry None or the dict of
    its fields (`:70-76`)."""
    resize: Optional[Dict[str, Any]] = None
    random_crop: Optional[Dict[str, Any]] = None
    center_crop: Optional[Dict[str, Any]] = None
    horizontal_flip: Optional[Dict[str, Any]] = None
    vertical_flip: Optional[Dict[str, Any]] = None
    color_jitter: Optional[Dict[str, Any]] = None

    @classmethod
    def from_dict(cls, raw: Optional[Dict[str, Any]]) -> "CvTransforms":
        """Parse and validate a `transforms` block: unknown entries and
        fields are ignored, as the JAX schema ignores them; a missing or
        mistyped field raises ValueError naming it."""
        entries = {}
        for name, fields in _CV_FIELDS.items():
            opt = (raw or {}).get(name)
            if opt is None:
                continue
            try:
                entries[name] = {k: conv(opt[k]) for k, conv in fields.items()}
            except (KeyError, TypeError, ValueError, IndexError) as err:
                raise ValueError(f"transforms.{name}: {err!r}") from err
        return cls(**entries)


_IMAGEPROC = None  # the native core's handle (False where unavailable)


def _native_imageproc() -> Optional[ctypes.CDLL]:
    """The C++ image core, built and loaded at first use, its two entry
    points bound (`ip_resize_bilinear`, which `_resize_chw` calls, and
    `ip_normalize`, an in-place per-channel normalize of <N, C, H*W>);
    None where it is unavailable."""
    global _IMAGEPROC
    if _IMAGEPROC is None:
        from ..native import build_and_load

        lib = build_and_load("imageproc")
        if lib is not None:
            fp, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
            lib.ip_resize_bilinear.restype = ctypes.c_int
            lib.ip_resize_bilinear.argtypes = [fp, i64, i64, i64, fp, i64,
                                               i64]
            lib.ip_normalize.restype = ctypes.c_int
            lib.ip_normalize.argtypes = [fp, i64, i64, i64, fp, fp]
        _IMAGEPROC = lib or False
    return _IMAGEPROC or None


def _resize_chw_numpy(img: np.ndarray, height: int,
                      width: int) -> np.ndarray:
    """Bilinear resize of <C, H, W> on the align-corners grid, in numpy."""
    c, h, w = img.shape
    ys = np.linspace(0, h - 1, height)
    xs = np.linspace(0, w - 1, width)
    y0 = np.floor(ys).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x0 = np.floor(xs).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[None, :, None]
    wx = (xs - x0)[None, None, :]
    top = img[:, y0][:, :, x0] * (1 - wx) + img[:, y0][:, :, x1] * wx
    bot = img[:, y1][:, :, x0] * (1 - wx) + img[:, y1][:, :, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def _resize_chw(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of a <C, H, W> float array (`:107-136`): the native
    core where it loads (the same grid, in fp32), numpy otherwise."""
    c, h, w = img.shape
    if (h, w) == (height, width):
        return img
    lib = _native_imageproc()
    if lib is not None:
        fp = ctypes.POINTER(ctypes.c_float)
        src = np.ascontiguousarray(img, dtype=np.float32)
        dst = np.empty((c, height, width), dtype=np.float32)
        if lib.ip_resize_bilinear(src.ctypes.data_as(fp), c, h, w,
                                  dst.ctypes.data_as(fp), height,
                                  width) == 0:
            return dst
    return _resize_chw_numpy(img, height, width)


def apply_cv_transforms(img: np.ndarray, transforms: CvTransforms,
                        rng: Optional[random.Random] = None) -> np.ndarray:
    """The configured chain on a normalized <C, H, W> image (`:139-189`),
    drawing from `rng` (the `random` module where None): resize, random
    crop, center crop (zero-padding an image smaller than the crop, as
    torchvision does), the flips, then brightness and contrast (the JAX
    package's color jitter takes only those two)."""
    rng = rng or random
    if transforms.resize:
        opt = transforms.resize
        img = _resize_chw(img, opt["height"], opt["width"])
    if transforms.random_crop:
        opt = transforms.random_crop
        c, h, w = img.shape
        scale = rng.uniform(*opt["scale"])
        ch = max(1, int(round(h * np.sqrt(scale))))
        cw = max(1, int(round(w * np.sqrt(scale))))
        top = rng.randint(0, max(0, h - ch))
        left = rng.randint(0, max(0, w - cw))
        img = _resize_chw(img[:, top:top + ch, left:left + cw],
                          opt["height"], opt["width"])
    if transforms.center_crop:
        opt = transforms.center_crop
        c, h, w = img.shape
        ch, cw = opt["height"], opt["width"]
        if h < ch or w < cw:
            ph, pw = max(0, ch - h), max(0, cw - w)
            img = np.pad(img, ((0, 0), (ph // 2, ph - ph // 2),
                               (pw // 2, pw - pw // 2)))
            c, h, w = img.shape
        top = max(0, (h - ch) // 2)
        left = max(0, (w - cw) // 2)
        img = img[:, top:top + ch, left:left + cw]
    if transforms.horizontal_flip \
            and rng.random() < transforms.horizontal_flip["p"]:
        img = img[:, :, ::-1].copy()
    if transforms.vertical_flip \
            and rng.random() < transforms.vertical_flip["p"]:
        img = img[:, ::-1, :].copy()
    if transforms.color_jitter:
        opt = transforms.color_jitter
        if opt["brightness"]:
            img = img * rng.uniform(1 - opt["brightness"],
                                    1 + opt["brightness"])
        if opt["contrast"]:
            mean = img.mean()
            img = (img - mean) * rng.uniform(1 - opt["contrast"],
                                             1 + opt["contrast"]) + mean
    return img.astype(np.float32)


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


def _local_dataset(name: str, fallback: str):
    """The `datasets` cache (`save_to_disk`) of set `name` at
    `data/<name>` in this package, where the JAX package keeps its own.
    The port downloads nothing: without that cache, or without the
    `datasets` package, it raises, naming what is missing."""
    cache = _HERE / name
    if not cache.exists():
        raise FileNotFoundError(
            f"dataset {name!r} needs its local `datasets` cache at {cache} "
            f"(the port downloads nothing: save the set there with "
            f"`datasets`' save_to_disk, or use {fallback!r})")
    try:
        from datasets import load_from_disk
    except ImportError as err:
        raise ImportError(
            f"dataset {name!r} is the `datasets` cache at {cache}, which "
            f"needs the `datasets` package") from err
    return load_from_disk(str(cache))


def load_yelp_polarity(train_size: int, test_size: int,
                       test_seed: int) -> DatasetLoader:
    """fancyzhx/yelp_polarity from its local cache (`_local_dataset`)."""
    ds = _local_dataset("yelp_polarity", "nlp_samples")

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


# position in frgfm/imagenette -> the model's label id (tench, springer,
# cassette, chainsaw, church, horn, truck, pump, golf ball, parachute in
# the reference's order)
IMAGENETTE_LABEL_ORDER: Dict[int, int] = {
    0: 2, 1: 3, 2: 0, 3: 7, 4: 4, 5: 6, 6: 1, 7: 9, 8: 8, 9: 5,
}


def load_imagenette(train_size: int, test_size: int, test_seed: int,
                    transforms: CvTransforms) -> DatasetLoader:
    """frgfm/imagenette (full size) from its local cache
    (`_local_dataset`), `:302-342`: each image to fp32 in [0, 1], a
    grayscale one promoted to 3 channels, <3, H, W>; the raw copy kept,
    the rest ImageNet-normalized and transformed (drawing from the
    `random` module, as the JAX loader does); labels remapped by
    IMAGENETTE_LABEL_ORDER.  The test split is a seeded subset."""
    ds = _local_dataset("imagenette", "cv_samples")

    def make_it(split: str, size: int, seed: Optional[int]):
        def it(batch_size: int):
            data = ds[split]
            sub = data.select(_subset_ids(len(data), size, seed=seed))
            for batch in sub.iter(batch_size):
                xs, ys, xr = [], [], []
                for img, label in zip(batch["image"], batch["label"]):
                    mapped = IMAGENETTE_LABEL_ORDER.get(label)
                    if mapped is None:
                        continue
                    arr = np.asarray(img, dtype=np.float32) / 255.0
                    if arr.ndim == 2:
                        arr = np.stack([arr] * 3, axis=-1)
                    arr = arr.transpose(2, 0, 1)
                    raw = arr.copy()
                    arr = (arr - IMAGENET_MEAN[:, None, None]) / (
                        IMAGENET_STD[:, None, None])
                    xs.append(apply_cv_transforms(arr, transforms))
                    ys.append(mapped)
                    xr.append(raw)
                if xs:
                    yield xs, ys, xr, list(ys)

        return it

    return DatasetLoader(train_raw=make_it("train", train_size, None),
                         test_raw=make_it("validation", test_size, test_seed))


def preload_all_datasets() -> None:
    """Check that the Hugging Face sets are in their local caches, at the
    JAX package's sizes (`:380-382`); the port downloads nothing, so a
    missing one raises, naming every set that is missing."""
    missing = []
    for name, load in (
            ("yelp_polarity",
             lambda: load_yelp_polarity(560000, 38000, 0x3407)),
            ("imagenette",
             lambda: load_imagenette(9469, 3925, 0x3407, CvTransforms()))):
        try:
            load()
        except (FileNotFoundError, ImportError) as err:
            missing.append(f"{name}: {err}")
    if missing:
        raise FileNotFoundError(
            "datasets missing from their local caches (the port downloads "
            "nothing):\n  " + "\n  ".join(missing))
