"""Port parity, the CV data path: the transform chain (`CvTransforms`,
`apply_cv_transforms`), the bilinear resize (the native C++ core,
`native/imageproc.cpp`, and the numpy grid), the core's `ip_normalize`,
the dataset block's `transforms`, and the imagenette loader on local
arrow fixtures (built as tests/test_arrow_datasets.py builds them),
against the JAX package on the same inputs and `random.Random` seeds.

Tolerances: the port's copy of the C++ core and the JAX package's are the
same source built with the same flags, and both numpy paths are the same
code: each is held bit for bit against its JAX twin.  The core computes
in fp32 where numpy computes in float64: the two paths agree within
1e-5; `ip_normalize` multiplies by the fp32 reciprocal of std, so it is
held within 1e-6 of numpy's division.
"""

import ctypes
import json
import random

import numpy as np
import pytest

import autognothi_tpu.data.loader as jl
import autognothi_tpu_torch.data.loader as pl

ENTRIES = {
    "resize": {"height": 13, "width": 21},
    "random_crop": {"height": 12, "width": 12, "scale": [0.3, 0.9], "p": 1.0},
    "center_crop": {"height": 9, "width": 7},
    "center_crop_pads": {"height": 40, "width": 44},
    "horizontal_flip": {"p": 0.5},
    "vertical_flip": {"p": 0.5},
    "color_jitter": {"brightness": 0.4, "contrast": 0.3, "saturation": 0.2,
                     "hue": 0.1},
}


def _pair(raw: dict):
    """The same `transforms` block as the JAX model and the port's."""
    return jl.CvTransforms(**raw), pl.CvTransforms.from_dict(raw)


def _image(seed=0, shape=(3, 31, 37)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_each_transform_matches_jax_under_the_same_seed(entry):
    name = "center_crop" if entry == "center_crop_pads" else entry
    jt, pt = _pair({name: ENTRIES[entry]})
    for seed in range(6):
        img = _image(seed)
        want = jl.apply_cv_transforms(img.copy(), jt, random.Random(seed))
        got = pl.apply_cv_transforms(img.copy(), pt, random.Random(seed))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_the_whole_chain_matches_jax_and_draws_from_the_given_rng():
    raw = {k: v for k, v in ENTRIES.items() if k != "center_crop_pads"}
    jt, pt = _pair(raw)
    outs = []
    for seed in (3, 3, 4):
        img = _image(seed)
        want = jl.apply_cv_transforms(img.copy(), jt, random.Random(seed))
        got = pl.apply_cv_transforms(img.copy(), pt, random.Random(seed))
        np.testing.assert_array_equal(got, want)
        outs.append(got)
    np.testing.assert_array_equal(outs[0], outs[1])
    # with no rng, the `random` module draws, as in the JAX package
    random.seed(11)
    want = jl.apply_cv_transforms(_image(), jt)
    random.seed(11)
    np.testing.assert_array_equal(pl.apply_cv_transforms(_image(), pt), want)


def test_transforms_block_is_parsed_and_validated():
    from autognothi_tpu.pipeline.config import ExpConfig
    from autognothi_tpu_torch.pipeline.config import parse_config
    from tests.test_train_all_e2e import MINI_VIT_HPARAMS

    hp = json.loads(json.dumps(MINI_VIT_HPARAMS))
    hp["dataset"] = {"kind": "imagenette", "train_size": 8, "test_size": 4,
                     "test_seed": 7,
                     "transforms": {"resize": {"height": "16", "width": 16},
                                    "horizontal_flip": {"p": 1},
                                    "unknown": {"x": 1}}}
    got = parse_config(hp).dataset.fields["transforms"]
    want = ExpConfig.model_validate(hp).dataset.transforms
    assert got == pl.CvTransforms(resize={"height": 16, "width": 16},
                                  horizontal_flip={"p": 1.0})
    assert got.resize == dict(want.resize)
    assert got.horizontal_flip == dict(want.horizontal_flip)
    with pytest.raises(ValueError, match="random_crop"):
        pl.CvTransforms.from_dict({"random_crop": {"height": 3, "width": 3,
                                                   "p": 1.0}})
    del hp["dataset"]["transforms"]
    with pytest.raises(ValueError, match="transforms"):
        parse_config(hp)


@pytest.fixture(scope="module")
def cores():
    """Both packages' native cores, built (the port's under build/)."""
    port = pl._native_imageproc()
    jax_ = jl._native_imageproc()
    assert port is not None, "the port's imageproc core did not build"
    if jax_ is None:
        pytest.skip("the JAX package's core did not build")
    return port, jax_


@pytest.mark.parametrize("src_hw,dst_hw", [
    ((31, 37), (224, 224)), ((7, 9), (13, 5)), ((500, 375), (224, 224)),
    ((5, 5), (1, 1)), ((1, 1), (4, 3)), ((16, 16), (16, 16))])
def test_resize_native_and_numpy_match_jax(cores, monkeypatch, src_hw,
                                           dst_hw):
    img = np.random.RandomState(1).randn(3, *src_hw).astype(np.float32)
    native = pl._resize_chw(img, *dst_hw)
    np.testing.assert_array_equal(native, jl._resize_chw(img, *dst_hw))
    numpy_ = pl._resize_chw_numpy(img, *dst_hw)
    monkeypatch.setattr(jl, "_IMAGEPROC", False)  # the JAX numpy path
    np.testing.assert_array_equal(numpy_, jl._resize_chw(img, *dst_hw))
    assert native.shape == numpy_.shape == (3, *dst_hw)
    np.testing.assert_allclose(native, numpy_, rtol=0, atol=1e-5)


def test_ip_normalize_matches_numpy(cores):
    port, _ = cores
    fp = ctypes.POINTER(ctypes.c_float)
    rng = np.random.RandomState(2)
    imgs = rng.rand(4, 3, 17, 23).astype(np.float32)
    out = imgs.copy()
    mean, std = pl.IMAGENET_MEAN.copy(), pl.IMAGENET_STD.copy()
    assert port.ip_normalize(out.ctypes.data_as(fp), 4, 3, 17 * 23,
                             mean.ctypes.data_as(fp),
                             std.ctypes.data_as(fp)) == 0
    want = (imgs - mean[None, :, None, None]) / std[None, :, None, None]
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)
    zero = np.zeros(3, np.float32)
    assert port.ip_normalize(out.ctypes.data_as(fp), 4, 3, 17 * 23,
                             mean.ctypes.data_as(fp),
                             zero.ctypes.data_as(fp)) == 2
    np.testing.assert_array_equal(pl.IMAGENET_MEAN, jl.IMAGENET_MEAN)
    np.testing.assert_array_equal(pl.IMAGENET_STD, jl.IMAGENET_STD)
    assert pl.IMAGENETTE_LABEL_ORDER == jl.IMAGENETTE_LABEL_ORDER


# ------------------------------------------- imagenette on arrow fixtures


@pytest.fixture(scope="module")
def arrow_home(tmp_path_factory):
    """Local `datasets` caches of imagenette (varied sizes, two grayscale
    images, every hub label) and yelp, where both loaders look for them."""
    hfds = pytest.importorskip("datasets")
    image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(3)

    def img(mode, size):
        arr = (rng.rand(*size, 3 if mode == "RGB" else 1) * 255).astype(
            np.uint8)
        return image.fromarray(arr.squeeze(), mode=mode)

    feats = hfds.Features({"image": hfds.Image(),
                           "label": hfds.Value("int64")})
    sizes = [(40, 56), (24, 24), (32, 32), (48, 32), (30, 30), (28, 44),
             (36, 36), (50, 20), (26, 26), (33, 41)]
    train = [img("L" if i == 2 else "RGB", s) for i, s in enumerate(sizes)]
    val = [img("RGB", (33, 27)), img("RGB", (21, 41)), img("L", (20, 20)),
           img("RGB", (25, 25)), img("RGB", (19, 30))]
    root = tmp_path_factory.mktemp("arrow")
    (root / "nlp_samples.json").write_text(
        (pl._HERE / "nlp_samples.json").read_text())
    hfds.DatasetDict({
        "train": hfds.Dataset.from_dict(
            {"image": train, "label": list(range(10))}, features=feats),
        "validation": hfds.Dataset.from_dict(
            {"image": val, "label": [2, 7, 4, 0, 9]}, features=feats),
    }).save_to_disk(str(root / "imagenette"))
    text = [f"review {i} is certainly long enough to pass the length filter"
            for i in range(6)]
    hfds.DatasetDict({
        split: hfds.Dataset.from_dict({"text": text,
                                       "label": [i % 2 for i in range(6)]})
        for split in ("train", "test")}).save_to_disk(
            str(root / "yelp_polarity"))
    return root


def _batches(loader, split, size):
    random.seed(5)  # the train subset and the flips draw from `random`
    return list(getattr(loader, split)(size))


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) == 4
        for ga, wa in zip(g, w):
            assert len(ga) == len(wa)
            for x, y in zip(ga, wa):
                if isinstance(y, np.ndarray):
                    assert x.dtype == y.dtype == np.float32
                    np.testing.assert_array_equal(x, y)
                else:
                    assert x == y


def test_imagenette_matches_jax(arrow_home, monkeypatch):
    monkeypatch.setattr(jl, "_HERE", arrow_home)
    monkeypatch.setattr(pl, "_HERE", arrow_home)
    raw = {"resize": {"height": 16, "width": 16},
           "horizontal_flip": {"p": 0.5}}
    jt, pt = _pair(raw)
    j = jl.load_imagenette(8, 4, 7, jt)
    p = pl.load_imagenette(8, 4, 7, pt)
    for split, size in (("train_raw", 3), ("test_raw", 2)):
        got, want = _batches(p, split, size), _batches(j, split, size)
        _assert_same(got, want)
    train = [x for b in _batches(p, "train_raw", 3) for x in zip(*b)]
    assert len(train) == 8
    for x, y, raw_x, raw_y in train:
        assert x.shape == (3, 16, 16) and y == raw_y and 0 <= y < 10
        assert raw_x.shape[0] == 3 and 0 <= raw_x.min() <= raw_x.max() <= 1
    # the hub positions of the validation split, remapped; the subset is
    # seeded: two iterations give the same images
    test = [x for b in _batches(p, "test_raw", 4) for x in zip(*b)]
    assert len(test) == 4 and {y for _, y, _, _ in test} <= {
        pl.IMAGENETTE_LABEL_ORDER[i] for i in (2, 7, 4, 0, 9)}
    _assert_same(_batches(p, "test_raw", 4), _batches(p, "test_raw", 4))
    # a grayscale image is promoted to three equal channels
    gray = [r for _, _, r, _ in train if np.array_equal(r[0], r[1])
            and np.array_equal(r[1], r[2])]
    assert gray


def test_load_id_dataset_matches_jax(arrow_home, monkeypatch):
    from autognothi_tpu.pipeline.resources import load_id_dataset as j_id
    from autognothi_tpu_torch.pipeline.resources import \
        load_id_dataset as p_id

    monkeypatch.setattr(jl, "_HERE", arrow_home)
    monkeypatch.setattr(pl, "_HERE", arrow_home)
    for kind, px in (("imagenette", 16), ("cv_samples", 16),
                     ("nlp_samples", None), ("yelp_polarity", None)):
        _assert_same(_batches(p_id(kind, px), "test_raw", 3),
                     _batches(j_id(kind, px), "test_raw", 3))
    with pytest.raises(ValueError, match="img_px_size"):
        p_id("imagenette")
    with pytest.raises(ValueError, match="unknown dataset kind"):
        p_id("mnist")


def test_preload_all_datasets_checks_the_local_caches(arrow_home, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(pl, "_HERE", arrow_home)
    pl.preload_all_datasets()  # both caches there: nothing raised
    monkeypatch.setattr(pl, "_HERE", tmp_path)
    with pytest.raises(FileNotFoundError) as err:
        pl.preload_all_datasets()
    assert "yelp_polarity" in str(err.value) and "imagenette" in str(
        err.value) and "downloads nothing" in str(err.value)
