"""Port parity, directory checkpoints (AUTOGNOTHI_CKPT_BACKEND=orbax): the
port writes `torch.distributed.checkpoint` directories at the checkpoint's
path, every rank its own share, and `load_params_file` detects the format.
- one process: a directory loads to the npz's flat dict bit for bit, and
  to what the JAX package reads back from its own Orbax directory of the
  same numpy parameters;
- a world of two gloo processes: a tensor-parallel (model 2) module and a
  pipeline (pipe 2) stage each write a directory whose load is the npz of
  the same parameters bit for bit, each rank writing only its shards or
  its stage (the directory's metadata names the rank file of each chunk),
  the optimizer moments as shards too;
- retention and resume as with npz: a directory the cadence drops is
  removed, a `.tmp` directory (a write cut short) is never taken as a
  checkpoint, and an Orbax directory raises by name."""

import contextlib
import os
import pathlib
from types import SimpleNamespace
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from autognothi_tpu.pipeline import resources as j_res
from autognothi_tpu_torch import params as p_params
from autognothi_tpu_torch.pipeline import resources as p_res
from autognothi_tpu_torch.pipeline.training import AdamW
from tests.test_torch_port_scaleout import run_world
from tests.test_torch_port_vanilla import vit_hparams

ORBAX = {"AUTOGNOTHI_CKPT_BACKEND": "orbax"}


@contextlib.contextmanager
def _env(values):
    keys = ("AUTOGNOTHI_CKPT_BACKEND", "AUTOGNOTHI_CKPT_OPT")
    saved = {k: os.environ.pop(k) for k in keys if k in os.environ}
    try:
        with mock.patch.dict(os.environ, values):
            yield
    finally:
        os.environ.update(saved)


def _flat(seed=0):
    rng = np.random.RandomState(seed)
    return {"vit.encoder.layers.0.attention.self.query.weight":
            rng.randn(8, 8).astype(np.float32),
            "vit.layernorm.bias": rng.randn(8).astype(np.float32),
            "classifier.weight": rng.randn(3, 8).astype(np.float32),
            "Xs_train": rng.randint(0, 9, (4, 5)).astype(np.int32)}


def _same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_directory_loads_to_the_npz_dict(tmp_path):
    flat = _flat()
    p_params.save_params(tmp_path / "a.ckpt", flat)
    with _env(ORBAX):
        p_params.save_params(tmp_path / "b.ckpt", flat)
    assert (tmp_path / "b.ckpt").is_dir()
    assert (tmp_path / "b.ckpt" / p_params.DCP_METADATA).exists()
    assert not (tmp_path / "b.ckpt.tmp").exists()
    _same(p_params.load_params_file(tmp_path / "b.ckpt"),
          p_params.load_params_file(tmp_path / "a.ckpt"))
    # a module's own state: the same dict as `to_flat`
    from autognothi_tpu_torch.models.vit import VanillaViTConfig
    from autognothi_tpu_torch.params import MODELS, owned_state, to_flat

    cfg = VanillaViTConfig(**vit_hparams()["net"]["params"])
    model = MODELS[type(cfg)](cfg, "explainer")
    model.reset_parameters(torch.Generator().manual_seed(0))
    with _env(ORBAX):
        p_params.save_params(tmp_path / "m.ckpt", owned_state(model))
    _same(p_params.load_params_file(tmp_path / "m.ckpt"), to_flat(model))


def test_flat_dict_matches_the_jax_packages_orbax_directory(tmp_path):
    flat = _flat(1)
    with _env(ORBAX):
        j_res.save_params(tmp_path / "jax.ckpt", flat)
        p_params.save_params(tmp_path / "port.ckpt", flat)
    want = j_res.load_params_file(tmp_path / "jax.ckpt")
    got = p_params.load_params_file(tmp_path / "port.ckpt")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    # the JAX package's directory is Orbax's: the port names it and raises
    with pytest.raises(NotImplementedError, match="Orbax checkpoint"):
        p_params.load_params_file(tmp_path / "jax.ckpt")
    # an unknown directory is no checkpoint
    (tmp_path / "other.ckpt").mkdir()
    with pytest.raises(ValueError, match="no .metadata"):
        p_params.load_params_file(tmp_path / "other.ckpt")


@pytest.mark.parametrize("backend", ["npz", "orbax"])
def test_retention_and_resume_as_with_npz(tmp_path, backend):
    """Five epochs at a cadence of every second epoch, opt state on: the
    same epochs stay in both formats, the previous epoch's opt state goes,
    the resume scan finds the newest, and a `.tmp` directory left by a
    write cut short is never taken."""
    cfg = SimpleNamespace(epochs=5, ckpt_when="_:%2==0")
    w = torch.nn.Parameter(torch.ones(3))
    opt = AdamW({"w": w}, lambda k: True)
    env = {"AUTOGNOTHI_CKPT_BACKEND": backend, "AUTOGNOTHI_CKPT_OPT": "1"}
    with _env(env):
        for epoch in range(1, 6):
            opt.count = epoch
            p_res.save_epoch_ckpt(tmp_path, "explainer", cfg, epoch,
                                  {"w": np.full(3, epoch, np.float32)},
                                  opt=opt)
        kept = sorted(p.name for p in tmp_path.iterdir())
        assert kept == ["explainer-epoch-2.ckpt", "explainer-epoch-4.ckpt",
                        "explainer-epoch-5.ckpt",
                        "explainer-epoch-5.opt.ckpt"], kept
        assert all(p.is_dir() == (backend == "orbax")
                   for p in tmp_path.iterdir())
        assert p_res.get_epoch_ckpts(tmp_path, "explainer", 5) == [2, 4, 5]
        # a write of epoch 5's successor cut short, and one of epoch 3
        (tmp_path / "explainer-epoch-6.ckpt.tmp").mkdir()
        (tmp_path / "explainer-epoch-3.ckpt.tmp").mkdir()
        epoch, flat = p_res.load_epoch_ckpt(tmp_path, "explainer", 6)
        assert epoch == 5 and flat["w"].tolist() == [5.0] * 3
        assert p_res.get_epoch_ckpts(tmp_path, "explainer", 6) == [2, 4, 5]
        fresh = AdamW({"w": w}, lambda k: True)
        p_res.maybe_restore_opt_state(tmp_path, "explainer", 5, fresh)
        assert fresh.count == 5


def test_tensor_and_pipeline_parallel_directories(tmp_path):
    """Two gloo ranks: a TP (model 2) explainer and a pipe-2 classifier
    stage written as directories (each rank its own chunks, no gather),
    loaded to the npz of the same parameters bit for bit on every rank and
    here; the TP moments are the shards' moments; the TP directory of the
    epoch the cadence drops is gone."""
    from autognothi_tpu.models.vit import (VanillaViTConfig,
                                           init_vit_classifier,
                                           init_vit_explainer)
    import torch.distributed.checkpoint as dcp

    hp = vit_hparams()["net"]["params"]
    cfg = VanillaViTConfig(**hp)
    np_ = lambda p: {k: np.asarray(v) for k, v in p.items()}  # noqa
    exp = np_(init_vit_explainer(jax.random.PRNGKey(3), cfg))
    cls = np_(init_vit_classifier(jax.random.PRNGKey(4), cfg))
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, **{f"exp/{k}": v for k, v in exp.items()},
             **{f"cls/{k}": v for k, v in cls.items()})
    root = tmp_path / "ckpt"
    ranks = run_world({"tag": "ckpt", "jobs": ["ckpt_dir"],
                       "inputs": str(inputs), "cfgs": {"vit": hp},
                       "ckpt": str(root)}, 2, tmp_path,
                      module="tests.torch_port_pp_child")
    for js, _ in ranks:
        assert js["tp/loaded_equal"] and js["pp/loaded_equal"]
    load = p_params.load_params_file
    tp_dir = root / "tp" / "explainer-epoch-2.ckpt"
    _same(load(tp_dir), load(root / "npz_tp.ckpt"))
    _same(load(tp_dir), exp)
    assert not (root / "tp" / "explainer-epoch-1.ckpt").exists()
    assert sorted(p.name for p in (root / "tp").iterdir()) == [
        "explainer-epoch-2.ckpt", "explainer-epoch-2.opt.ckpt"]
    moments = load(root / "tp" / "explainer-epoch-2.opt.ckpt")
    assert int(moments["count"]) == 3
    for k, v in exp.items():
        np.testing.assert_array_equal(moments[f"mu/{k}"], v * 0.5)
    pp_dir = root / "pp" / "classifier-epoch-1.ckpt"
    _same(load(pp_dir), load(root / "npz_pp.ckpt"))
    _same(load(pp_dir), cls)

    def files(path):
        """fqn -> {rank file: [chunk offsets]} of a directory."""
        meta = dcp.FileSystemReader(str(path)).read_metadata()
        out = {}
        for index, info in meta.storage_data.items():
            rank = int(info.relative_path.split("_")[2])
            out.setdefault(index.fqn, {}).setdefault(rank, []).append(
                tuple(index.offset))
        return out

    # TP: each rank wrote its own slice of every sharded weight; the
    # replicated tensors are written once
    tp = files(tp_dir)
    q = "vit.encoder.layers.0.attention.self.query.weight"
    o = "vit.encoder.layers.0.attention.output.dense.weight"
    half = cfg.hidden_size // 2
    assert tp[q] == {0: [(0, 0)], 1: [(half, 0)]}, tp[q]
    assert tp[o] == {0: [(0, 0)], 1: [(0, half)]}, tp[o]
    for k, owners in tp.items():
        assert sum(len(v) for v in owners.values()) == (
            2 if len(owners) == 2 else 1), (k, owners)
    # PP: each stage's tensors are in its rank's file only
    pp = files(pp_dir)
    for r, (js, _) in enumerate(ranks):
        for k in js["pp/stage_keys"]:
            if "encoder.layers" in k:
                assert set(pp[k]) == {r}, (k, pp[k])
    assert set(pp["vit.encoder.layers.0.attention.self.query.weight"]) == {0}
    assert set(pp["vit.encoder.layers.1.attention.self.query.weight"]) == {1}
