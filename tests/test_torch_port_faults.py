"""The port's faults F8, F9 and F10, each repaired and held here on the CPU
(F7's routes are in tests/test_torch_port_stages.py::
test_ladder_route_by_shape; F7's and F8's kernels on the card in
tests/test_torch_port_cuda.py).

- F9: a checkpoint saved with `torch.save` (a state dict, or a module)
  loads equal to its npz twin, and a final saved so serves the same; an
  Orbax directory raises by name.
- F10: a `ft_*` base model missing from `$AUTOGNOTHI_ZOO` is read from
  the package's own store, read-only, as the JAX loader does; the
  experiment store, where it has the model, comes first.
- F8: the attention core takes any T, and a head width it is not compiled
  for is zero-padded to the next compiled one with the true 1/sqrt(d)
  scale: the padded computation equals the unpadded one.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

from tests.test_ltt_e2e import _ltt_vit_hparams

CPU = torch.device("cpu")


def _final_exp(root, name, saver):
    from autognothi_tpu.models.ltt_vit import LttViTConfig, \
        init_ltt_vit_final

    exp = root / name
    exp.mkdir()
    hp = _ltt_vit_hparams()
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    params = init_ltt_vit_final(jax.random.PRNGKey(3),
                                LttViTConfig(**hp["net"]["params"]))
    flat = {k: np.asarray(v) for k, v in params.items()}
    saver(exp / "final-epoch-0.ckpt", flat, hp)
    return exp, flat


def _save_npz(file, flat, hp):
    from autognothi_tpu_torch.params import save_params

    save_params(file, flat)


def _save_state_dict(file, flat, hp):
    torch.save({k: torch.from_numpy(v.copy()) for k, v in flat.items()}, file)


def _save_module(file, flat, hp):
    from autognothi_tpu_torch.params import from_jax_params
    from autognothi_tpu_torch.recipes.ltt_vit import ltt_vit_recipe

    cfg = ltt_vit_recipe().t_config(**hp["net"]["params"])
    torch.save(from_jax_params(flat, cfg, CPU), file)


@pytest.mark.parametrize("saver", [_save_state_dict, _save_module])
def test_f9_torch_saved_checkpoint_loads_and_serves_as_its_npz_twin(
        tmp_path, saver):
    from autognothi_tpu_torch.params import _is_torch_archive, \
        load_params_file
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import ExplainService

    npz_exp, flat = _final_exp(tmp_path, "npz", _save_npz)
    pt_exp, _ = _final_exp(tmp_path, "torch", saver)
    pt_file = pt_exp / "final-epoch-0.ckpt"
    assert _is_torch_archive(pt_file)
    assert not _is_torch_archive(npz_exp / "final-epoch-0.ckpt")
    got = load_params_file(pt_file)
    assert set(got) == set(flat)
    for k in flat:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], flat[k])
    xs = np.random.RandomState(4).randn(3, 3, 16, 16).astype(np.float32)
    answers = []
    for exp in (npz_exp, pt_exp):
        with ExpEnv(exp) as env:
            service = ExplainService(env, batch_size=2, device="cpu")
            try:
                answers.append(service.explain({"images": xs.tolist()}))
            finally:
                service.close()
    assert answers[0] == answers[1]


def test_f9_an_orbax_directory_raises_by_name(tmp_path):
    from autognothi_tpu_torch.params import load_params_file

    orbax_dir = tmp_path / "final-epoch-0.ckpt"
    orbax_dir.mkdir()
    (orbax_dir / "_METADATA").write_text("{}")
    with pytest.raises(NotImplementedError, match="Orbax"):
        load_params_file(orbax_dir)


def test_f10_base_model_falls_back_to_the_package_store(tmp_path,
                                                       monkeypatch):
    from autognothi_tpu_torch.zoo import loader

    store, pkg = tmp_path / "zoo", tmp_path / "pkg"
    monkeypatch.setattr(loader, "_STORE", store)
    monkeypatch.setattr(loader, "_PKG_STORE", pkg)
    with pytest.raises(FileNotFoundError, match="ft_mini") as err:
        loader.load_params("ft_mini", 3)
    assert str(pkg / "ft_mini") in str(err.value)
    bundled = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    (pkg / "ft_mini").mkdir(parents=True)
    np.savez(pkg / "ft_mini" / "params.npz", **bundled)
    params, tokenizer = loader.load_params("ft_mini", 3)
    np.testing.assert_array_equal(params["w"], bundled["w"])
    assert tokenizer is None
    assert not (store / "ft_mini").exists()  # read-only: nothing copied
    own = {"w": np.ones((2, 3), np.float32)}
    (store / "ft_mini").mkdir(parents=True)
    np.savez(store / "ft_mini" / "params.npz", **own)
    params, _ = loader.load_params("ft_mini", 3)
    np.testing.assert_array_equal(params["w"], own["w"])


@pytest.mark.parametrize("d,want", [(1, 8), (4, 8), (8, 8), (12, 16),
                                    (16, 16), (48, 64), (64, 64), (65, 128),
                                    (96, 128), (128, 128), (129, None),
                                    (0, None)])
def test_f8_core_head_dims(d, want):
    from autognothi_tpu_torch.kernels.primitives import core_head_dim

    assert core_head_dim(d) == want


@pytest.mark.parametrize("mode", ["mul", "add"])
@pytest.mark.parametrize("d,t", [(4, 577), (12, 65), (96, 1025)])
def test_f8_zero_padded_heads_with_the_true_scale_are_exact(d, t, mode):
    """What the core computes for a padded head: q, k, v zero-padded to the
    compiled width, scores scaled by 1/sqrt(true d), the padded output
    columns dropped; against the plain version at the true width."""
    from autognothi_tpu_torch.kernels.primitives import core_head_dim
    from autognothi_tpu_torch.ops.flash_attention import \
        masked_attention_plain

    g = torch.Generator().manual_seed(d + t)
    q, k, v = (torch.randn(2, 3, t, d, generator=g) for _ in range(3))
    mask = (torch.rand(2, t, generator=g) > 0.3).float()
    mask[:, 0] = 1
    if mode == "add":
        mask = (1 - mask) * torch.finfo(torch.float32).min
    dc = core_head_dim(d)
    qp, kp, vp = (torch.nn.functional.pad(x, (0, dc - d)) for x in (q, k, v))
    scores = torch.matmul(qp, kp.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    m = mask[:, None, None, :]
    scores = scores + m if mode == "add" else scores * m
    padded = torch.matmul(torch.softmax(scores, dim=-1), vp)
    assert torch.count_nonzero(padded[..., d:]) == 0
    want = masked_attention_plain(q, k, v, mask, mode=mode)
    torch.testing.assert_close(padded[..., :d], want, atol=2e-6, rtol=0)
