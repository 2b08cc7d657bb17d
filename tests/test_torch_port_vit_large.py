"""Port parity at ViT-L/16@224 widths: a vanilla ViT final with hidden
1024, 16 heads, MLP 4096 and a 4096-wide explainer head, 224 px in 16 px
patches (T = 197), one layer a tower, B = 2, against the JAX package's
final on the same parameters and pixels.

At these widths the JAX budget gates (`ops/gates.py`, held against the
JAX functions in tests/test_torch_port_bert.py at "vit-l@197") send the
blocks down the routes the served ViT-L takes on the card, and the test
pins them with spies on the port's ops: in fp32 the MLP is one K7 block
(the JAX op's 4-tile float split is the same function) and the attention
K6 (the JAX op computes its XLA block: the weights do not fit); in W8A8
with fp32 parameters the attention is K1 and the MLP the 2-tile K8q
chain; the explainer head is the eager W8A8 denses (no token tile of the
fused head fits), never K3.

Tolerances, x max(1, max|ref|): fp32 1e-5 against the JAX XLA math (mode
"0") and against the JAX ops in mode "2" (their kernels interpreted);
W8A8 2e-5 where every per-token int8 code agrees between the packages,
1e-2 where one flipped (the `int8_codes` recorder of tests/
test_torch_port_bert.py).
"""

import copy
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autognothi_tpu.recipes import vanilla_vit as j_vv
from autognothi_tpu_torch.models import vit as p_vit
from autognothi_tpu_torch.ops import mlp_block as p_mb
from autognothi_tpu_torch.params import from_jax_params
from autognothi_tpu_torch.recipes import vanilla_vit as p_vv
from tests.test_torch_port_bert import int8_codes  # noqa: F401 (fixture)
from tests.test_torch_port_vanilla import SETTINGS, _codes_agree, _env, _np

REPO = pathlib.Path(__file__).resolve().parents[1]
B = 2
TOL_FP32, TOL_INT8, TOL_FLIPPED = 1e-5, 2e-5, 1e-2


def vit_large_params() -> dict:
    """The shipped ViT-L experiment's `net.params`, one layer a tower,
    dropout 0."""
    hp = json.loads((REPO / "experiments" / "vit_large_imagenette_vanilla"
                     / ".hparams.json").read_text())
    return dict(hp["net"]["params"], num_hidden_layers=1,
                attention_probs_dropout_prob=0.0, hidden_dropout_prob=0.0)


@pytest.fixture(scope="module")
def case():
    params = vit_large_params()
    jr, pr = j_vv.vanilla_vit_recipe(), p_vv.vanilla_vit_recipe()
    jc, pc = jr.t_config(**params), pr.t_config(**params)
    assert (pc.hidden_size, pc.num_attention_heads, pc.intermediate_size,
            pc.explainer_head_hidden_size, pc.img_px_size) == \
        (1024, 16, 4096, 4096, 224)
    fin = _np(jr.init_final(jax.random.PRNGKey(15), jc))
    fin["surrogate_null"] = np.linspace(0.05, 0.15, 10, dtype=np.float32)[None]
    xs = np.random.RandomState(15).rand(B, 3, 224, 224).astype(np.float32)
    model = from_jax_params(fin, pc, torch.device("cpu"), section="final")
    return jr, jc, pr, pc, fin, xs, model


class Spies:
    """The port's routes: the MLP tiles of each chain, the fused head's
    calls and the eager head denses."""

    def __init__(self, monkeypatch):
        self.tiles, self.k3, self.denses = [], 0, 0
        tiled, head, dense = p_mb._tiled, p_vit.explainer_head_block, \
            p_vit.dense_serving

        def spy_tiled(*args, n_tiles, **kwargs):
            self.tiles.append(n_tiles)
            return tiled(*args, n_tiles=n_tiles, **kwargs)

        def spy_head(*args, **kwargs):
            self.k3 += 1
            return head(*args, **kwargs)

        def spy_dense(*args, **kwargs):
            self.denses += 1
            return dense(*args, **kwargs)

        monkeypatch.setattr(p_mb, "_tiled", spy_tiled)
        monkeypatch.setattr(p_vit, "explainer_head_block", spy_head)
        monkeypatch.setattr(p_vit, "dense_serving", spy_dense)


def _held(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    lim = tol * max(1.0, float(np.abs(want).max()))
    assert err <= lim, (what, err, lim)
    return err


@pytest.mark.parametrize("setting", ["mode0", "mode2", "mode2_int8"])
def test_vit_large_final_matches_jax(case, setting, int8_codes,  # noqa
                                     monkeypatch):
    jr, jc, pr, pc, fin, xs, model = case
    jax_env, port_env, _ = SETTINGS[setting]
    with _env(jax_env):
        want = jr.fw_final(jc, {k: jnp.asarray(v) for k, v in fin.items()},
                           jnp.asarray(xs))
    spies = Spies(monkeypatch)
    with _env(port_env), torch.no_grad():
        got = pr.fw_final(pc, model, torch.from_numpy(xs))
    tol = TOL_FP32
    if setting == "mode2_int8":
        tol = TOL_INT8 if _codes_agree() else TOL_FLIPPED
        # 4 towers' layers (3 towers of 1, the explainer's layer), each
        # MLP the 2-tile K8q chain; the head's two int8 denses eagerly
        assert spies.tiles == [2] * 4
        assert spies.k3 == 0 and spies.denses == 2
    else:
        # fp32: one K7 block per layer (no chain), the float head
        assert spies.tiles == [] and spies.k3 == 0
    assert got[1].shape == (B, 10, 196)
    for name, g, w in zip(("probs", "attr"), got, want):
        _held(g.numpy(), w, tol, name)


def test_vit_large_routes_on_the_bf16_paths(case, monkeypatch):
    """The bf16 routes of the served ViT-L (the card holds them against
    plain): W8A8 with bf16 parameters one K4 block a layer, bf16 without
    int8 the 2-tile K8 chain; the forward runs and is finite."""
    _, _, pr, pc, _, xs, model = case
    m16 = copy.deepcopy(model).to(torch.bfloat16)
    x16 = torch.from_numpy(xs).to(torch.bfloat16)
    for int8, tiles in (("1", []), ("0", [2] * 4)):
        spies = Spies(monkeypatch)
        with _env({"AUTOGNOTHI_INT8": int8}), torch.no_grad():
            probs, attr = pr.fw_final(pc, m16, x16)
        assert spies.tiles == tiles and spies.k3 == 0
        assert torch.isfinite(attr.float()).all()
        assert abs(float(probs.float().sum()) - B) < 1e-2
