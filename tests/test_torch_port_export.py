"""Port parity, the export (M9): `export_final`, `load_exported` and `serve
--artifact` of the port against the JAX package's, on the CPU.

Each exportable net kind gets a mini experiment (the port tests' mini ViT
at 16 px and mini BERT at T = 16) whose final is drawn from a seed by the
JAX package's own `init_final` and saved as the JAX npz checkpoint both
packages load.  The port's default artifact (the plain math, one file for
cuda and cpu) is held at 1e-6 absolute against the port's live
`fw_final` in the same arithmetic (pallas mode "0"), and at 1e-5 absolute
against the JAX package's live `fw_final` and its own artifact
(`export_final(..., platforms=["cpu"])`) on the same checkpoint.

The `--kernels` program is traced here on the CPU: its graph holds one
`autognothi::*` custom op per kernel launch of the live path (counted by
patching each ops module's `dispatch`), and runs through the ops' CPU
registrations (the plain versions) to the live CPU output, exactly; the
loader refuses it on the CPU.  The fake implementation of each of the
twelve ops gives the plain version's shapes and dtypes at two shapes.
The BERT kinds, the both-platforms file and the CLI verb are in
tests/test_torch_port_export_bert.py; the card's side is in
tests/test_torch_port_cuda.py.
"""

import collections
import io
import json
import os
import pathlib
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from autognothi_tpu_torch.data import tokenizer as p_tok
from autognothi_tpu_torch.models.common import pallas_override
from tests.test_ltt_e2e import _ltt_vit_hparams
from tests.test_torch_port_bert_train import ltt_bert_hparams
from tests.test_torch_port_reports import ENV_KEYS
from tests.test_torch_port_vanilla import VOCAB, bert_hparams, vit_hparams

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL_JAX, TOL_PORT = 1e-5, 1e-6
B = 2


def _kind(hp: dict, kind: str) -> dict:
    hp["net"]["kind"] = kind
    return hp


HPARAMS = {
    "ltt_vit": _ltt_vit_hparams,
    "vanilla_vit": vit_hparams,
    "froyo_vit": lambda: _kind(vit_hparams(), "froyo_vit"),
    "duo_vanilla_vit": lambda: _kind(vit_hparams(), "duo_vanilla_vit"),
    "ltt_bert": ltt_bert_hparams,
    "vanilla_bert": bert_hparams,
    "froyo_bert": lambda: _kind(bert_hparams(), "froyo_bert"),
    "duo_vanilla_bert": lambda: _kind(bert_hparams(), "duo_vanilla_bert"),
}
VIT_KINDS = [k for k in HPARAMS if k.endswith("vit")]
BERT_KINDS = [k for k in HPARAMS if k.endswith("bert")]


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)


def write_final_exp(root: pathlib.Path, kind: str, seed: int = 0,
                    hp: dict = None) -> pathlib.Path:
    """A mini experiment of `kind` whose final the JAX package initialised
    from `seed` (a non-zero null), saved as its npz checkpoint."""
    from autognothi_tpu.pipeline.config import ExpConfig
    from autognothi_tpu.pipeline.resources import get_recipe, save_params

    hp = hp or HPARAMS[kind]()
    exp = root / f"{kind}_{seed}"
    exp.mkdir(parents=True)
    if kind.endswith("bert"):
        p_tok.WordPieceTokenizer(VOCAB).save(exp / "tokenizer")
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    recipe, cfg = get_recipe(ExpConfig.model_validate(hp))
    flat = {k: np.asarray(v) for k, v in
            recipe.init_final(jax.random.PRNGKey(seed), cfg).items()}
    if "surrogate_null" in flat:
        flat["surrogate_null"] = flat["surrogate_null"] + np.linspace(
            0.1, 0.2, flat["surrogate_null"].shape[-1], dtype=np.float32)
    save_params(exp / "final-epoch-0.ckpt", flat)
    return exp


def inputs(kind: str, exp: pathlib.Path, b: int = B, seed: int = 0):
    """b rows of the model's input: images, or real sentences tokenized
    (with padding) by the experiment's vocabulary."""
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.resources import get_recipe, load_misc

    rng = np.random.RandomState(seed)
    if kind.endswith("vit"):
        return rng.randn(b, 3, 16, 16).astype(np.float32)
    texts = [s["inputs"] for s in json.loads(
        (REPO / "autognothi_tpu_torch/data/nlp_samples.json").read_text())]
    with ExpEnv(exp) as env:
        recipe, cfg = get_recipe(env.config)
        gen = recipe.gen_input(cfg, load_misc(env, recipe, cfg))
        return gen([texts[i] for i in rng.choice(len(texts), b)], [0] * b)[0]


def port_live(exp: pathlib.Path, xs, pallas: str = "0"):
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.resources import (get_recipe,
                                                         load_epoch_model)

    with ExpEnv(exp) as env:
        recipe, cfg = get_recipe(env.config)
        _, model = load_epoch_model(env, recipe, "final", CPU)
    with torch.inference_mode(), pallas_override(pallas):
        return recipe.fw_final(cfg, model, torch.as_tensor(xs))


def jax_live_and_artifact(exp: pathlib.Path, xs, art: pathlib.Path):
    """(the JAX package's live fw_final, its artifact's) on xs."""
    from autognothi_tpu.pipeline.env import ExpEnv
    from autognothi_tpu.pipeline.export import export_final, load_exported
    from autognothi_tpu.pipeline.resources import get_recipe, load_epoch_model

    env = ExpEnv(exp)
    recipe, cfg = get_recipe(env.config)
    _, params = load_epoch_model(env, recipe, "final")
    live = recipe.fw_final(cfg, params, xs)
    export_final(env, art, batch_size=len(xs), platforms=["cpu"])
    return live, load_exported(art)(xs)


def port_export(exp: pathlib.Path, art: pathlib.Path, **kw) -> dict:
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.export import export_final

    kw.setdefault("device", "cpu")
    with ExpEnv(exp) as env:
        return export_final(env, art, **kw)


def close(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        err = float(np.abs(g - w).max())
        assert err <= tol, (what, i, err)


def round_trip(kind: str, tmp_path: pathlib.Path) -> None:
    """Kind's mini final through the port's default artifact, against the
    port's live path, the JAX package's and the JAX package's artifact."""
    from autognothi_tpu_torch.pipeline.export import load_exported

    exp = write_final_exp(tmp_path, kind)
    xs = inputs(kind, exp)
    meta = port_export(exp, tmp_path / "final.agx", batch_size=B)
    assert meta["platforms"] == ["cuda", "cpu"] and not meta["kernels"]
    assert meta["in_shape"] == [B, *xs.shape[1:]]
    assert meta["bytes"] == (tmp_path / "final.agx").stat().st_size
    fw = load_exported(tmp_path / "final.agx", device="cpu")
    got = [o.numpy() for o in fw(xs)]
    close(got, port_live(exp, xs), TOL_PORT, "port live")
    j_live, j_art = jax_live_and_artifact(exp, xs, tmp_path / "final.jaxexp")
    close(got, j_live, TOL_JAX, "JAX live")
    close(got, j_art, TOL_JAX, "JAX artifact")
    # a wrong batch on a fixed-batch artifact raises
    with pytest.raises(Exception):
        fw(np.concatenate([xs, xs[:1]]))


@pytest.mark.parametrize("kind", VIT_KINDS)
def test_round_trip_every_net_kind(kind, tmp_path):
    round_trip(kind, tmp_path)


def test_symbolic_batch_serves_any_batch(tmp_path):
    from autognothi_tpu_torch.pipeline.export import load_exported

    exp = write_final_exp(tmp_path, "ltt_vit")
    meta = port_export(exp, tmp_path / "sym.agx", batch_size=0)
    assert meta["batch_size"] == "symbolic"
    assert meta["in_shape"] == ["batch", 3, 16, 16]
    fw = load_exported(tmp_path / "sym.agx", device="cpu")
    assert fw.in_shape == (None, 3, 16, 16)
    for b in (1, 3, 5):
        xs = inputs("ltt_vit", exp, b, seed=b)
        probs, attr = fw(xs)
        assert probs.shape == (b, 3) and attr.shape == (b, 3, 4)
        close((probs, attr), port_live(exp, xs), TOL_PORT, f"B = {b}")


def _program(path: pathlib.Path):
    from autognothi_tpu_torch.kernels import library  # noqa: F401
    from autognothi_tpu_torch.pipeline.export import _unpack

    program, meta = _unpack(path.read_bytes())
    return torch.export.load(io.BytesIO(program)), meta


def test_weights_are_runtime_arguments(tmp_path):
    """Artifact A on checkpoint B's weights is the live model B; no
    constant of either program (the default and the W8A8 kernel one) has a
    weight's shape."""
    from autognothi_tpu_torch.pipeline.export import load_exported
    from autognothi_tpu_torch.pipeline.resources import load_params_file

    exp_a = write_final_exp(tmp_path, "ltt_vit", seed=1)
    exp_b = write_final_exp(tmp_path, "ltt_vit", seed=2)
    port_export(exp_a, tmp_path / "a.agx", batch_size=B)
    fw = load_exported(tmp_path / "a.agx", device="cpu")
    xs = inputs("ltt_vit", exp_a)
    weights_b = {k: torch.as_tensor(v) for k, v in
                 load_params_file(exp_b / "final-epoch-0.ckpt").items()}
    assert set(weights_b) == set(fw.params)
    got_b = fw.pcall(weights_b, xs)
    close(got_b, port_live(exp_b, xs), TOL_PORT, "A on B's weights")
    assert float((got_b[1] - fw(xs)[1]).abs().max()) > 1e-3
    shapes = {tuple(v.shape) for v in weights_b.values() if v.dim() > 0}
    with mock.patch.dict(os.environ, {"AUTOGNOTHI_INT8": "1"}):
        port_export(exp_a, tmp_path / "k.agx", batch_size=B, kernels=True,
                    platforms=["cuda"])
    for art in ("a.agx", "k.agx"):
        ep, _ = _program(tmp_path / art)
        assert len(ep.state_dict) == len(weights_b)
        assert not [k for k, v in ep.constants.items()
                    if tuple(v.shape) in shapes], art


def _counting_dispatch(counts: collections.Counter):
    """Patch every ops module's `dispatch` to count each launch of the live
    path under its op's name (the CPU runs the plain versions)."""
    from autognothi_tpu_torch.kernels import library, primitives
    from autognothi_tpu_torch.ops import (attention_block, flash_attention,
                                          head_block, ladder_block, mlp_block)

    real = primitives.dispatch

    def counted(launch, plain, counter, tensors, static, grad=None):
        if not torch.compiler.is_exporting():
            counts[library.op_name(launch)] += 1
        return real(launch, plain, counter, tensors, static, grad)

    stack = [mock.patch.object(m, "dispatch", counted)
             for m in (attention_block, flash_attention, head_block,
                       ladder_block, mlp_block)]
    return stack


KERNEL_CASES = {
    # (kind, AUTOGNOTHI_INT8, JAX budget): the LTT ViT W8A8 and fp32 slabs;
    # the LTT BERT W8A8 under a lowered budget, whose trunk MLP is the
    # 2-tile K8q chain between the chain LNs and whose trunk attention is
    # the float block (the JAX gates, as at BERT-base@512)
    "ltt_vit_int8": ("ltt_vit", "1", None),
    "ltt_vit_fp32": ("ltt_vit", "0", None),
    "ltt_bert_int8": ("ltt_bert", "1", 16000),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_kernels_graph_holds_the_live_launches(case, tmp_path,
                                               monkeypatch):
    from autognothi_tpu_torch.ops import gates
    from autognothi_tpu_torch.pipeline.export import load_exported

    kind, int8, budget = KERNEL_CASES[case]
    monkeypatch.setenv("AUTOGNOTHI_INT8", int8)
    if budget is not None:
        monkeypatch.setattr(gates, "VMEM_BUDGET_BYTES", budget)
    exp = write_final_exp(tmp_path, kind)
    xs = inputs(kind, exp)
    meta = port_export(exp, tmp_path / "k.agx", batch_size=B, kernels=True,
                       platforms=["cuda"])
    assert meta["quant"] == ("int8" if int8 == "1" else "none")
    assert meta["platforms"] == ["cuda"] and meta["kernels"]
    ep, _ = _program(tmp_path / "k.agx")
    in_graph = collections.Counter(
        str(n.target).split(".")[1] for n in ep.graph.nodes
        if n.op == "call_function" and str(n.target).startswith(
            "autognothi."))
    live = collections.Counter()
    patches = _counting_dispatch(live)
    for p in patches:
        p.start()
    try:
        want = port_live(exp, xs, pallas="2")
    finally:
        for p in patches:
            p.stop()
    assert in_graph == live and sum(live.values()) > 0, (in_graph, live)
    if budget is not None:
        assert live["mlp_block_int8_tiled"] == 2 * 2  # 2 layers x 2 tiles
        assert live["chain_layer_norm"] == 2
    # the ops' CPU registrations are the plain versions: the live output
    with torch.inference_mode():
        got = ep.module()(torch.as_tensor(xs))
    close(got, want, 0.0, "kernel program on the CPU")
    with pytest.raises(ValueError, match="cuda"):
        load_exported(tmp_path / "k.agx", device="cpu")


# ------------------------------------------------------ the twelve ops


def _op_args(name: str, rng: np.random.RandomState, b: int, t: int):
    """(tensors, static) of op `name` at batch b, t tokens, from the ops'
    own `*_args` functions."""
    from autognothi_tpu_torch.ops import (attention_block as ab,
                                          head_block as hb,
                                          ladder_block as lb,
                                          mlp_block as mb)

    def r(*shape, scale=0.2):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32))

    h, heads, s, inter = 32, 4, 16, 64
    mask = torch.ones(b, t)
    block = [r(h, h), r(h), r(h, h), r(h), r(h, h), r(h), r(h, h), r(h)]
    ln = (1 + r(h), r(h), 1e-12)

    def branch(hin):
        w = {"map_w": r(s, hin), "map_b": r(s), "ln1_w": 1 + r(s),
             "ln1_b": r(s), "wq": r(s, s), "bq": r(s), "wk": r(s, s),
             "bk": r(s), "wv": r(s, s), "bv": r(s), "wo": r(s, s),
             "bo": r(s), "ln2_w": 1 + r(s), "ln2_b": r(s),
             "w1": r(2 * s, s), "b1": r(2 * s), "w2": r(s, 2 * s),
             "b2": r(s)}
        return w

    x = r(b, t, h, scale=1.0)
    sides = [r(b, t, s, scale=1.0) for _ in range(2)]
    if name in ("attention_block", "attention_block_int8"):
        return ab.attention_block_args(x, mask, block, heads, "mul", ln,
                                       "prologue")
    if name in ("mlp_block", "mlp_block_int8"):
        return mb.mlp_block_args(x, r(inter, h), r(inter), r(h, inter), r(h),
                                 ln, "epilogue")
    if name in ("mlp_block_tiled", "mlp_block_int8_tiled"):
        return (x, r(b, t, h), r(inter // 2, h), r(inter // 2),
                r(h, inter // 2), r(h)), {}
    if name == "chain_layer_norm":
        return (x, 1 + r(h), r(h)), dict(eps=1e-12)
    if name == "ladder_block":
        return lb.ladder_block_args(x, sides, mask, [branch(h)] * 2, 2,
                                    "add", False, 1e-12)
    if name == "mlp_ladder_block":
        trunk = dict(zip(lb.TRUNK_MLP_KEYS, (r(inter, h), r(inter),
                                             r(h, inter), r(h), 1 + r(h),
                                             r(h))))
        return lb.mlp_ladder_block_args(x, sides, mask, trunk,
                                        [branch(h)] * 2, 2, "mul", 1e-12)
    if name == "ladder_attention":
        qkv = [r(b, t, s, scale=1.0) for _ in range(6)]
        return (mask, *qkv), dict(n_heads=2, mode="mul")
    if name == "head_block":
        return hb.explainer_head_block_args(x, r(inter, h), r(inter),
                                            r(inter, inter), r(inter),
                                            r(3, inter), r(3), 1 + r(h),
                                            r(h), 1e-12)
    if name == "masked_attention":
        q, k, v = (r(b, heads, t, 8, scale=1.0) for _ in range(3))
        return (q, k, v, torch.zeros(b, t)), dict(mode="add")
    raise KeyError(name)


@pytest.mark.parametrize("b,t", [(2, 5), (3, 17)])
def test_every_op_fake_and_cpu_registration(b, t):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from autognothi_tpu_torch.kernels import library

    assert len(library.OPS) == 12
    for name, op in library.OPS.items():
        tensors, static = _op_args(name, np.random.RandomState(b * t), b, t)
        _, plain, _ = op.resolve()
        want = plain(*tensors, **static)
        want = list(want) if isinstance(want, tuple) else [want]
        custom = getattr(torch.ops.autognothi, name)
        got = custom(list(tensors), **static)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert torch.equal(g, w), name
        with FakeTensorMode() as mode:
            fakes = custom([mode.from_tensor(x) for x in tensors], **static)
        assert [(tuple(f.shape), f.dtype) for f in fakes] == \
            [(tuple(w.shape), w.dtype) for w in want], name


# -------------------------------------------------- serve and refusals


def test_serve_from_the_artifact(tmp_path):
    """`images` and `images_u8` through an artifact-backed service equal
    the checkpoint-backed service's; the fixed-batch artifact sets the slab
    size, a symbolic one keeps the requested size."""
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import ExplainService

    exp = write_final_exp(tmp_path, "ltt_vit")
    port_export(exp, tmp_path / "b2.agx", batch_size=2)
    port_export(exp, tmp_path / "sym.agx", batch_size=0)
    rng = np.random.RandomState(3)
    payloads = [{"images": rng.randn(3, 3, 16, 16).tolist()},
                {"images_u8": rng.randint(0, 256, (3, 3, 16, 16)).tolist()}]
    with ExpEnv(exp) as env:
        live = ExplainService(env, batch_size=4, device="cpu")
        art = ExplainService(env, batch_size=4, device="cpu",
                             artifact=tmp_path / "b2.agx")
        sym = ExplainService(env, batch_size=4, device="cpu",
                             artifact=tmp_path / "sym.agx")
        try:
            assert (live.batch_size, art.batch_size, sym.batch_size) == \
                (4, 2, 4)
            assert art.model is None
            art.warmup()
            for payload in payloads:
                want = live.explain(payload)
                for service in (art, sym):
                    got = service.explain(payload)
                    for key in ("logits", "attributions"):
                        np.testing.assert_allclose(got[key], want[key],
                                                   atol=TOL_PORT, rtol=0)
        finally:
            for service in (live, art, sym):
                service.close()
        assert "serving artifact" in (exp / ".log.txt").read_text()


def test_fail_closed(tmp_path):
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.export import load_exported
    from autognothi_tpu_torch.pipeline.serve import ExplainService
    from tests.test_bert_e2e import make_bert_hparams

    exp = write_final_exp(tmp_path, "ltt_vit")
    port_export(exp, tmp_path / "a.agx", batch_size=2)
    # an artifact of another experiment's rows refuses at startup
    hp = _ltt_vit_hparams()
    hp["net"]["params"]["img_px_size"] = 24
    other = write_final_exp(tmp_path, "ltt_vit", seed=5, hp=hp)
    with ExpEnv(other) as env:
        with pytest.raises(RuntimeError, match="different experiment"):
            ExplainService(env, artifact=tmp_path / "a.agx", device="cpu")
    # the JAX package's artifact, by its magic
    (tmp_path / "j.jaxexp").write_bytes(b"AGTPEXP1" + b"\0" * 64)
    with pytest.raises(ValueError, match="JAX package"):
        load_exported(tmp_path / "j.jaxexp", device="cpu")
    (tmp_path / "junk.agx").write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="bad magic"):
        load_exported(tmp_path / "junk.agx", device="cpu")
    # KernelSHAP's final runs on the host: refused before any checkpoint
    hp = make_bert_hparams(len(VOCAB))
    hp["net"]["kind"] = "kernel_shap_bert"
    hp["net"]["params"].update(kernel_shap_n_samples=64,
                               kernel_shap_data_size=3)
    ks = tmp_path / "ks"
    ks.mkdir()
    (ks / ".hparams.json").write_text(json.dumps(hp))
    with pytest.raises(SystemExit, match="host"):
        port_export(ks, tmp_path / "ks.agx", batch_size=2)
    # --kernels needs a fixed batch and --platforms cuda
    with pytest.raises(SystemExit, match="fixed --batch-size"):
        port_export(exp, tmp_path / "x.agx", batch_size=0, kernels=True,
                    platforms=["cuda"])
    for platforms in (["cuda", "cpu"], ["cpu"]):
        with pytest.raises(SystemExit, match="--platforms cuda"):
            port_export(exp, tmp_path / "x.agx", kernels=True,
                        platforms=platforms)
    with pytest.raises(SystemExit, match="--platforms"):
        port_export(exp, tmp_path / "x.agx", platforms=["tpu"])
    # a mesh-sharded artifact needs a fixed batch that N divides
    with pytest.raises(SystemExit, match="not divisible by --data-parallel"):
        port_export(exp, tmp_path / "x.agx", batch_size=3, data_parallel=2)
    with pytest.raises(SystemExit, match="cannot be mesh-sharded"):
        port_export(exp, tmp_path / "x.agx", batch_size=0, data_parallel=2)
    assert not (tmp_path / "x.agx").exists()
    assert not list(tmp_path.glob("*.tmp"))


def test_data_parallel_artifact_over_two_ranks(tmp_path):
    """`export_final --data-parallel 2` (JAX tests/test_export.py:96, :223,
    :276): the program runs batch / 2 rows; two gloo ranks each run theirs
    and gather the one-device live rows; `serve --artifact` on rank 0, with
    rank 1 following, answers as the one-device service; a world of one
    refuses the artifact."""
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.export import load_exported
    from autognothi_tpu_torch.pipeline.serve import ExplainService
    from tests.test_torch_port_scaleout import run_world

    exp = write_final_exp(tmp_path, "ltt_vit")
    art = tmp_path / "dp2.agx"
    meta = port_export(exp, art, batch_size=4, data_parallel=2)
    assert meta["nr_devices"] == 2 and meta["in_shape"] == [4, 3, 16, 16]
    with pytest.raises(ValueError, match="2 devices"):
        load_exported(art, device="cpu")
    xs = inputs("ltt_vit", exp, b=4, seed=3)
    spec = dict(tag="artifact", jobs=["artifact"], artifact=str(art),
                exp=str(exp), call=xs.tolist(), payload=xs[:3].tolist())
    ranks = run_world(spec, 2, tmp_path)
    want = port_live(exp, xs)
    with ExpEnv(exp) as env:
        service = ExplainService(env, batch_size=4, device="cpu")
        try:
            served = service.explain({"images": xs[:3].tolist()})
        finally:
            service.close()
    for info, arr in ranks:
        close((arr["artifact/probs"], arr["artifact/attr"]), want, TOL_PORT,
              "dp2 artifact")
        assert info["artifact/batch_size"] == 4  # the artifact's slab
    info0, arr0 = ranks[0]
    close((arr0["served/logits"], arr0["served/attr"]),
          (served["logits"], served["attributions"]), TOL_PORT, "served")
    # one explained slab: a header and the slab out, the outputs in
    assert info0["served/counts"] == {"broadcast": 2, "all_gather": 2}
    assert ranks[1][0]["followed_slabs"] == 3  # two warmup slabs + one
