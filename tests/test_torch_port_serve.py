"""Port parity, the served slice: the JAX server and the port's server on
the CPU load the same JAX-written `final-epoch-0.ckpt` of a mini LTT ViT
and answer the same `images` / `images_u8` requests; logits and
attributions agree to atol 1e-5.  Plus the port's serving contract: its
import graph is free of JAX, it never falls back from CUDA to the CPU, it
drains on SIGTERM, an artifact for more devices than the world has is
refused, an unknown net kind names itself, and slabs replay as CUDA
graphs only where the rule says (a CPU service runs every slab eagerly,
and a replayed slab's outputs are copies the next replay cannot
overwrite)."""

import json
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tests.test_ltt_e2e import _ltt_vit_hparams

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=0)


def _write_exp(root: pathlib.Path) -> pathlib.Path:
    from autognothi_tpu.models.ltt_vit import LttViTConfig, init_ltt_vit_final
    from autognothi_tpu.pipeline.resources import save_params

    exp = root / "ltt_vit"
    exp.mkdir()
    hp = _ltt_vit_hparams()
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    params = init_ltt_vit_final(jax.random.PRNGKey(0),
                                LttViTConfig(**hp["net"]["params"]))
    params["surrogate_null"] = params["surrogate_null"] + 0.25
    save_params(exp / "final-epoch-0.ckpt", params)
    return exp


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from autognothi_tpu.pipeline.env import ExpEnv as JaxEnv
    from autognothi_tpu.pipeline.serve import serve_in_thread as jax_serve
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import serve_in_thread

    exp = _write_exp(tmp_path_factory.mktemp("port_serve"))
    j_server, j_service, _ = jax_serve(JaxEnv(exp), port=0, batch_size=2)
    env = ExpEnv(exp)
    p_server, p_service, _ = serve_in_thread(env, port=0, batch_size=2,
                                             device="cpu")
    yield j_server, p_server
    for server, service in ((j_server, j_service), (p_server, p_service)):
        server.shutdown()
        server.server_close()
        service.close()
    env.close()


def _url(server, path):
    host, port = server.server_address
    return f"http://{host}:{port}{path}"


def _post(server, payload):
    req = urllib.request.Request(
        _url(server, "/explain"), data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


@pytest.mark.parametrize("field,n_rows", [("images", 3), ("images_u8", 5)])
def test_port_server_matches_jax_server(servers, field, n_rows):
    j_server, p_server = servers
    rng = np.random.RandomState(n_rows)
    if field == "images":
        rows = rng.randn(n_rows, 3, 16, 16).astype(np.float32).tolist()
    else:
        rows = rng.randint(0, 256, (n_rows, 3, 16, 16)).tolist()
    j_status, want = _post(j_server, {field: rows})
    p_status, got = _post(p_server, {field: rows})
    assert (j_status, p_status) == (200, 200)
    logits, attr = np.asarray(got["logits"]), np.asarray(got["attributions"])
    assert logits.shape == (n_rows, 3) and attr.shape == (n_rows, 3, 4)
    np.testing.assert_allclose(logits.sum(-1), np.ones(n_rows), atol=1e-5)
    np.testing.assert_allclose(logits, np.asarray(want["logits"]), **TOL)
    np.testing.assert_allclose(attr, np.asarray(want["attributions"]), **TOL)


def test_port_server_health_stats_and_bad_payloads(servers):
    _, p_server = servers
    with urllib.request.urlopen(_url(p_server, "/healthz"), timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok"}
    status, body = _post(p_server, {"bogus": 1})
    assert status == 400 and "texts" in body["error"]
    status, body = _post(p_server, {"images": np.zeros((1, 3, 8, 8)).tolist()})
    assert status == 400 and "rows must be shaped" in body["error"]
    status, body = _post(p_server, {"images": []})
    assert status == 200 and body == {"logits": [], "attributions": []}
    with urllib.request.urlopen(_url(p_server, "/statz"), timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["batch_size"] == 2 and stats["slabs"] >= 1


@pytest.mark.parametrize("device,followed,artifact,host_final,want", [
    ("cuda", False, None, False, True),
    ("cpu", False, None, False, False),
    ("cuda", True, None, False, False),     # a data-parallel world
    ("cuda", False, "final.agx", False, False),
    ("cuda", False, None, True, False),     # KernelSHAP's host final
])
def test_slabs_replay_only_for_a_live_final_on_one_card(
        device, followed, artifact, host_final, want):
    from autognothi_tpu_torch.pipeline.serve import replays_slabs

    assert replays_slabs(torch.device(device), followed, artifact,
                         host_final) is want


def test_cpu_service_runs_every_slab_eagerly_and_statz_counts_them(
        tmp_path):
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import serve_in_thread

    exp = _write_exp(tmp_path)
    rng = np.random.RandomState(8)
    with ExpEnv(exp) as env:
        server, service, _ = serve_in_thread(env, port=0, batch_size=2,
                                             device="cpu")
        try:
            assert not service.replays
            for n in (1, 3, 2):  # 1 + 2 + 1 slabs of 2
                rows = rng.randint(0, 256, (n, 3, 16, 16)).tolist()
                assert _post(server, {"images_u8": rows})[0] == 200
            with urllib.request.urlopen(_url(server, "/statz"),
                                        timeout=30) as r:
                stats = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
            service.close()
    assert stats["slabs"] == 4
    # warmup's two: the null slab and its u8 form, once each
    assert {k: stats[k] for k in ("graph_captures", "graph_replays",
                                  "eager_slabs", "graph_fallbacks")} == {
        "graph_captures": 0, "graph_replays": 0, "eager_slabs": 4 + 2,
        "graph_fallbacks": 0}


class _OneBufferGraph:
    """A captured graph's stand-in: each replay writes its static input,
    doubled, into the one static output buffer."""

    def __init__(self, static_in: torch.Tensor, out: torch.Tensor):
        self.static_in, self.out = static_in, out

    def replay(self):
        self.out.copy_(self.static_in.reshape(-1) * 2)


@pytest.mark.parametrize("copies", [True, False])
def test_replayed_outputs_are_copies_that_the_next_replay_leaves(copies):
    """Through `MicroBatcher` at depth 2 the completer fetches slab n only
    after slab n + 1 was replayed (the fetch waits for it here): the host
    copy `SlabGraph.replay` returns keeps each slab's rows, while the
    graph's static outputs would hand slab n the rows of slab n + 1."""
    from autognothi_tpu_torch.pipeline.batching import MicroBatcher
    from autognothi_tpu_torch.pipeline.serve import (SlabGraph, SlabOutputs,
                                                     fetch)

    static_in, flat = torch.zeros(4, 3), torch.zeros(12)
    graph = SlabGraph(_OneBufferGraph(static_in, flat), static_in, flat,
                      ((4, 3),))
    n_slabs = 4
    cv = threading.Condition()
    runs, fetches = [0], [0]

    def run_slab(slab):
        graph.load(slab)
        if copies:
            outs = graph.replay()
        else:
            graph.graph.replay()
            outs = SlabOutputs(graph.flat, graph.shapes)
        with cv:
            runs[0] += 1
            cv.notify_all()
        return outs

    def finalize(outs):
        with cv:
            assert cv.wait_for(
                lambda: runs[0] >= min(fetches[0] + 2, n_slabs), timeout=60)
            fetches[0] += 1
        return tuple(o.copy() for o in fetch(outs))

    batcher = MicroBatcher(run_slab, 4, window_s=0.0, depth=2,
                           finalize=finalize)
    got = {}

    def client(i):
        got[i] = batcher.submit(np.full((4, 3), i, np.float32))[0]

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_slabs)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        batcher.close()
    own = [np.array_equal(got[i], np.full((4, 3), 2 * i, np.float32))
           for i in range(n_slabs)]
    assert all(own) if copies else not all(own), own


def test_fetch_splits_a_replayed_slab_as_the_eager_outputs():
    """A replayed slab's one flat buffer comes back as the eager path's
    outputs: each output's float32 values in its own shape."""
    from autognothi_tpu_torch.pipeline.serve import SlabOutputs, fetch

    g = torch.Generator().manual_seed(9)
    outs = (torch.randn(4, 3, generator=g),
            torch.randn(4, 5, 2, generator=g).to(torch.bfloat16))
    packed = SlabOutputs(torch.cat([o.float().reshape(-1) for o in outs]),
                         tuple(tuple(o.shape) for o in outs))
    want, got = fetch(outs), fetch(packed)
    assert len(got) == 2
    for w, g_ in zip(want, got):
        assert g_.dtype == np.float32 and np.array_equal(w, g_)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int64])
def test_slab_graph_loads_each_slab_through_its_staging_buffer(dtype):
    """Each loaded slab lands in the graph's static input, whatever its
    dtype, by way of a staging buffer of its own; a replay's outputs are
    a fresh host tensor, with no event to wait for off a card."""
    from autognothi_tpu_torch.pipeline.serve import SlabGraph

    static_in = torch.zeros(2, 3, dtype=torch.from_numpy(
        np.zeros(0, dtype)).dtype)
    flat = torch.zeros(6)
    graph = SlabGraph(_OneBufferGraph(static_in, flat), static_in, flat,
                      ((2, 3),))
    assert graph.staging.data_ptr() != static_in.data_ptr()
    firsts = []
    for i in (1, 2):
        slab = np.full((2, 3), 7 * i, dtype)
        graph.load(slab)
        assert np.array_equal(static_in.numpy(), slab)
        outs = graph.replay()
        assert outs.done is None
        assert outs.flat.data_ptr() != flat.data_ptr()
        firsts.append(outs)
    assert [float(o.fetch()[0][0, 0]) for o in firsts] == [14.0, 28.0]


def test_import_graph_is_free_of_jax_and_the_jax_package():
    # every module of the port, imported in one fresh interpreter
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (REPO / "autognothi_tpu_torch").rglob("*.py")
        if p.name != "__main__.py")
    assert "autognothi_tpu_torch.pipeline.train_all" in mods
    for new in ("pipeline.measure_all", "pipeline.measure_faithfulness",
                "pipeline.measure_cls_acc", "pipeline.measure_accuracy",
                "pipeline.measure_branches_cka", "pipeline.measure_performance",
                "pipeline.measure_train_resources", "pipeline.reports",
                "ops.cka", "utils.flops", "utils.units", "utils.functional",
                "parallel.mesh", "recipes.ltt_bert", "recipes.vanilla_bert",
                "models.ltt_bert", "models.bert", "data.loader",
                "recipes.vanilla_vit", "recipes.froyo_vit",
                "recipes.froyo_bert", "models.vit", "models.froyo_vit",
                "models.froyo_bert", "native", "ops.kernel_shap",
                "models.duo_vit", "models.duo_bert",
                "models.kernel_shap_bert", "recipes.duo_vanilla_vit",
                "recipes.duo_vanilla_bert", "recipes.kernel_shap_bert",
                "pipeline.train_duo_explainer",
                "pipeline.train_kernel_shap_explainer",
                "pipeline.measure_dual_task_similarity",
                "pipeline.show_fridge", "pipeline.estimate_train_time",
                "pipeline.pretrain_classifier",
                "pipeline.run_text_explanation",
                "pipeline.preview_text_shapley",
                "pipeline.run_image_explanation", "zoo.loader",
                "pipeline.export", "kernels.library",
                "parallel.pipeline", "pipeline.pp_trainer", "utils.tracing"):
        assert f"autognothi_tpu_torch.{new}" in mods, new
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'jaxlib', 'optax', 'pydantic', 'orbax',\n"
        "                    'autognothi_tpu') if m in sys.modules]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_every_jax_verb_is_ported_or_refused():
    from autognothi_tpu.cli import build_parser as jax_parser
    from autognothi_tpu_torch.cli import (DEMOS, NOT_PORTED, REPORTS,
                                          TRAINING, build_parser)

    def verbs(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, __import__("argparse")._SubParsersAction))
        return set(sub.choices)

    jax_verbs, port_verbs = verbs(jax_parser()), verbs(build_parser())
    assert jax_verbs == port_verbs
    ported = {"serve", *TRAINING, *REPORTS, *DEMOS, "measure_all",
              "run_all", "preload_all", "export_final"}
    assert ported | set(NOT_PORTED) == jax_verbs
    assert not ported & set(NOT_PORTED)
    # every verb is ported (the export since M9)
    assert set(NOT_PORTED) == set()
    assert {"__show_fridge__", "__preview_text_shapley__"} <= set(DEMOS)


def test_resolve_device_cuda_raises_without_a_card():
    from autognothi_tpu_torch.utils.devices import resolve_device

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(exp, *flags):
    return [sys.executable, "-m", "autognothi_tpu_torch", "serve", str(exp),
            *flags]


def test_cli_cuda_without_a_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    exp = _write_exp(tmp_path)
    proc = subprocess.run(_cli(exp, "--device", "cuda"), cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_cli_serve_drains_on_sigterm(tmp_path):
    exp = _write_exp(tmp_path)
    port = _free_port()
    proc = subprocess.Popen(
        _cli(exp, "--device", "cpu", "--port", str(port), "--batch-size",
             "2"),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    assert r.status == 200
                    break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None, proc.communicate()
                assert time.monotonic() < deadline, "server never came up"
                time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "drained and closed" in (exp / ".log.txt").read_text()


def test_unported_verbs_and_kinds_raise(tmp_path):
    from autognothi_tpu_torch.cli import main
    from autognothi_tpu_torch.pipeline.config import parse_config

    # a mesh-sharded artifact (M10a): written by one process, refused by a
    # world of fewer ranks than it was exported for
    from autognothi_tpu_torch.pipeline.export import load_exported

    exp = _write_exp(tmp_path)
    main(["export_final", str(exp), "--into", str(tmp_path / "a.agx"),
          "--data-parallel", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="2 devices"):
        load_exported(tmp_path / "a.agx", device="cpu")
    # every net kind of the JAX package is ported: an unknown kind raises
    # a ValueError naming it, as the JAX package's schema does
    hp = _ltt_vit_hparams()
    hp["net"]["kind"] = "quadro_vit"
    with pytest.raises(ValueError, match="quadro_vit"):
        parse_config(hp)
    hp["net"]["kind"] = "ltt_vit"
    assert parse_config(hp).net.params["s_attn_hidden_size"] == 16


def test_port_reads_no_environment_switch():
    # the port reads no environment switch that routes work to the CPU; its
    # reads are the JAX package's own switches, each picking the arithmetic
    # or a training option on either device: AUTOGNOTHI_PALLAS (fused ops,
    # masked attention op or plain math), AUTOGNOTHI_INT8 (W8A8 or not),
    # AUTOGNOTHI_FUSED_MIN_HIDDEN (layers and ladders narrower than it run
    # the unfused, unquantized math instead of the fused ops),
    # AUTOGNOTHI_INT8_TEACHER, AUTOGNOTHI_COMPUTE_DTYPE, AUTOGNOTHI_CKPT_OPT
    # (optimizer-state checkpoints), AUTOGNOTHI_DEFER_LOSS_FETCH (when the
    # losses are fetched), AUTOGNOTHI_PAD_RAGGED (padding of the last batch),
    # AUTOGNOTHI_DEBUG_NANS (autograd anomaly detection), AUTOGNOTHI_ZOO
    # (where local base models are stored), AUTOGNOTHI_PROFILE_DIR (where
    # the performance report writes its profiler trace), AUTOGNOTHI_PP /
    # AUTOGNOTHI_PP_MICROBATCHES / AUTOGNOTHI_PP_TP (pipeline-parallel
    # training, one process per device as the world's), AUTOGNOTHI_REMAT
    # (per-layer rematerialisation), AUTOGNOTHI_CKPT_BACKEND (directory
    # checkpoints), and the world of
    # processes (parallel/distributed.py, read from an `env` mapping that
    # defaults to os.environ): AUTOGNOTHI_DIST_COORD / _NPROCS / _PROC_ID
    # and torchrun's LOCAL_RANK, which pick the rank's own card, never the
    # CPU
    import re

    src = (REPO / "autognothi_tpu_torch").rglob("*.py")
    dist_py = "autognothi_tpu_torch/parallel/distributed.py"
    reads = {p.relative_to(REPO).as_posix():
             sorted(re.findall(r'os\.environ\.get\("(\w+)"', p.read_text()))
             for p in src if "os.environ" in p.read_text()
             and p.relative_to(REPO).as_posix() != dist_py}
    assert sorted(set(re.findall(r'env\.get\("(\w+)"', (
        REPO / dist_py).read_text()))) == [
            "AUTOGNOTHI_DIST_COORD", "AUTOGNOTHI_DIST_NPROCS",
            "AUTOGNOTHI_DIST_PROC_ID", "LOCAL_RANK"]
    assert reads == {
        "autognothi_tpu_torch/models/common.py":
            ["AUTOGNOTHI_FUSED_MIN_HIDDEN", "AUTOGNOTHI_INT8",
             "AUTOGNOTHI_PALLAS", "AUTOGNOTHI_REMAT"],
        "autognothi_tpu_torch/params.py": ["AUTOGNOTHI_CKPT_BACKEND"],
        "autognothi_tpu_torch/parallel/pipeline.py":
            ["AUTOGNOTHI_PP", "AUTOGNOTHI_PP_MICROBATCHES",
             "AUTOGNOTHI_PP_TP"],
        "autognothi_tpu_torch/parallel/train_step.py":
            ["AUTOGNOTHI_INT8_TEACHER"],
        "autognothi_tpu_torch/pipeline/measure_performance.py":
            ["AUTOGNOTHI_PROFILE_DIR"],
        "autognothi_tpu_torch/pipeline/resources.py":
            ["AUTOGNOTHI_CKPT_OPT"],
        "autognothi_tpu_torch/pipeline/training.py":
            ["AUTOGNOTHI_COMPUTE_DTYPE", "AUTOGNOTHI_DEBUG_NANS",
             "AUTOGNOTHI_DEFER_LOSS_FETCH", "AUTOGNOTHI_PAD_RAGGED"],
        "autognothi_tpu_torch/zoo/loader.py": ["AUTOGNOTHI_ZOO"],
    }
    total = sum(p.read_text().count("os.environ")
                for p in (REPO / "autognothi_tpu_torch").rglob("*.py"))
    assert total == 19  # 16, and parallel/distributed.py's three defaults
