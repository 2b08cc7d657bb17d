"""Port parity, the served slice: the JAX server and the port's server on
the CPU load the same JAX-written `final-epoch-0.ckpt` of a mini LTT ViT
and answer the same `images` / `images_u8` requests; logits and
attributions agree to atol 1e-5.  Plus the port's serving contract: its
import graph is free of JAX, it never falls back from CUDA to the CPU, it
drains on SIGTERM, and unported verbs and kinds raise."""

import json
import pathlib
import signal
import socket
import subprocess
import sys
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
                "parallel.mesh"):
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
    from autognothi_tpu_torch.cli import (NOT_PORTED, REPORTS, TRAINING,
                                          build_parser)

    def verbs(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, __import__("argparse")._SubParsersAction))
        return set(sub.choices)

    jax_verbs, port_verbs = verbs(jax_parser()), verbs(build_parser())
    assert jax_verbs == port_verbs
    ported = {"serve", *TRAINING, *REPORTS, "measure_all", "run_all"}
    assert ported | set(NOT_PORTED) == jax_verbs
    assert not ported & set(NOT_PORTED)
    assert {"__show_fridge__", "__preview_text_shapley__"} <= set(NOT_PORTED)


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

    with pytest.raises(NotImplementedError, match="not ported yet"):
        main(["export_final", str(tmp_path)])
    hp = _ltt_vit_hparams()
    hp["net"]["kind"] = "vanilla_vit"
    with pytest.raises(NotImplementedError, match="not ported yet"):
        parse_config(hp)
    hp["net"]["kind"] = "ltt_vit"
    assert parse_config(hp).net.params["s_attn_hidden_size"] == 16


def test_serve_artifact_is_not_ported(tmp_path):
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import ExplainService

    with ExpEnv(_write_exp(tmp_path)) as env:
        with pytest.raises(NotImplementedError, match="not ported yet"):
            ExplainService(env, artifact=tmp_path / "a.bin", device="cpu")


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
    # the performance report writes its profiler trace), and AUTOGNOTHI_PP /
    # AUTOGNOTHI_PP_TP, which only refuse (not ported)
    import re

    src = (REPO / "autognothi_tpu_torch").rglob("*.py")
    reads = {p.relative_to(REPO).as_posix():
             sorted(re.findall(r'os\.environ\.get\("(\w+)"', p.read_text()))
             for p in src if "os.environ" in p.read_text()}
    assert reads == {
        "autognothi_tpu_torch/models/common.py":
            ["AUTOGNOTHI_FUSED_MIN_HIDDEN", "AUTOGNOTHI_INT8",
             "AUTOGNOTHI_PALLAS"],
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
    src = (REPO / "autognothi_tpu_torch/pipeline/training.py").read_text()
    assert '("AUTOGNOTHI_PP", "AUTOGNOTHI_PP_TP")' in src
    total = sum(p.read_text().count("os.environ")
                for p in (REPO / "autognothi_tpu_torch").rglob("*.py"))
    assert total == 12
