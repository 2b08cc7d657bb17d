"""Port parity, the world of processes (M10a): `parallel/distributed.py`
and the real `parallel/mesh.py` on gloo processes on the CPU.

- Two processes (the JAX tests/test_distributed.py:80): `process_info`, an
  all-reduce, and a checkpoint that rank 0 alone writes and every rank
  reads back; the report helpers `sharded_eval_fn` (even batch: per rank,
  the kernels' mode; ragged: whole on every rank in mode "0") and
  `sharded_call` (its refusals).
- A world of one process (AUTOGNOTHI_DIST_* naming one rank) is bit-
  identical to no environment at all, for `train_explainer` through the
  CLI; the same stage over two ranks logs its data-parallel line, rank 0
  alone writes the checkpoint, and its first train batch's loss is the
  one-process loss.
- `serve` over two ranks through the CLI: rank 0 answers on its port with
  the slab rounded up to a multiple of 2, rank 1 binds no port, and the
  answers equal the one-process service's; SIGTERM on rank 0 stops both,
  with exit code 0.
"""

import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np

from tests.test_ltt_e2e import _ltt_vit_hparams
from tests.test_torch_port_scaleout import (DIST_KEYS, REPO, free_port,
                                            run_world)

TIMEOUT = 240


def test_two_process_basics_and_report_helpers(tmp_path):
    spec = dict(tag="basics", jobs=["basics", "reports"], ckpt_dir=str(
        tmp_path), train_cfg=dict(epochs=3, ckpt_when="", lr=1e-3,
                                  batch_size=2))
    ranks = run_world(spec, 2, tmp_path, {"AUTOGNOTHI_PALLAS": "auto"})
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    for r, (info, arr) in enumerate(ranks):
        assert info["process_index"] == r and info["process_count"] == 2
        assert info["global_devices"] == 2 and info["local_devices"] == 1
        assert info["reduced"] == 8.0 * (0 + 1)
        assert info["ckpt_rank0"] is True  # rank 1's array was not written
        # even: per rank, kernels' mode, rows gathered in order
        np.testing.assert_array_equal(arr["reports/eval4/0"], x * 2 + 2)
        np.testing.assert_array_equal(arr["reports/eval4/1"], x.sum(1))
        assert info["reports/eval4/counts"] == {"all_gather": 2}
        assert info["reports/eval4/mode"] == "2"
        # ragged: whole batch on every rank, the plain math, no collective
        np.testing.assert_array_equal(arr["reports/eval3/0"], x[:3] * 2 + 2)
        assert info["reports/eval3/counts"] == {}
        assert info["reports/eval3/mode"] == "0"
        np.testing.assert_array_equal(arr["reports/call"],
                                      np.full((4, 3), 4.0, np.float32))
        assert info["reports/refused_ragged"] is True
        assert info["reports/refused_scalar"] is True
    assert sorted(p.name for p in tmp_path.glob("dist-*")) == \
        ["dist-epoch-1.ckpt"]


# ------------------------------------------------------ the CLI in a world


def _explainer_exp(root: pathlib.Path, name: str) -> pathlib.Path:
    """A mini LTT ViT experiment with surrogate and explainer checkpoints
    (tests/test_torch_port_train.py's)."""
    from autognothi_tpu.models import ltt_vit as jax_ltt
    from autognothi_tpu.pipeline.resources import save_params

    hp = _ltt_vit_hparams()
    hp["train_explainer"].update(epochs=1, batch_size=4, n_mask_samples=2)
    exp = root / name
    exp.mkdir()
    (exp / ".hparams.json").write_text(json.dumps(hp, indent=2))
    cfg = jax_ltt.LttViTConfig(**hp["net"]["params"])
    k_s, k_e = jax.random.split(jax.random.PRNGKey(3))
    save_params(exp / "surrogate-epoch-1.ckpt",
                jax_ltt.init_ltt_vit_surrogate(k_s, cfg))
    save_params(exp / "explainer-epoch-0.ckpt",
                jax_ltt.init_ltt_vit_explainer(k_e, cfg))
    return exp


def _cli_env(world: int = 0, rank: int = 0, port: int = 0) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in DIST_KEYS}
    env["OMP_NUM_THREADS"] = "1"
    if world:
        env.update({"AUTOGNOTHI_DIST_COORD": f"127.0.0.1:{port}",
                    "AUTOGNOTHI_DIST_NPROCS": str(world),
                    "AUTOGNOTHI_DIST_PROC_ID": str(rank)})
    return env


def _run_ranks(args, world: int):
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "autognothi_tpu_torch", *map(str, args)],
        cwd=REPO, env=_cli_env(world, r, port), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        errs = []
        for proc in procs:
            _, err = proc.communicate(timeout=TIMEOUT)
            errs.append(err)
            assert proc.returncode == 0, err[-3000:]
        return errs
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def _first_loss(log: str) -> float:
    return float(re.search(r":0:train // loss: shap ([0-9.e+-]+)",
                           log).group(1))


def test_train_explainer_worlds_of_one_and_two(tmp_path):
    from autognothi_tpu.pipeline.resources import load_params_file

    plain, one, two = (_explainer_exp(tmp_path, n)
                       for n in ("plain", "one", "two"))
    proc = subprocess.run(
        [sys.executable, "-m", "autognothi_tpu_torch", "train_explainer",
         str(plain), "--device", "cpu"], cwd=REPO, env=_cli_env(),
        capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (err,) = _run_ranks(["train_explainer", one, "--device", "cpu"], 1)
    assert "[distributed] {'process_index': 0, 'process_count': 1" in err
    want = load_params_file(plain / "explainer-epoch-1.ckpt")
    got = load_params_file(one / "explainer-epoch-1.ckpt")
    assert set(got) == set(want)
    for k in want:  # a world of one is the one-device path, bit for bit
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "data-parallel" not in (one / ".log.txt").read_text()

    _run_ranks(["train_explainer", two, "--device", "cpu"], 2)
    log = (two / ".log.txt").read_text()
    assert "[[[ data-parallel over 2 devices ]]]" in log
    assert log.count("[[[ NEW RUN") == 1  # rank 0 alone writes the log
    assert abs(_first_loss(log) - _first_loss(
        (plain / ".log.txt").read_text())) <= 1e-5
    dp = load_params_file(two / "explainer-epoch-1.ckpt")
    assert {k: v.shape for k, v in dp.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(np.all(np.isfinite(v)) for v in dp.values())


def _get(port: int, path: str, payload=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_over_two_ranks(tmp_path):
    from autognothi_tpu_torch.pipeline.env import ExpEnv
    from autognothi_tpu_torch.pipeline.serve import ExplainService
    from tests.test_torch_port_export import write_final_exp

    exp = write_final_exp(tmp_path, "ltt_vit")
    http, dist_port = free_port(), free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "autognothi_tpu_torch", "serve", str(exp),
         "--device", "cpu", "--port", str(http), "--batch-size", "3"],
        cwd=REPO, env=_cli_env(2, r, dist_port), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        deadline = time.time() + TIMEOUT
        while True:
            assert all(p.poll() is None for p in procs), \
                [p.communicate()[1][-2000:] for p in procs]
            try:
                assert _get(http, "/healthz") == {"status": "ok"}
                break
            except OSError:
                assert time.time() < deadline
                time.sleep(0.5)
        images = np.random.RandomState(4).randn(5, 3, 16, 16)
        got = _get(http, "/explain", {"images": images.tolist()})
        stats = _get(http, "/statz")
        procs[0].send_signal(signal.SIGTERM)
        for proc in procs:
            proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert stats["batch_size"] == 4  # 3 rounded up to a multiple of 2
    with ExpEnv(exp) as env:
        service = ExplainService(env, batch_size=4, device="cpu")
        try:
            want = service.explain({"images": images.tolist()})
        finally:
            service.close()
    for key in ("logits", "attributions"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-5, atol=2e-6)
    log = (exp / ".log.txt").read_text()
    assert "serving sharded over 2 devices (batch 4)" in log
    assert "drained and closed" in log
