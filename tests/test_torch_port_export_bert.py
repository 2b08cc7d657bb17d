"""Port parity, the export (M9), second part: the round trip of the BERT
net kinds (`ltt_bert`, `vanilla_bert`, `froyo_bert`, `duo_vanilla_bert`:
the mini BERT at T = 16, real sentences with padding), the default file's
two platforms and the `export_final` verb through `python -m
autognothi_tpu_torch`; the helpers and tolerances of
tests/test_torch_port_export.py.
"""

import os
import subprocess
import sys

import pytest
import torch

from tests.test_torch_port_export import (B, BERT_KINDS, REPO, TOL_PORT,
                                          _program, clean_env, close,  # noqa: F401
                                          inputs, port_export, port_live,
                                          round_trip, write_final_exp)


@pytest.mark.parametrize("kind", BERT_KINDS)
def test_round_trip_every_net_kind(kind, tmp_path):
    round_trip(kind, tmp_path)


def test_one_default_file_carries_both_platforms(tmp_path):
    """The default artifact is stored on the CPU, marked for cuda and cpu,
    holds no device-specific op, and moves as a whole to another device
    (here the meta device, which computes shapes only)."""
    from torch.export.passes import move_to_device_pass

    from autognothi_tpu_torch.pipeline.export import DEFAULT_PLATFORMS

    exp = write_final_exp(tmp_path, "ltt_bert")
    port_export(exp, tmp_path / "final.agx", batch_size=B)
    ep, meta = _program(tmp_path / "final.agx")
    assert tuple(meta["platforms"]) == DEFAULT_PLATFORMS == ("cuda", "cpu")
    assert {t.device.type for t in ep.state_dict.values()} == {"cpu"}
    assert not [n for n in ep.graph.nodes
                if "autognothi" in str(n.target)]
    moved = move_to_device_pass(ep, "meta").module()
    xs = torch.as_tensor(inputs("ltt_bert", exp)).to("meta")
    logits, attr = moved(xs)
    assert logits.device.type == "meta" and logits.shape == (B, 2)
    assert attr.shape == (B, 2, xs.shape[1] - 1)


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "autognothi_tpu_torch", *map(str, args)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


def test_cli_verb(tmp_path):
    from autognothi_tpu_torch.pipeline.export import load_exported

    exp = write_final_exp(tmp_path, "ltt_vit")
    proc = _cli("export_final", exp, "--into", tmp_path / "cli.agx",
                "--batch-size", "2", "--platforms", "cpu", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    fw = load_exported(tmp_path / "cli.agx", device="cpu")
    assert fw.platforms == ("cpu",) and fw.in_shape == (2, 3, 16, 16)
    xs = inputs("ltt_vit", exp)
    close(fw(xs), port_live(exp, xs), TOL_PORT, "CLI artifact")
    # the W8A8 kernel artifact: its program launches the kernel ops
    proc = _cli("export_final", exp, "--into", tmp_path / "k.agx",
                "--batch-size", "2", "--kernels", "--platforms", "cuda",
                "--device", "cpu", env={"AUTOGNOTHI_INT8": "1"})
    assert proc.returncode == 0, proc.stderr
    ep, meta = _program(tmp_path / "k.agx")
    assert meta["quant"] == "int8" and meta["kernels"]
    ops = {str(n.target) for n in ep.graph.nodes
           if str(n.target).startswith("autognothi.")}
    assert {"autognothi.attention_block_int8.default",
            "autognothi.mlp_ladder_block.default",
            "autognothi.mlp_block_int8.default",
            "autognothi.head_block.default"} == ops
    # a mesh-sharded artifact: the program at batch / N rows, and a world
    # of one process refuses to load it
    proc = _cli("export_final", exp, "--into", tmp_path / "dp.agx",
                "--batch-size", "4", "--data-parallel", "2", "--device",
                "cpu")
    assert proc.returncode == 0, proc.stderr
    ep, meta = _program(tmp_path / "dp.agx")
    assert meta["nr_devices"] == 2 and meta["in_shape"][0] == 4
    xs_node = [n for n in ep.graph.nodes if n.op == "placeholder"][-1]
    assert xs_node.meta["val"].shape[0] == 2  # a rank's rows
    with pytest.raises(ValueError, match="2 devices"):
        load_exported(tmp_path / "dp.agx", device="cpu")
    proc = _cli("export_final", exp, "--into", tmp_path / "dp3.agx",
                "--batch-size", "3", "--data-parallel", "2", "--device",
                "cpu")
    assert proc.returncode != 0 and "not divisible" in proc.stderr
