"""The benchmark's frozen count of operations against the program's own
count (`autognothi_tpu_torch.utils.flops.fn_flops`, torch's FLOP counter
over the plain path on the CPU) at a small size."""

import math

import pytest
import torch

from benchmark import core, weights
from benchmark.work import common, ltt_bert as work_bert, ltt_vit as work_vit
from benchmark.tests.test_benchmark_reference import BERT, VIT, port_model
from benchmark.tests.test_benchmark_reference import tiny as tiny_model


@pytest.mark.parametrize("int8", [False, True])
def test_vit_final_products_match_the_flop_counter(int8):
    from autognothi_tpu_torch.models.common import quant_override
    from autognothi_tpu_torch.models.ltt_vit import LttViTConfig
    from autognothi_tpu_torch.recipes.ltt_vit import fw_final
    from autognothi_tpu_torch.utils.flops import fn_flops

    model = tiny_model(VIT)
    ref = core.module("reference", "ltt_vit")
    m = port_model("ltt_vit", model, "final",
                   weights.make(ref.param_specs(model), 1, "cpu"))
    px = torch.rand((2, 3, model["img_px_size"], model["img_px_size"]))
    with quant_override("int8" if int8 else "none"):
        counted = fn_flops(lambda: fw_final(LttViTConfig(**model), m, px))
    assert common.total_flops(work_vit.final_ops(model, 2, int8)) == counted


def test_bert_final_products_match_the_flop_counter():
    from autognothi_tpu_torch.models.ltt_bert import LttBertConfig
    from autognothi_tpu_torch.recipes.ltt_bert import fw_final
    from autognothi_tpu_torch.utils.flops import fn_flops

    model = tiny_model(BERT)
    ref = core.module("reference", "ltt_bert")
    m = port_model("ltt_bert", model, "final",
                   weights.make(ref.param_specs(model), 1, "cpu"))
    ids = torch.randint(0, model["vocab_size"], (2, 32))
    counted = fn_flops(lambda: fw_final(LttBertConfig(**model), m, ids))
    assert common.total_flops(work_bert.final_ops(model, 2)) == counted


def test_trained_parameters_are_the_programs():
    from autognothi_tpu_torch.models.ltt_vit import LttViT, LttViTConfig
    from autognothi_tpu_torch.recipes.ltt_vit import ltt_vit_recipe

    model = VIT["model"]
    cfg = LttViTConfig(**model)
    keep = ltt_vit_recipe().trainable(cfg, "explainer")
    with torch.device("meta"):
        m = LttViT(cfg, "explainer")
    n = sum(p.numel() for k, p in m.named_parameters() if keep(k))
    assert work_vit.trainable_count(model) == n


def test_least_time_is_bounded_by_compute_and_bytes():
    ops = work_vit.final_ops(VIT["model"], 64, False)
    assert common.least_s(ops) >= common.peak_s(ops) > 0
    step = work_vit.train_ops(VIT["model"], 32, 32)
    # the teacher's 1,056 masked int8 forwards dominate the step's work
    teacher = sum(o.peak_s() for o in step if o.name.startswith("teacher"))
    assert teacher > 0.5 * common.peak_s(step)
    # a served explanation at ViT-B/16: 41.1 GFLOP with the attention
    # scores, the two ladders and the 3072-wide head (the FLOP counter's
    # count at the small size agrees, above)
    per_row = common.total_flops(work_vit.final_ops(VIT["model"], 1, False))
    assert 4.0e10 < per_row < 4.2e10, per_row
    assert math.isfinite(common.least_s(work_bert.final_ops(BERT["model"], 8)))
