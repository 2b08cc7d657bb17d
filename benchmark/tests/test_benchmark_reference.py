"""The plain references against the plain path of autognothi_tpu_torch
(its kernel ops take their plain versions on the CPU), and the import
guard: the references import nothing of the program."""

import numpy as np
import pytest
import torch

from benchmark import core, serving, weights
from benchmark.reference import common as ref_common
from benchmark.reference import ltt_bert as ref_bert
from benchmark.reference import ltt_vit as ref_vit
from benchmark.reference.wordpiece import WordPiece

VIT = core.read_json(core.BENCH_DIR / "configs" / "ltt_vit_b16_224.json")
BERT = core.read_json(core.BENCH_DIR / "configs" / "ltt_bert_base_512.json")


def tiny(cfg, **kw):
    from benchmark.tests.tiny import TINY_MODEL

    return dict(cfg["model"], **TINY_MODEL[cfg["family"]], **kw)


def port_model(family, model, section, params):
    if family == "ltt_vit":
        from autognothi_tpu_torch.models.ltt_vit import LttViT, LttViTConfig

        m = LttViT(LttViTConfig(**model), section)
    else:
        from autognothi_tpu_torch.models.ltt_bert import (LttBert,
                                                          LttBertConfig)

        m = LttBert(LttBertConfig(**model), section)
    m.load_state_dict(params, strict=True)
    return m.eval()


@pytest.mark.parametrize("family,section", [
    ("ltt_vit", "final"), ("ltt_vit", "surrogate"), ("ltt_vit", "explainer"),
    ("ltt_bert", "final")])
def test_param_specs_are_the_checkpoint_format(family, section):
    model = tiny(VIT if family == "ltt_vit" else BERT)
    ref = core.module("reference", family)
    params = weights.make(ref.param_specs(model, section), 3, "cpu")
    m = port_model(family, model, section, params)   # strict load
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == \
        {k: tuple(v) for k, v in ref.param_specs(model, section)}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("size", ["tiny", "published"])
def test_vit_final_matches_the_port(int8, size):
    from autognothi_tpu_torch.models.common import quant_override
    from autognothi_tpu_torch.recipes.ltt_vit import fw_final
    from autognothi_tpu_torch.models.ltt_vit import LttViTConfig

    model = tiny(VIT) if size == "tiny" else VIT["model"]
    params = weights.make(ref_vit.param_specs(model), 11, "cpu")
    m = port_model("ltt_vit", model, "final", params)
    b = 3 if size == "tiny" else 1
    px = torch.rand((b, 3, model["img_px_size"], model["img_px_size"]),
                    generator=torch.Generator().manual_seed(5))
    with torch.no_grad(), quant_override("int8" if int8 else "none"):
        got = fw_final(LttViTConfig(**model), m, px)
        want = ref_vit.final(params, model, px, bits=8 if int8 else None)
    gaps = serving.compare(got[0].numpy(), got[1].numpy(), *want)
    assert gaps["prob_gap"] < 1e-5 and gaps["attr_gap"] < 1e-4, gaps


def test_bert_final_matches_the_port():
    from autognothi_tpu_torch.recipes.ltt_bert import fw_final
    from autognothi_tpu_torch.models.ltt_bert import LttBertConfig

    model = tiny(BERT)
    params = weights.make(ref_bert.param_specs(model), 12, "cpu")
    m = port_model("ltt_bert", model, "final", params)
    ids = torch.randint(0, model["vocab_size"], (3, 32),
                        generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        got = fw_final(LttBertConfig(**model), m, ids)
        want = ref_bert.final(params, model, ids)
    gaps = serving.compare(got[0].numpy(), got[1].numpy(), *want)
    assert gaps["prob_gap"] < 1e-5 and gaps["attr_gap"] < 1e-4, gaps


def test_wordpiece_copy_gives_the_port_tokenizer_ids():
    from autognothi_tpu_torch.data.tokenizer import (WordPieceTokenizer,
                                                     encode_batch)

    words, vocab = serving.make_vocab(3000, 2000)
    rng = np.random.default_rng(4)
    texts = [serving.make_text(rng, words, int(n))
             for n in rng.integers(1, 700, size=24)]
    texts += ["Café, naïve — déjà vu!", "", "a" * 150]
    port = encode_batch(WordPieceTokenizer(vocab), texts, 512)
    mine = np.stack([WordPiece(vocab).encode(t, 512) for t in texts])
    assert (port == mine).all()
    assert (mine[:, 1:] != WordPiece(vocab).unk).any()


def test_quantizers_agree_with_the_ports():
    from autognothi_tpu_torch.ops.mlp_block import _quant_rows, quant_cols

    x = torch.randn(64, 96, generator=torch.Generator().manual_seed(2))
    w = torch.randn(40, 96, generator=torch.Generator().manual_seed(3))
    assert torch.equal(ref_common.quant_rows(x, 8)[0],
                       _quant_rows(x)[0].float())
    assert torch.equal(ref_common.quant_cols(w, 8)[0],
                       quant_cols(w)[0].float())


def test_references_import_nothing_of_the_program():
    assert core.reference_imports() == []
    assert core.forbidden_modules() == []


def test_guard_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "autognothi_tpu_torch_extra",
                        types.ModuleType("autognothi_tpu_torch_extra"))
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert core.forbidden_modules() == ["jax"]
