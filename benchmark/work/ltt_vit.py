"""Logical ops of LTT ViT: the served final and the explainer train step."""

from __future__ import annotations

import math
from typing import List

from ..reference import ltt_vit

from .common import (Op, attention_block, backward, ladder_step, mlp_block,
                     product, weight_bytes)


def _dims(cfg: dict):
    t = (cfg["img_px_size"] // cfg["img_patch_size"]) ** 2 + 1
    return (t, cfg["hidden_size"], cfg["intermediate_size"],
            cfg["s_attn_hidden_size"], cfg["s_attn_intermediate_size"],
            cfg["num_attention_heads"], cfg["num_hidden_layers"])


def embed(cfg: dict, b: int) -> Op:
    t, h = _dims(cfg)[:2]
    k = cfg["img_channels"] * cfg["img_patch_size"] ** 2
    return Op("patch_embed", {"fp32": product(b * (t - 1), k, h)},
              b * (t - 1) * k * 4 + weight_bytes(k, h, False)
              + b * t * h * 4 + t * h * 4)


def trunk(cfg: dict, b: int, branches: int, int8: bool) -> List[Op]:
    """Embeddings, then per layer the attention block, the MLP block and
    every branch's ladder step."""
    t, h, inter, s, s_inter, heads, n_layers = _dims(cfg)
    ops = [embed(cfg, b)]
    for op in (attention_block(b, t, h, heads, int8, "trunk_attention"),
               mlp_block(b, t, h, inter, int8, "trunk_mlp"),
               ladder_step(b, t, h, s, s_inter, branches, "ladder")):
        ops.append(op.scaled(n_layers))
    return ops


def classifier(cfg: dict, b: int, width: int, name: str) -> Op:
    c = cfg["num_labels"]
    return Op(name, {"fp32": product(b, width, c)},
              b * width * 4 + weight_bytes(width, c, False) + b * c * 4)


def explainer(cfg: dict, b: int, int8: bool) -> List[Op]:
    """The explainer side layers and the LayerNorm + MLP head."""
    t, _, _, s, s_inter, heads, _ = _dims(cfg)
    d, c = cfg["explainer_s_head_hidden_size"], cfg["num_labels"]
    arith = "int8" if int8 else "fp32"
    n = cfg["explainer_s_attn_num_layers"]
    head = Op("explainer_head",
              {arith: product(b * t, s, d) + product(b * t, d, d)},
              b * t * s * 4 + weight_bytes(s, d, int8)
              + weight_bytes(d, d, int8) + weight_bytes(d, c, False)
              + b * t * c * 4)
    head.flops["fp32"] = head.flops.get("fp32", 0.0) + product(b * t, d, c)
    return [attention_block(b, t, s, heads, int8,
                            "explainer_attention").scaled(n),
            mlp_block(b, t, s, s_inter, int8, "explainer_mlp").scaled(n),
            head]


def final_ops(cfg: dict, b: int, int8: bool) -> List[Op]:
    """One forward of the served final at batch b."""
    h, s = cfg["hidden_size"], cfg["s_attn_hidden_size"]
    return trunk(cfg, b, 2, int8) + explainer(cfg, b, int8) + [
        classifier(cfg, b, h, "classifier"),
        classifier(cfg, b, s, "side_classifier")]


def teacher_ops(cfg: dict, b: int, m: int) -> List[Op]:
    """The int8 teacher of one explainer step: the surrogate (branch 0)
    over b * m coalitions, the embeddings once an image, and over the b
    images with every player on."""
    s = cfg["s_attn_hidden_size"]
    ops = []
    for rows, tag in ((b * m, "teacher"), (b, "teacher_grand")):
        for op in trunk(cfg, rows, 1, True):
            if op.name == "patch_embed":
                op = embed(cfg, b)
            op.name = f"{tag}.{op.name}"
            ops.append(op)
        ops.append(classifier(cfg, rows, s, f"{tag}.side_classifier"))
    return ops


def trainable_count(cfg: dict) -> int:
    """Parameters the explainer step updates: everything of the explainer
    section outside the frozen trunk."""
    return sum(math.prod(shape)
               for name, shape in ltt_vit.param_specs(cfg, "explainer")
               if not name.startswith(ltt_vit.FROZEN))


def train_ops(cfg: dict, b: int, m: int) -> List[Op]:
    """One explainer step: the teacher, the float32 forward of the
    explainer section (trunk, branch 0, explainer), the backward of what
    is trained (the ladder, the explainer layer and head) and AdamW."""
    fwd = trunk(cfg, b, 1, False) + explainer(cfg, b, False)
    trained = [op for op in fwd if op.name.startswith(("ladder",
                                                       "explainer"))]
    adamw = Op("adamw", {}, 7 * 4 * trainable_count(cfg))
    return teacher_ops(cfg, b, m) + [
        Op("forward." + op.name, op.flops, op.bytes, op.count)
        for op in fwd] + [backward(op) for op in trained] + [adamw]
