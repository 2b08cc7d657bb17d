"""Logical ops of LTT BERT's served final: every row is T =
max_position_embeddings tokens, the model's input by definition."""

from __future__ import annotations

from typing import List

from .common import (Op, attention_block, ladder_step, mlp_block, product,
                     weight_bytes)


def final_ops(cfg: dict, b: int, int8: bool = False) -> List[Op]:
    if int8:
        raise ValueError("the LTT BERT work is counted for float32 only")
    t, h = cfg["max_position_embeddings"], cfg["hidden_size"]
    inter, heads = cfg["intermediate_size"], cfg["num_attention_heads"]
    s, s_inter = cfg["s_attn_hidden_size"], cfg["s_attn_intermediate_size"]
    d, c = cfg["explainer_s_head_hidden_size"], cfg["num_labels"]
    n_layers, n_exp = cfg["num_hidden_layers"], \
        cfg["explainer_s_attn_num_layers"]
    rows = b * t
    ops = [Op("embed", {}, 3 * rows * h * 4 + rows * 8 + t * h * 4)]
    ops += [attention_block(b, t, h, heads, False,
                            "trunk_attention").scaled(n_layers),
            mlp_block(b, t, h, inter, False, "trunk_mlp").scaled(n_layers),
            ladder_step(b, t, h, s, s_inter, 2, "ladder").scaled(n_layers),
            attention_block(b, t, s, heads, False,
                            "explainer_attention").scaled(n_exp),
            mlp_block(b, t, s, s_inter, False, "explainer_mlp").scaled(n_exp),
            Op("explainer_head",
               {"fp32": product(rows, s, d) + product(rows, d, d)
                + product(rows, d, c)},
               rows * s * 4 + weight_bytes(s, d, False)
               + weight_bytes(d, d, False) + weight_bytes(d, c, False)
               + rows * c * 4)]
    for width, name in ((h, "pooler_classifier"),
                        (s, "side_pooler_classifier")):
        ops.append(Op(name, {"fp32": product(b, width, width)
                             + product(b, width, c)},
                      b * width * 4 + weight_bytes(width, width, False)
                      + weight_bytes(width, c, False) + b * c * 4))
    return ops
