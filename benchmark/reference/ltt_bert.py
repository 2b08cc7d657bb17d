"""Plain reference of LTT BERT (AutoGnothi's ladder-side-tuned BERT): one
frozen post-norm BERT trunk with 96-wide post-norm side ladders beside it,
each updated after every trunk layer i as
    side_b <- SideLayer_{b,i}(side_b + GELU(Map_{b,i}(h_i))).
Branch 0 is the surrogate (tanh pooler + classifier on its CLS row),
branch 1 the explainer (one more side layer without its attention-output
LayerNorm, then a three-layer MLP head without a LayerNorm); the
attributions are normalised so that each class sums to grand - null.
The served final attends to every one of the T positions (an all-ones
attention mask: its additive bias is 0), padding included, and takes
token type 0 everywhere.

Parameters are a flat dict under the checkpoint names of the served
program's format (`param_specs`).  float32 only.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .common import gelu, linear, ln, mlp, normalize_shapley, self_attention

SECTIONS = {"final": dict(branches=(0, 1))}


def _layer_specs(pre: str, h: int, inter: int, ln1: bool = True) -> list:
    out = []
    for n in ("query", "key", "value"):
        out += [(f"{pre}attention.self.{n}.weight", (h, h)),
                (f"{pre}attention.self.{n}.bias", (h,))]
    out += [(f"{pre}attention.output.dense.weight", (h, h)),
            (f"{pre}attention.output.dense.bias", (h,))]
    if ln1:
        out += [(f"{pre}attention.output.LayerNorm.weight", (h,)),
                (f"{pre}attention.output.LayerNorm.bias", (h,))]
    out += [(f"{pre}intermediate.dense.weight", (inter, h)),
            (f"{pre}intermediate.dense.bias", (inter,)),
            (f"{pre}output.dense.weight", (h, inter)),
            (f"{pre}output.dense.bias", (h,)),
            (f"{pre}output.LayerNorm.weight", (h,)),
            (f"{pre}output.LayerNorm.bias", (h,))]
    return out


def param_specs(cfg: dict, section: str = "final"
                ) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every tensor of the final's checkpoint."""
    if section != "final":
        raise ValueError(f"no reference for the LTT BERT {section!r}")
    h, s = cfg["hidden_size"], cfg["s_attn_hidden_size"]
    n_lab = cfg["num_labels"]
    e = "bert.embeddings."
    out = [(e + "word_embeddings.weight", (cfg["vocab_size"], h)),
           (e + "position_embeddings.weight",
            (cfg["max_position_embeddings"], h)),
           (e + "token_type_embeddings.weight", (cfg["type_vocab_size"], h)),
           (e + "LayerNorm.weight", (h,)), (e + "LayerNorm.bias", (h,))]
    for i in range(cfg["num_hidden_layers"]):
        out += _layer_specs(f"bert.encoder.layers.{i}.", h,
                            cfg["intermediate_size"])
    for i in range(cfg["num_hidden_layers"]):
        for b in SECTIONS[section]["branches"]:
            out += [(f"bert.encoder.s_attn_maps.{b}_{i}.weight", (s, h)),
                    (f"bert.encoder.s_attn_maps.{b}_{i}.bias", (s,))]
            out += _layer_specs(f"bert.encoder.s_attn_layers.{b}_{i}.", s,
                                cfg["s_attn_intermediate_size"])
    out += [("bert_pooler.dense.weight", (h, h)),
            ("bert_pooler.dense.bias", (h,)),
            ("classifier.weight", (n_lab, h)), ("classifier.bias", (n_lab,)),
            ("bert_s_attn_pooler.dense.weight", (s, s)),
            ("bert_s_attn_pooler.dense.bias", (s,)),
            ("s_attn_classifier.weight", (n_lab, s)),
            ("s_attn_classifier.bias", (n_lab,))]
    for j in range(cfg["explainer_s_attn_num_layers"]):
        out += _layer_specs(f"s_attn_attention_layers.{j}.", s,
                            cfg["s_attn_intermediate_size"], ln1=j > 0)
    d = cfg["explainer_s_head_hidden_size"]
    out += [("s_attn_explainer.0.weight", (d, s)),
            ("s_attn_explainer.0.bias", (d,)),
            ("s_attn_explainer.2.weight", (d, d)),
            ("s_attn_explainer.2.bias", (d,)),
            ("s_attn_explainer.4.weight", (n_lab, d)),
            ("s_attn_explainer.4.bias", (n_lab,)),
            ("surrogate_null", (1, n_lab))]
    return out


def bert_layer(h: torch.Tensor, bias: torch.Tensor, p: dict, pre: str,
               heads: int, eps: float, ln1: bool = True) -> torch.Tensor:
    """The post-norm layer: LN1(h + Attn(h)), then LN2(. + MLP(.))."""
    a = h + self_attention(h, bias, p, pre, heads, "add", None)
    if ln1:
        a = ln(a, p, pre + "attention.output.LayerNorm.", eps)
    return ln(a + mlp(a, p, pre, None), p, pre + "output.LayerNorm.", eps)


def pooled_probs(x: torch.Tensor, p: dict, pooler: str,
                 classifier: str) -> torch.Tensor:
    pooled = torch.tanh(linear(x[:, 0, :], p[pooler + "weight"],
                               p[pooler + "bias"]))
    return torch.softmax(linear(pooled, p[classifier + "weight"],
                                p[classifier + "bias"]), dim=-1)


def final(p: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor,
          bits=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids <B, T> -> (class probabilities <B, C>, attributions
    <B, C, T - 1>)."""
    if bits is not None:
        raise ValueError("the LTT BERT reference is float32 only")
    heads, eps = cfg["num_attention_heads"], cfg["layer_norm_eps"]
    e = "bert.embeddings."
    t = ids.shape[1]
    x = p[e + "word_embeddings.weight"][ids] \
        + p[e + "token_type_embeddings.weight"][0] \
        + p[e + "position_embeddings.weight"][:t]
    h = ln(x, p, e + "LayerNorm.", eps)
    bias = h.new_zeros(ids.shape)   # every position attended
    sides = [h.new_zeros(h.shape[:2] + (cfg["s_attn_hidden_size"],))
             for _ in range(2)]
    for i in range(cfg["num_hidden_layers"]):
        h = bert_layer(h, bias, p, f"bert.encoder.layers.{i}.", heads, eps)
        for b in range(2):
            m = f"bert.encoder.s_attn_maps.{b}_{i}."
            x = sides[b] + gelu(linear(h, p[m + "weight"], p[m + "bias"]))
            sides[b] = bert_layer(x, bias, p,
                                  f"bert.encoder.s_attn_layers.{b}_{i}.",
                                  heads, eps)
    probs = pooled_probs(h, p, "bert_pooler.dense.", "classifier.")
    grand = pooled_probs(sides[0], p, "bert_s_attn_pooler.dense.",
                         "s_attn_classifier.")
    x = sides[1]
    for j in range(cfg["explainer_s_attn_num_layers"]):
        x = bert_layer(x, bias, p, f"s_attn_attention_layers.{j}.", heads,
                       eps, ln1=j > 0)
    x = gelu(linear(x, p["s_attn_explainer.0.weight"],
                    p["s_attn_explainer.0.bias"]))
    x = gelu(linear(x, p["s_attn_explainer.2.weight"],
                    p["s_attn_explainer.2.bias"]))
    out = linear(x, p["s_attn_explainer.4.weight"],
                 p["s_attn_explainer.4.bias"])
    out = normalize_shapley(out, grand, p["surrogate_null"])
    return probs, out[:, 1:, :].transpose(1, 2)
