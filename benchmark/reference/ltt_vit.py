"""Plain reference of LTT ViT (AutoGnothi's ladder-side-tuned ViT): one
frozen pre-norm ViT trunk, and beside it 96-wide side ladders, one per
branch, each updated after every trunk layer i as
    side_b <- SideLayer_{b,i}(side_b + GELU(Map_{b,i}(h_i))).
Branch 0 is the surrogate (its side classifier gives the grand coalition
value), branch 1 the explainer (one more side layer without its first
LayerNorm, then LayerNorm + a three-layer MLP head); the attributions are
normalised so that each class sums to grand - null.  Attention masks are
multiplicative (a masked key's score is 0, AutoGnothi's ViT masking).

Parameters are a flat dict under the checkpoint names of the served
program's format (`param_specs`).  `bits=8` runs the W8A8 serving path
the configuration states: the trunk's and the explainer layer's Q/K/V,
output and MLP products and the head's first two products in int8, the
side ladders, the attention itself, the classifiers and the head's last
product in float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .common import (cls_probs, gelu, linear, ln, mlp, normalize_shapley,
                     self_attention)

# which parts each checkpoint section holds
SECTIONS = {
    "surrogate": dict(branches=(0,), srg_head=True, explainer=False),
    "explainer": dict(branches=(0,), srg_head=False, explainer=True),
    "final": dict(branches=(0, 1), srg_head=True, explainer=True),
}
# the frozen trunk: the explainer step trains everything else
FROZEN = ("vit.embeddings.", "vit.encoder.layers.", "vit.layernorm.",
          "classifier.")


def n_tokens(cfg: dict) -> int:
    return (cfg["img_px_size"] // cfg["img_patch_size"]) ** 2 + 1


def _layer_specs(pre: str, h: int, inter: int, ln1: bool = True) -> list:
    out = []
    for n in ("query", "key", "value"):
        out += [(f"{pre}attention.self.{n}.weight", (h, h)),
                (f"{pre}attention.self.{n}.bias", (h,))]
    out += [(f"{pre}attention.output.dense.weight", (h, h)),
            (f"{pre}attention.output.dense.bias", (h,)),
            (f"{pre}intermediate.dense.weight", (inter, h)),
            (f"{pre}intermediate.dense.bias", (inter,)),
            (f"{pre}output.dense.weight", (h, inter)),
            (f"{pre}output.dense.bias", (h,))]
    norms = (["layernorm_before"] if ln1 else []) + ["layernorm_after"]
    for n in norms:
        out += [(f"{pre}{n}.weight", (h,)), (f"{pre}{n}.bias", (h,))]
    return out


def param_specs(cfg: dict, section: str = "final"
                ) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every tensor of a checkpoint section."""
    parts = SECTIONS[section]
    h, s = cfg["hidden_size"], cfg["s_attn_hidden_size"]
    c, ps, n_lab = cfg["img_channels"], cfg["img_patch_size"], \
        cfg["num_labels"]
    e = "vit.embeddings."
    out = [(e + "cls_token", (1, 1, h)),
           (e + "position_embeddings", (1, n_tokens(cfg), h)),
           (e + "patch_embeddings.projection.weight", (h, c, ps, ps)),
           (e + "patch_embeddings.projection.bias", (h,))]
    for i in range(cfg["num_hidden_layers"]):
        out += _layer_specs(f"vit.encoder.layers.{i}.", h,
                            cfg["intermediate_size"])
        for b in parts["branches"]:
            out += [(f"vit.encoder.s_attn_maps.{b}_{i}.weight", (s, h)),
                    (f"vit.encoder.s_attn_maps.{b}_{i}.bias", (s,))]
            out += _layer_specs(f"vit.encoder.s_attn_layers.{b}_{i}.", s,
                                cfg["s_attn_intermediate_size"])
    out += [("vit.layernorm.weight", (h,)), ("vit.layernorm.bias", (h,))]
    for b in parts["branches"]:
        out += [(f"vit.s_attn_layernorm.{b}.weight", (s,)),
                (f"vit.s_attn_layernorm.{b}.bias", (s,))]
    out += [("classifier.weight", (n_lab, h)), ("classifier.bias", (n_lab,))]
    if parts["srg_head"]:
        out += [("s_attn_classifier.weight", (n_lab, s)),
                ("s_attn_classifier.bias", (n_lab,))]
    if parts["explainer"]:
        for j in range(cfg["explainer_s_attn_num_layers"]):
            out += _layer_specs(f"s_explainer_attn.{j}.", s,
                                cfg["s_attn_intermediate_size"], ln1=j > 0)
        d = cfg["explainer_s_head_hidden_size"]
        out += [("s_explainer_mlp.0.weight", (s,)),
                ("s_explainer_mlp.0.bias", (s,)),
                ("s_explainer_mlp.1.weight", (d, s)),
                ("s_explainer_mlp.1.bias", (d,)),
                ("s_explainer_mlp.3.weight", (d, d)),
                ("s_explainer_mlp.3.bias", (d,)),
                ("s_explainer_mlp.5.weight", (n_lab, d)),
                ("s_explainer_mlp.5.bias", (n_lab,))]
    if section == "final":
        out.append(("surrogate_null", (1, n_lab)))
    return out


def embeddings(p: Dict[str, torch.Tensor], cfg: dict,
               pixels: torch.Tensor) -> torch.Tensor:
    """Patches (stride = kernel convolution as a product), CLS, positions."""
    b, c, hh, ww = pixels.shape
    ps, h = cfg["img_patch_size"], cfg["hidden_size"]
    x = pixels.reshape(b, c, hh // ps, ps, ww // ps, ps)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, -1, c * ps * ps)
    e = "vit.embeddings."
    x = linear(x, p[e + "patch_embeddings.projection.weight"].reshape(h, -1),
               p[e + "patch_embeddings.projection.bias"])
    cls = p[e + "cls_token"].expand(b, 1, h)
    return torch.cat([cls, x], dim=1) + p[e + "position_embeddings"]


def vit_layer(h: torch.Tensor, mask: torch.Tensor, p: dict, pre: str,
              heads: int, eps: float, bits: Optional[int],
              ln1: bool = True) -> torch.Tensor:
    """The pre-norm layer: h + Attn(LN1(h)), then + MLP(LN2(.))."""
    x = ln(h, p, pre + "layernorm_before.", eps) if ln1 else h
    h = h + self_attention(x, mask, p, pre, heads, "mul", bits)
    return h + mlp(ln(h, p, pre + "layernorm_after.", eps), p, pre, bits)


def backbone(p: dict, cfg: dict, pixels: torch.Tensor, mask: torch.Tensor,
             branches: Tuple[int, ...], bits: Optional[int],
             emb: Optional[torch.Tensor] = None):
    """The trunk (products in `bits`) with every branch's float ladder
    after each layer, then the final LayerNorms -> (h, [side_b])."""
    heads, eps = cfg["num_attention_heads"], cfg["layer_norm_eps"]
    h = embeddings(p, cfg, pixels) if emb is None else emb
    sides = [h.new_zeros(h.shape[:2] + (cfg["s_attn_hidden_size"],))
             for _ in branches]
    for i in range(cfg["num_hidden_layers"]):
        h = vit_layer(h, mask, p, f"vit.encoder.layers.{i}.", heads, eps,
                      bits)
        for slot, b in enumerate(branches):
            m = f"vit.encoder.s_attn_maps.{b}_{i}."
            x = sides[slot] + gelu(linear(h, p[m + "weight"], p[m + "bias"]))
            sides[slot] = vit_layer(x, mask, p,
                                    f"vit.encoder.s_attn_layers.{b}_{i}.",
                                    heads, eps, None)
    h = ln(h, p, "vit.layernorm.", eps)
    sides = [ln(side, p, f"vit.s_attn_layernorm.{b}.", eps)
             for side, b in zip(sides, branches)]
    return h, sides


def explainer_head(p: dict, cfg: dict, side: torch.Tensor,
                   mask: torch.Tensor, grand: torch.Tensor,
                   null: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """Explainer side layers, LayerNorm (eps 1e-5) + MLP head, the
    efficiency normalisation over all tokens, CLS dropped -> <B, C, P>."""
    heads, eps = cfg["num_attention_heads"], cfg["layer_norm_eps"]
    for j in range(cfg["explainer_s_attn_num_layers"]):
        side = vit_layer(side, mask, p, f"s_explainer_attn.{j}.", heads, eps,
                         bits, ln1=j > 0)
    x = ln(side, p, "s_explainer_mlp.0.", 1e-5)
    x = gelu(linear(x, p["s_explainer_mlp.1.weight"],
                    p["s_explainer_mlp.1.bias"], bits))
    x = gelu(linear(x, p["s_explainer_mlp.3.weight"],
                    p["s_explainer_mlp.3.bias"], bits))
    out = linear(x, p["s_explainer_mlp.5.weight"], p["s_explainer_mlp.5.bias"])
    out = normalize_shapley(out, grand, null)
    return out[:, 1:, :].transpose(1, 2)


def final(p: dict, cfg: dict, pixels: torch.Tensor,
          bits: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The served final with every player on -> (class probabilities
    <B, C>, attributions <B, C, P>)."""
    mask = pixels.new_ones((pixels.shape[0], n_tokens(cfg)))
    h, (srg, exp) = backbone(p, cfg, pixels, mask, (0, 1), bits)
    grand = cls_probs(srg, p, "s_attn_classifier.")
    attr = explainer_head(p, cfg, exp, mask, grand, p["surrogate_null"],
                          bits)
    return cls_probs(h, p, "classifier."), attr


def surrogate_values(p: dict, cfg: dict, pixels: torch.Tensor,
                     masks: torch.Tensor, bits: Optional[int]
                     ) -> torch.Tensor:
    """The surrogate (branch 0's side classifier) over B*M coalitions,
    masks <B, M, P> without the CLS column -> <B*M, C>."""
    b, m, _ = masks.shape
    emb = embeddings(p, cfg, pixels)
    emb = emb[:, None].expand(b, m, *emb.shape[1:]).reshape(
        b * m, *emb.shape[1:])
    full = torch.cat([masks.new_ones((b, m, 1)), masks], dim=-1)
    _, (side,) = backbone(p, cfg, pixels, full.reshape(b * m, -1).float(),
                          (0,), bits, emb=emb)
    return cls_probs(side, p, "s_attn_classifier.")


def explainer_values(p: dict, cfg: dict, pixels: torch.Tensor,
                     grand: torch.Tensor, null: torch.Tensor
                     ) -> torch.Tensor:
    """The explainer section's attributions in float32 with every player
    on (the differentiated forward of the explainer step) -> <B, C, P>."""
    mask = pixels.new_ones((pixels.shape[0], n_tokens(cfg)))
    _, (side,) = backbone(p, cfg, pixels, mask, (0,), None)
    return explainer_head(p, cfg, side, mask, grand, null, None)
