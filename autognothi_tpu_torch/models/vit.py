"""ViT building blocks (port of the parts of `autognothi_tpu/models/vit.py`
that the LTT ViT runs: the pre-norm layer, the embeddings, the explainer
head), and the vanilla ViT classifier's parameters and init
(`init_vit_classifier`, as flat numpy dicts), which the LTT ViT recipe's
conversion of a base model builds on.

Modules hold parameters under exactly the JAX flat names, e.g.
`attention.self.query.weight` or `layernorm_before.bias`, so a JAX
parameter dict loads with `load_state_dict(strict=True)`.  In pallas mode
"2" with no active dropout, at a width no narrower than the fused floor
(`fused_dims_ok`), the layer runs through the fused attention-block
and MLP-block ops, which pick the CUDA kernel for CUDA tensors and the plain
version for CPU tensors (their W8A8 versions in int8 mode, where the
explainer head is its fused int8 op); otherwise it runs the unfused math
with dropout, whose attention is the masked attention op in mode "1".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops import gates
from ..ops.attention_block import attention_block
from ..ops.head_block import explainer_head_block
from ..ops.mlp_block import mlp_block
from .common import (dense, dense_serving, dropout, fused_dims_ok, gelu,
                     init_embedding, init_layer_norm, init_linear,
                     layer_norm, pallas_mode,
                     quant_mode, self_attention)


@dataclasses.dataclass(frozen=True)
class VanillaViTConfig:
    attention_probs_dropout_prob: float
    explainer_attn_num_layers: int
    explainer_head_hidden_size: int
    explainer_normalize: bool
    hidden_dropout_prob: float
    hidden_size: int
    intermediate_size: int
    layer_norm_eps: float
    num_attention_heads: int
    num_hidden_layers: int
    num_labels: int
    img_channels: int
    img_px_size: int
    img_patch_size: int

    @property
    def n_patches(self) -> int:
        return (self.img_px_size // self.img_patch_size) ** 2


# ------------------------------------------------------------- modules


def linear(d_out: int, d_in: int) -> nn.Module:
    """A `weight` (out, in) + `bias` holder; values come from an init
    function or a state dict."""
    m = nn.Module()
    m.weight = nn.Parameter(torch.empty(d_out, d_in))
    m.bias = nn.Parameter(torch.empty(d_out))
    return m


def norm(d: int) -> nn.Module:
    m = nn.Module()
    m.weight = nn.Parameter(torch.empty(d))
    m.bias = nn.Parameter(torch.empty(d))
    return m


def fill_linear(m: nn.Module, generator: torch.Generator) -> None:
    w, b = init_linear(generator, *m.weight.shape)
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)


def fill_norm(m: nn.Module) -> None:
    w, b = init_layer_norm(m.weight.shape[0])
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)


class ViTLayer(nn.Module):
    """Pre-norm ViT layer (`_vit_layer_body`, `:228-315`); `skip_ln1`
    leaves out `layernorm_before` (the first explainer layer)."""

    def __init__(self, hidden: int, inter: int, skip_ln1: bool = False):
        super().__init__()
        self.attention = nn.Module()
        self_attn = nn.Module()
        for name in ("query", "key", "value"):
            self_attn.add_module(name, linear(hidden, hidden))
        self.attention.add_module("self", self_attn)
        self.attention.output = nn.Module()
        self.attention.output.dense = linear(hidden, hidden)
        self.intermediate = nn.Module()
        self.intermediate.dense = linear(inter, hidden)
        self.output = nn.Module()
        self.output.dense = linear(hidden, inter)
        self.has_ln1 = not skip_ln1
        if self.has_ln1:
            self.layernorm_before = norm(hidden)
        self.layernorm_after = norm(hidden)

    def reset_parameters(self, generator: torch.Generator) -> None:
        sa = self.attention.get_submodule("self")
        for m in (sa.query, sa.key, sa.value, self.attention.output.dense,
                  self.intermediate.dense, self.output.dense):
            fill_linear(m, generator)
        if self.has_ln1:
            fill_norm(self.layernorm_before)
        fill_norm(self.layernorm_after)

    def attend(self, h: torch.Tensor, mask: torch.Tensor, n_heads: int,
               eps: float, quant: str = "none") -> torch.Tensor:
        """The attention half: h + OutProj(Attn(LN1?(h)))."""
        sa = self.attention.get_submodule("self")
        ln1 = ((self.layernorm_before.weight, self.layernorm_before.bias, eps)
               if self.has_ln1 else None)
        return attention_block(
            h, mask,
            (sa.query.weight, sa.query.bias, sa.key.weight, sa.key.bias,
             sa.value.weight, sa.value.bias,
             self.attention.output.dense.weight,
             self.attention.output.dense.bias),
            n_heads, "mul", ln=ln1, ln_position="prologue", quant=quant)

    def mlp_weights(self) -> dict:
        """The MLP half's weights under the keys `mlp_ladder_block` takes."""
        return {"w1": self.intermediate.dense.weight,
                "b1": self.intermediate.dense.bias,
                "w2": self.output.dense.weight, "b2": self.output.dense.bias,
                "ln_w": self.layernorm_after.weight,
                "ln_b": self.layernorm_after.bias}

    def forward(self, h: torch.Tensor, mask: Optional[torch.Tensor],
                cfg: VanillaViTConfig, deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """The pre-norm layer (`_vit_layer_body`): in pallas mode "2", with
        a mask, no active dropout and a width at the fused floor
        (`fused_dims_ok`), the fused attention-block and MLP-block ops
        (their int8 versions in int8 mode); otherwise the unfused,
        unquantized math with dropout, whose `self_attention` takes the
        masked attention op in mode "1"."""
        heads, eps = cfg.num_attention_heads, cfg.layer_norm_eps
        dropout_off = deterministic or (
            cfg.attention_probs_dropout_prob == 0.0
            and cfg.hidden_dropout_prob == 0.0)
        if pallas_mode() == "2" and dropout_off and mask is not None \
                and h.dim() == 3 and fused_dims_ok(cfg.hidden_size):
            quant = quant_mode()
            h = self.attend(h, mask, heads, eps, quant)
            w = self.mlp_weights()
            return mlp_block(h, w["w1"], w["b1"], w["w2"], w["b2"],
                             ln=(w["ln_w"], w["ln_b"], eps),
                             ln_position="prologue", quant=quant)
        sa = self.attention.get_submodule("self")
        normed = (layer_norm(h, self.layernorm_before.weight,
                             self.layernorm_before.bias, eps)
                  if self.has_ln1 else h)
        ctx = self_attention(
            normed, sa.query.weight, sa.query.bias, sa.key.weight,
            sa.key.bias, sa.value.weight, sa.value.bias, heads, mask,
            "multiplicative", attn_dropout=cfg.attention_probs_dropout_prob,
            generator=rng, deterministic=deterministic)
        out = self.attention.output.dense
        h = h + dropout(rng, dense(ctx, out.weight, out.bias),
                        cfg.hidden_dropout_prob, deterministic)
        normed = layer_norm(h, self.layernorm_after.weight,
                            self.layernorm_after.bias, eps)
        inter = gelu(dense(normed, self.intermediate.dense.weight,
                           self.intermediate.dense.bias))
        out = dense(inter, self.output.dense.weight, self.output.dense.bias)
        return h + dropout(rng, out, cfg.hidden_dropout_prob, deterministic)


class ViTEmbeddings(nn.Module):
    def __init__(self, cfg: VanillaViTConfig):
        super().__init__()
        h, c, ps = cfg.hidden_size, cfg.img_channels, cfg.img_patch_size
        self.cls_token = nn.Parameter(torch.empty(1, 1, h))
        self.position_embeddings = nn.Parameter(
            torch.empty(1, cfg.n_patches + 1, h))
        self.patch_embeddings = nn.Module()
        self.patch_embeddings.projection = nn.Module()
        self.patch_embeddings.projection.weight = nn.Parameter(
            torch.empty(h, c, ps, ps))
        self.patch_embeddings.projection.bias = nn.Parameter(torch.empty(h))


def fill_embeddings(emb: ViTEmbeddings, generator: torch.Generator) -> None:
    """The JAX `init_vit_backbone`'s embeddings: normal CLS token and
    position embeddings; the patch projection as the conv default (fan_in
    = C * P * P)."""
    with torch.no_grad():
        emb.cls_token.copy_(init_embedding(generator, *emb.cls_token.shape))
        emb.position_embeddings.copy_(
            init_embedding(generator, *emb.position_embeddings.shape))
        proj = emb.patch_embeddings.projection
        w, b = init_linear(generator, proj.weight.shape[0],
                           proj.weight[0].numel())
        proj.weight.copy_(w.reshape(proj.weight.shape))
        proj.bias.copy_(b)


class ViTClassifier(nn.Module):
    """The vanilla ViT classifier's parameters under the JAX names
    (`init_vit_classifier`): `vit.embeddings.*`, `vit.encoder.layers.{i}.*`,
    `vit.layernorm.*`, `classifier.*`."""

    def __init__(self, cfg: VanillaViTConfig):
        super().__init__()
        self.vit = nn.Module()
        self.vit.embeddings = ViTEmbeddings(cfg)
        self.vit.encoder = nn.Module()
        self.vit.encoder.layers = nn.ModuleList(
            ViTLayer(cfg.hidden_size, cfg.intermediate_size)
            for _ in range(cfg.num_hidden_layers))
        self.vit.layernorm = norm(cfg.hidden_size)
        self.classifier = linear(cfg.num_labels, cfg.hidden_size)


def init_vit_classifier(cfg: VanillaViTConfig, generator: torch.Generator
                        ) -> Dict[str, np.ndarray]:
    """A fresh vanilla ViT classifier as a flat dict of fp32 numpy arrays,
    drawn from `generator` with the JAX package's laws (its keys and
    shapes; not its numbers)."""
    model = ViTClassifier(cfg)
    fill_embeddings(model.vit.embeddings, generator)
    for layer in model.vit.encoder.layers:
        layer.reset_parameters(generator)
    fill_norm(model.vit.layernorm)
    fill_linear(model.classifier, generator)
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def explainer_mlp_head_module(d_in: int, d_hidden: int,
                              n_labels: int) -> nn.ModuleDict:
    """LN + three denses under the keys "0", "1", "3", "5" of the JAX
    names (`explainer_mlp.{0,1,3,5}.*`)."""
    return nn.ModuleDict({"0": norm(d_in), "1": linear(d_hidden, d_in),
                          "3": linear(d_hidden, d_hidden),
                          "5": linear(n_labels, d_hidden)})


# --------------------------------------------------------------- apply


def vit_patch_extract(cfg: VanillaViTConfig,
                      pixels: torch.Tensor) -> torch.Tensor:
    """<B, C, H, W> -> <B, n_patches, C*ps*ps>: a pure rearrange."""
    b, c, hh, ww = pixels.shape
    ps = cfg.img_patch_size
    gh, gw = hh // ps, ww // ps
    x = pixels.reshape(b, c, gh, ps, gw, ps)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * ps * ps)


def vit_patch_embed(emb: ViTEmbeddings, cfg: VanillaViTConfig,
                    pixels: torch.Tensor) -> torch.Tensor:
    """Patch projection as reshape + dense (the stride == kernel conv)."""
    x = pixels if pixels.dim() == 3 else vit_patch_extract(cfg, pixels)
    proj = emb.patch_embeddings.projection
    return dense(x, proj.weight.reshape(cfg.hidden_size, -1), proj.bias)


def vit_embeddings(emb: ViTEmbeddings, cfg: VanillaViTConfig,
                   pixels: torch.Tensor, *, deterministic: bool = True,
                   rng: Optional[torch.Generator] = None) -> torch.Tensor:
    x = vit_patch_embed(emb, cfg, pixels)
    cls = emb.cls_token.to(x.dtype).expand(x.shape[0], 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + emb.position_embeddings.to(x.dtype)
    return dropout(rng, x, cfg.hidden_dropout_prob, deterministic)


def explainer_mlp_head(head: nn.ModuleDict, h: torch.Tensor) -> torch.Tensor:
    """LN (torch default eps 1e-5) -> d1 -> GELU -> d2 -> GELU -> d3.  In
    int8 mode, when d1 and d2 are equally wide and a token tile fits the
    JAX budget (`models/vit.py:398-401`, `gates.head_token_tile`), the
    whole head is the fused int8 head op (K3, `ops/head_block.py`).
    Otherwise it is plain: LN and `dense_serving` denses (W8A8 in int8
    mode), as the JAX package runs them outside any Pallas kernel."""
    ln_w, ln_b = head["0"].weight, head["0"].bias
    d1, d2, d3 = head["1"], head["3"], head["5"]
    if quant_mode() == "int8" and h.dim() == 3 \
            and d1.weight.shape[0] == d2.weight.shape[0] \
            and gates.head_token_tile(h.shape[-2], h.shape[-1],
                                      d1.weight.shape[0],
                                      d3.weight.shape[0]) is not None:
        return explainer_head_block(h, d1.weight, d1.bias, d2.weight,
                                    d2.bias, d3.weight, d3.bias, ln_w, ln_b,
                                    1e-5)
    h = layer_norm(h, ln_w, ln_b, 1e-5)
    h = gelu(dense_serving(h, d1.weight, d1.bias))
    h = gelu(dense_serving(h, d2.weight, d2.bias))
    return dense(h, d3.weight, d3.bias)
