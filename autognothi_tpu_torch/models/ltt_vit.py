"""LTT ViT final model (port of the serving path of
`autognothi_tpu/models/ltt_vit.py`): one frozen ViT trunk with two 96-wide
side ladders beside it (branch 0 the surrogate, branch 1 the explainer),
one explainer side layer, the explainer MLP head and the efficiency
normalisation, giving class probabilities and per-patch attributions in one
forward pass.  With AUTOGNOTHI_INT8=1 (`quant_mode()`) the forward is the
W8A8 serving path: per trunk layer the int8 attention block (K1) and the
int8 trunk MLP fused with both ladder updates (K2); the explainer side
layer as int8 attention and MLP blocks (K1, K4); the fused int8 head
(K3)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..ops.ladder_block import ladder_block, mlp_ladder_block
from ..ops.shapley import normalize_shapley_explanation
from .common import dense, init_embedding, init_linear, layer_norm, quant_mode
from .vit import (VanillaViTConfig, ViTEmbeddings, ViTLayer,
                  explainer_mlp_head, explainer_mlp_head_module, fill_linear,
                  fill_norm, linear, norm, vit_embeddings)

BRANCHES = (0, 1)


@dataclasses.dataclass(frozen=True)
class LttViTConfig:
    attention_probs_dropout_prob: float
    explainer_s_attn_num_layers: int
    explainer_s_head_hidden_size: int
    explainer_normalize: bool
    hidden_dropout_prob: float
    hidden_size: int
    intermediate_size: int
    layer_norm_eps: float
    num_attention_heads: int
    num_hidden_layers: int
    num_labels: int
    s_attn_hidden_size: int
    s_attn_intermediate_size: int
    img_channels: int
    img_px_size: int
    img_patch_size: int

    def into(self) -> VanillaViTConfig:
        return VanillaViTConfig(
            attention_probs_dropout_prob=self.attention_probs_dropout_prob,
            explainer_attn_num_layers=self.explainer_s_attn_num_layers,
            explainer_head_hidden_size=self.explainer_s_head_hidden_size,
            explainer_normalize=self.explainer_normalize,
            hidden_dropout_prob=self.hidden_dropout_prob,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            layer_norm_eps=self.layer_norm_eps,
            num_attention_heads=self.num_attention_heads,
            num_hidden_layers=self.num_hidden_layers,
            num_labels=self.num_labels,
            img_channels=self.img_channels,
            img_px_size=self.img_px_size,
            img_patch_size=self.img_patch_size,
        )

    def side(self) -> VanillaViTConfig:
        return dataclasses.replace(
            self.into(), hidden_size=self.s_attn_hidden_size,
            intermediate_size=self.s_attn_intermediate_size)


class LttViTFinal(nn.Module):
    """Parameters of `init_ltt_vit_final`, under the same names.  Created
    empty: fill with `init_ltt_vit_final` or a state dict."""

    def __init__(self, cfg: LttViTConfig):
        super().__init__()
        self.cfg = cfg
        h, s = cfg.hidden_size, cfg.s_attn_hidden_size
        n_layers = cfg.num_hidden_layers
        self.vit = nn.Module()
        self.vit.embeddings = ViTEmbeddings(cfg.into())
        self.vit.encoder = nn.Module()
        self.vit.encoder.layers = nn.ModuleList(
            ViTLayer(h, cfg.intermediate_size) for _ in range(n_layers))
        self.vit.encoder.s_attn_maps = nn.ModuleDict(
            {f"{b}_{i}": linear(s, h) for b in BRANCHES
             for i in range(n_layers)})
        self.vit.encoder.s_attn_layers = nn.ModuleDict(
            {f"{b}_{i}": ViTLayer(s, cfg.s_attn_intermediate_size)
             for b in BRANCHES for i in range(n_layers)})
        self.vit.layernorm = norm(h)
        self.vit.s_attn_layernorm = nn.ModuleDict(
            {str(b): norm(s) for b in BRANCHES})
        self.classifier = linear(cfg.num_labels, h)
        self.s_attn_classifier = linear(cfg.num_labels, s)
        self.s_explainer_attn = nn.ModuleList(
            ViTLayer(s, cfg.s_attn_intermediate_size, skip_ln1=(i == 0))
            for i in range(cfg.explainer_s_attn_num_layers))
        self.s_explainer_mlp = explainer_mlp_head_module(
            s, cfg.explainer_s_head_hidden_size, cfg.num_labels)
        self.register_buffer("surrogate_null",
                             torch.empty(1, cfg.num_labels))


def init_ltt_vit_final(cfg: LttViTConfig,
                       generator: torch.Generator) -> LttViTFinal:
    """A fresh LTT ViT final on the CPU, drawn from `generator` with the
    JAX package's distributions (its keys and shapes; not its numbers)."""
    model = LttViTFinal(cfg)
    emb = model.vit.embeddings
    with torch.no_grad():
        emb.cls_token.copy_(init_embedding(generator, *emb.cls_token.shape))
        emb.position_embeddings.copy_(
            init_embedding(generator, *emb.position_embeddings.shape))
        # conv default init: fan_in = C * P * P
        proj = emb.patch_embeddings.projection
        w, b = init_linear(generator, proj.weight.shape[0],
                           proj.weight[0].numel())
        proj.weight.copy_(w.reshape(proj.weight.shape))
        proj.bias.copy_(b)
        model.surrogate_null.zero_()
    for layer in model.vit.encoder.layers:
        layer.reset_parameters(generator)
    for i in range(cfg.num_hidden_layers):
        for b in BRANCHES:
            fill_linear(model.vit.encoder.s_attn_maps[f"{b}_{i}"], generator)
            model.vit.encoder.s_attn_layers[f"{b}_{i}"].reset_parameters(
                generator)
    fill_norm(model.vit.layernorm)
    for m in model.vit.s_attn_layernorm.values():
        fill_norm(m)
    fill_linear(model.classifier, generator)
    fill_linear(model.s_attn_classifier, generator)
    for layer in model.s_explainer_attn:
        layer.reset_parameters(generator)
    fill_norm(model.s_explainer_mlp["0"])
    for k in ("1", "3", "5"):
        fill_linear(model.s_explainer_mlp[k], generator)
    return model


# --------------------------------------------------------------- apply


def _ladder_weights(model: LttViTFinal, branch: int,
                    layer: int) -> Dict[str, torch.Tensor]:
    """The dict `ladder_block` takes, for one branch at one trunk layer."""
    m = model.vit.encoder.s_attn_maps[f"{branch}_{layer}"]
    s = model.vit.encoder.s_attn_layers[f"{branch}_{layer}"]
    sa = s.attention.get_submodule("self")
    return {
        "map_w": m.weight, "map_b": m.bias,
        "ln1_w": s.layernorm_before.weight, "ln1_b": s.layernorm_before.bias,
        "wq": sa.query.weight, "bq": sa.query.bias,
        "wk": sa.key.weight, "bk": sa.key.bias,
        "wv": sa.value.weight, "bv": sa.value.bias,
        "wo": s.attention.output.dense.weight,
        "bo": s.attention.output.dense.bias,
        "ln2_w": s.layernorm_after.weight, "ln2_b": s.layernorm_after.bias,
        "w1": s.intermediate.dense.weight, "b1": s.intermediate.dense.bias,
        "w2": s.output.dense.weight, "b2": s.output.dense.bias,
    }


def ltt_vit_backbone(model: LttViTFinal, cfg: LttViTConfig,
                     pixels: torch.Tensor, mask: torch.Tensor,
                     branches: Sequence[int]
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Embeddings, the trunk layers with the ladder step of every branch
    after each, then the final LayerNorms (`:182-357`).  int8 mode: the
    trunk layer's attention block, then one op for its MLP block and the
    ladder step (`:251-291`)."""
    vit = model.vit
    h = vit_embeddings(vit.embeddings, cfg.into(), pixels)
    b_sz, t = h.shape[:2]
    sides = [h.new_zeros((b_sz, t, cfg.s_attn_hidden_size))
             for _ in branches]
    heads, eps = cfg.num_attention_heads, cfg.layer_norm_eps
    int8 = quant_mode() == "int8"
    for i, layer in enumerate(vit.encoder.layers):
        ladders = [_ladder_weights(model, b, i) for b in branches]
        if int8:
            h, *sides = mlp_ladder_block(
                layer.attend(h, mask, heads, eps, "int8"), sides, mask,
                layer.mlp_weights(), ladders, heads, "mul", eps)
            continue
        h = layer(h, mask, heads, eps)
        sides = list(ladder_block(h, sides, mask, ladders, heads, "mul",
                                  True, eps))
    h = layer_norm(h, vit.layernorm.weight, vit.layernorm.bias,
                   cfg.layer_norm_eps)
    sides = [layer_norm(side, vit.s_attn_layernorm[str(b)].weight,
                        vit.s_attn_layernorm[str(b)].bias, cfg.layer_norm_eps)
             for side, b in zip(sides, branches)]
    return h, sides


def _cls_head(head: nn.Module, h: torch.Tensor) -> torch.Tensor:
    return torch.softmax(dense(h[:, 0, :], head.weight.to(h.dtype),
                               head.bias.to(h.dtype)), dim=-1)


def ltt_vit_explainer_head(model: LttViTFinal, cfg: LttViTConfig,
                           side: torch.Tensor, mask: torch.Tensor,
                           grand: torch.Tensor,
                           null: torch.Tensor) -> torch.Tensor:
    """Explainer side layers + MLP head; the efficiency normalisation runs
    over all T tokens including CLS, then CLS is dropped -> <B, C, n_players>
    (`:376-400`)."""
    side_cfg = cfg.side()
    for layer in model.s_explainer_attn:
        side = layer(side, mask, side_cfg.num_attention_heads,
                     side_cfg.layer_norm_eps, quant_mode())
    out = explainer_mlp_head(model.s_explainer_mlp, side)
    if cfg.explainer_normalize:
        out = normalize_shapley_explanation(out, grand, null)
    return out[:, 1:, :].transpose(1, 2)


def ltt_vit_final_fwd(model: LttViTFinal, cfg: LttViTConfig,
                      pixels: torch.Tensor, mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (class probabilities <B, C>, attributions <B, C, n_players>)
    (`:419-441`)."""
    if cfg.explainer_normalize:
        h, (srg_side, exp_side) = ltt_vit_backbone(model, cfg, pixels, mask,
                                                   (0, 1))
        grand = _cls_head(model.s_attn_classifier, srg_side)
    else:
        h, (exp_side,) = ltt_vit_backbone(model, cfg, pixels, mask, (1,))
        grand = h.new_zeros((pixels.shape[0], cfg.num_labels))
    logits = _cls_head(model.classifier, h)
    attr = ltt_vit_explainer_head(model, cfg, exp_side, mask, grand,
                                  model.surrogate_null)
    return logits, attr
