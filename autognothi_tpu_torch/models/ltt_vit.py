"""LTT ViT (port of `autognothi_tpu/models/ltt_vit.py`): one frozen ViT trunk
with 96-wide side ladders beside it.  The surrogate carries ladder branch
0 and its classifier; the explainer carries branch 0, one explainer side
layer and the explainer MLP head; the final model carries both ladders
(branch 0 the surrogate, branch 1 the explainer) and gives class
probabilities and per-patch attributions in one forward pass.

Per trunk layer the backbone takes one of three branches, as the JAX scan
body does (`:245-339`), under the same gates (`:216-243`): the ladder op
only where the side width is at the fused floor (`fused_dims_ok`) and the
step fits the JAX budget (`gates.ladder_block_fits`), and the fused int8
trunk-MLP + ladder step only where it fits as well
(`gates.mlp_ladder_fits`):
- pallas mode "2", no active dropout, int8 mode, both gates: the int8
  attention block (K1), then the int8 trunk MLP fused with every branch's
  ladder step (K2);
- pallas mode "2", no active dropout, the ladder gate: the trunk layer
  (its fused ops, int8 in int8 mode, each under its own gate: K1/K6, and
  K4, the K8q chain or K7), then the ladder op for every branch (K5);
- otherwise: the trunk layer as above and per-branch side layers, whose
  ops are fused (int8 in int8 mode) at or above the fused floor and the
  unfused math with dropout below it or with dropout active; their
  attention takes the masked attention op (K9) in mode "1".
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import gates
from ..ops.ladder_block import ladder_block, mlp_ladder_block
from ..ops.shapley import normalize_shapley_explanation
from .common import (dense, fused_dims_ok, gelu, layer_norm, maybe_remat,
                     pallas_mode, quant_mode)
from .vit import (VanillaViTConfig, ViTEmbeddings, ViTLayer,
                  explainer_mlp_head, explainer_mlp_head_module,
                  fill_embeddings, fill_linear, fill_norm, linear, norm,
                  vit_embeddings)

BRANCHES = (0, 1)
# what each checkpoint section holds: its ladder branches, the surrogate's
# side classifier, the explainer side layers + head, the null buffer (the
# classifier has the surrogate's layout, as `init_classifier` is
# `init_ltt_vit_surrogate` in the JAX recipe)
SECTIONS = {
    "classifier": dict(branches=(0,), srg_head=True, explainer=False),
    "surrogate": dict(branches=(0,), srg_head=True, explainer=False),
    "explainer": dict(branches=(0,), srg_head=False, explainer=True),
    "final": dict(branches=BRANCHES, srg_head=True, explainer=True),
}


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


class LttViT(nn.Module):
    """Parameters of one checkpoint section, "classifier", "surrogate",
    "explainer" or "final" (the JAX `init_ltt_vit_{surrogate,explainer,
    final}`), under the
    JAX package's names.  Created empty: fill with `init_ltt_vit` or a
    state dict."""

    def __init__(self, cfg: LttViTConfig, section: str = "final"):
        super().__init__()
        if section not in SECTIONS:
            raise ValueError(f"unknown LTT ViT section {section!r}")
        self.cfg, self.section = cfg, section
        parts = SECTIONS[section]
        self.branches = parts["branches"]
        h, s = cfg.hidden_size, cfg.s_attn_hidden_size
        n_layers = cfg.num_hidden_layers
        self.vit = nn.Module()
        self.vit.embeddings = ViTEmbeddings(cfg.into())
        self.vit.encoder = nn.Module()
        self.vit.encoder.layers = nn.ModuleList(
            ViTLayer(h, cfg.intermediate_size) for _ in range(n_layers))
        self.vit.encoder.s_attn_maps = nn.ModuleDict(
            {f"{b}_{i}": linear(s, h) for b in self.branches
             for i in range(n_layers)})
        self.vit.encoder.s_attn_layers = nn.ModuleDict(
            {f"{b}_{i}": ViTLayer(s, cfg.s_attn_intermediate_size)
             for b in self.branches for i in range(n_layers)})
        self.vit.layernorm = norm(h)
        self.vit.s_attn_layernorm = nn.ModuleDict(
            {str(b): norm(s) for b in self.branches})
        self.classifier = linear(cfg.num_labels, h)
        if parts["srg_head"]:
            self.s_attn_classifier = linear(cfg.num_labels, s)
        if parts["explainer"]:
            self.s_explainer_attn = nn.ModuleList(
                ViTLayer(s, cfg.s_attn_intermediate_size, skip_ln1=(i == 0))
                for i in range(cfg.explainer_s_attn_num_layers))
            self.s_explainer_mlp = explainer_mlp_head_module(
                s, cfg.explainer_s_head_hidden_size, cfg.num_labels)
        if section == "final":
            self.register_buffer("surrogate_null",
                                 torch.empty(1, cfg.num_labels))


def init_ltt_vit(cfg: LttViTConfig, section: str,
                 generator: torch.Generator) -> LttViT:
    """A fresh section on the CPU, drawn from `generator` with the JAX
    package's distributions (its keys and shapes; not its numbers)."""
    model = LttViT(cfg, section)
    fill_embeddings(model.vit.embeddings, generator)
    if section == "final":
        with torch.no_grad():
            model.surrogate_null.zero_()
    for layer in model.vit.encoder.layers:
        layer.reset_parameters(generator)
    for i in range(cfg.num_hidden_layers):
        for b in model.branches:
            fill_linear(model.vit.encoder.s_attn_maps[f"{b}_{i}"], generator)
            model.vit.encoder.s_attn_layers[f"{b}_{i}"].reset_parameters(
                generator)
    fill_norm(model.vit.layernorm)
    for m in model.vit.s_attn_layernorm.values():
        fill_norm(m)
    fill_linear(model.classifier, generator)
    if SECTIONS[section]["srg_head"]:
        fill_linear(model.s_attn_classifier, generator)
    if SECTIONS[section]["explainer"]:
        for layer in model.s_explainer_attn:
            layer.reset_parameters(generator)
        fill_norm(model.s_explainer_mlp["0"])
        for k in ("1", "3", "5"):
            fill_linear(model.s_explainer_mlp[k], generator)
    return model


def init_ltt_vit_final(cfg: LttViTConfig,
                       generator: torch.Generator) -> LttViT:
    return init_ltt_vit(cfg, "final", generator)


# --------------------------------------------------------------- apply


def _ladder_weights(model: LttViT, branch: int,
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


def _dropout_off(cfg: LttViTConfig, deterministic: bool) -> bool:
    return deterministic or (cfg.attention_probs_dropout_prob == 0.0
                             and cfg.hidden_dropout_prob == 0.0)


def ltt_vit_backbone(model: LttViT, cfg: LttViTConfig,
                     pixels: torch.Tensor, mask: torch.Tensor,
                     branches: Sequence[int], *,
                     ltt_active_layers: Optional[int] = None,
                     deterministic: bool = True,
                     rng: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Embeddings, the trunk layers with the ladder step of every branch
    after each, then the final LayerNorms (`:182-357`).  A branch's ladder
    update at layer i is kept only where i < ltt_active_layers (default:
    every layer); dropout draws from `rng` when not `deterministic`."""
    vit = model.vit
    trunk_cfg, side_cfg = cfg.into(), cfg.side()
    h = vit_embeddings(vit.embeddings, trunk_cfg, pixels,
                       deterministic=deterministic, rng=rng)
    b_sz, t = h.shape[:2]
    sides = [h.new_zeros((b_sz, t, cfg.s_attn_hidden_size))
             for _ in branches]
    heads, eps = cfg.num_attention_heads, cfg.layer_norm_eps
    n_layers = cfg.num_hidden_layers
    active = n_layers if ltt_active_layers is None else int(ltt_active_layers)
    s_hidden = cfg.s_attn_hidden_size
    # the JAX gates (`:216-243`), on the configured token count
    t_cfg = cfg.into().n_patches + 1
    use_ladder_kernel = (
        pallas_mode() == "2" and len(branches) > 0
        and _dropout_off(cfg, deterministic) and fused_dims_ok(s_hidden)
        and gates.ladder_block_fits(cfg.hidden_size, t_cfg, s_hidden, heads,
                                    len(branches)))
    use_mlp_ladder = (
        use_ladder_kernel and quant_mode() == "int8"
        and gates.mlp_ladder_fits(cfg.hidden_size, cfg.intermediate_size,
                                  t_cfg, s_hidden, max(len(branches), 1),
                                  heads))

    def body(i, layer, h, *sides):
        # the trunk layer and every branch's ladder update: one JAX scan
        # body, one `maybe_remat`
        ladders = [_ladder_weights(model, b, i) for b in branches]
        if use_mlp_ladder:
            h, *upds = mlp_ladder_block(
                layer.attend(h, mask, heads, eps, "int8"), sides, mask,
                layer.mlp_weights(), ladders, heads, "mul", eps)
        else:
            h = layer(h, mask, trunk_cfg, deterministic, rng)
            if use_ladder_kernel:
                upds = list(ladder_block(h, sides, mask, ladders, heads,
                                         "mul", True, eps))
            else:
                # both branch maps as one dense, h read once (`:316-324`)
                joint = gelu(dense(
                    h, torch.cat([w["map_w"] for w in ladders]),
                    torch.cat([w["map_b"] for w in ladders])))
                upds = [
                    vit.encoder.s_attn_layers[f"{b}_{i}"](
                        side + joint[..., slot * s_hidden:
                                     (slot + 1) * s_hidden],
                        mask, side_cfg, deterministic, rng)
                    for slot, (b, side) in enumerate(zip(branches, sides))]
        return (h, *(upd if i < active else side
                     for upd, side in zip(upds, sides)))

    for i, layer in enumerate(vit.encoder.layers):
        h, *sides = maybe_remat(body, i, layer, h, *sides, generator=rng)
    h = layer_norm(h, vit.layernorm.weight, vit.layernorm.bias, eps)
    sides = [layer_norm(side, vit.s_attn_layernorm[str(b)].weight,
                        vit.s_attn_layernorm[str(b)].bias, eps)
             for side, b in zip(sides, branches)]
    return h, sides


def _cls_head(head: nn.Module, h: torch.Tensor) -> torch.Tensor:
    return torch.softmax(dense(h[:, 0, :], head.weight.to(h.dtype),
                               head.bias.to(h.dtype)), dim=-1)


def ltt_vit_surrogate_fwd(model: LttViT, cfg: LttViTConfig,
                          pixels: torch.Tensor, mask: torch.Tensor, **kw
                          ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """-> (surrogate probabilities from branch 0, classifier probabilities,
    the representations {"repr_cls": trunk h, "repr_srg": branch 0's side},
    both after their final LayerNorms) (`:368-373`)."""
    h, (side,) = ltt_vit_backbone(model, cfg, pixels, mask, (0,), **kw)
    return _cls_head(model.s_attn_classifier, side), \
        _cls_head(model.classifier, h), {"repr_cls": h, "repr_srg": side}


def ltt_vit_explainer_head(model: LttViT, cfg: LttViTConfig,
                           side: torch.Tensor, mask: torch.Tensor,
                           grand: torch.Tensor, null: torch.Tensor, *,
                           deterministic: bool = True,
                           rng: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """Explainer side layers + MLP head; the efficiency normalisation runs
    over all T tokens including CLS, then CLS is dropped -> <B, C, n_players>
    (`:376-400`)."""
    side_cfg = cfg.side()
    for layer in model.s_explainer_attn:
        side = layer(side, mask, side_cfg, deterministic, rng)
    out = explainer_mlp_head(model.s_explainer_mlp, side)
    if cfg.explainer_normalize:
        out = normalize_shapley_explanation(out, grand, null)
    return out[:, 1:, :].transpose(1, 2)


def ltt_vit_explainer_fwd(model: LttViT, cfg: LttViTConfig,
                          pixels: torch.Tensor, mask: torch.Tensor,
                          grand: torch.Tensor, null: torch.Tensor, *,
                          ltt_active_layers: Optional[int] = None,
                          deterministic: bool = True,
                          rng: Optional[torch.Generator] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """-> (attributions <B, C, n_players>, classifier probabilities, the
    representations {"repr_cls": trunk h, "repr_exp": branch 0's side})
    (`:403-416`)."""
    h, (side,) = ltt_vit_backbone(model, cfg, pixels, mask, (0,),
                                  ltt_active_layers=ltt_active_layers,
                                  deterministic=deterministic, rng=rng)
    logits = _cls_head(model.classifier, h)
    attr = ltt_vit_explainer_head(model, cfg, side, mask, grand, null,
                                  deterministic=deterministic, rng=rng)
    return attr, logits, {"repr_cls": h, "repr_exp": side}


def ltt_vit_final_fwd(model: LttViT, cfg: LttViTConfig,
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


def ltt_vit_surrogate_coalitions_fwd(model: LttViT, cfg: LttViTConfig,
                                     pixels: torch.Tensor,   # <B, C, H, W>
                                     masks: torch.Tensor,    # <B, M, 1 + P>
                                     *, deterministic: bool = True
                                     ) -> torch.Tensor:
    """The surrogate (branch 0) over B*M coalitions with the embeddings
    computed once per image and broadcast over M -> <B, M, n_classes>
    (`:444-518`).  A no-grad teacher sweep: eval mode only."""
    if not deterministic:
        raise NotImplementedError(
            "the coalition fast path is a no-grad teacher sweep and runs "
            "eval-mode only")
    b, m, t = masks.shape
    vit = model.vit
    trunk_cfg, side_cfg = cfg.into(), cfg.side()
    emb = vit_embeddings(vit.embeddings, trunk_cfg, pixels)
    h = emb[:, None].expand(b, m, t, emb.shape[-1]).reshape(
        b * m, t, emb.shape[-1])
    flat_masks = masks.reshape(b * m, t)
    side = h.new_zeros((b * m, t, cfg.s_attn_hidden_size))
    heads, eps = cfg.num_attention_heads, cfg.layer_norm_eps
    s_hidden = cfg.s_attn_hidden_size
    use_ladder_kernel = (
        pallas_mode() == "2" and fused_dims_ok(s_hidden)
        and gates.ladder_block_fits(cfg.hidden_size,
                                    cfg.into().n_patches + 1, s_hidden,
                                    heads, 1))

    def body(i, layer, h, side):
        h = layer(h, flat_masks, trunk_cfg)
        if use_ladder_kernel:
            (side,) = ladder_block(h, [side], flat_masks,
                                   [_ladder_weights(model, 0, i)], heads,
                                   "mul", True, eps)
            return h, side
        s_map = vit.encoder.s_attn_maps[f"0_{i}"]
        side = side + gelu(dense(h, s_map.weight, s_map.bias))
        return h, vit.encoder.s_attn_layers[f"0_{i}"](side, flat_masks,
                                                      side_cfg)

    # a no-grad teacher sweep: `maybe_remat` runs each layer as it is
    for i, layer in enumerate(vit.encoder.layers):
        h, side = maybe_remat(body, i, layer, h, side)
    side = layer_norm(side, vit.s_attn_layernorm["0"].weight,
                      vit.s_attn_layernorm["0"].bias, eps)
    return _cls_head(model.s_attn_classifier, side).reshape(b, m, -1)


# --------------------------------------------------------- freeze rules


def ltt_vit_trainable(cfg: LttViTConfig,
                      section: str) -> Callable[[str], bool]:
    """The frozen trunk: embeddings, trunk layers, its LayerNorm and the
    classifier receive no updates (`:521-530`)."""
    frozen_prefixes = ("vit.embeddings.", "vit.encoder.layers.",
                       "vit.layernorm.", "classifier.")

    def trainable(name: str) -> bool:
        return not name.startswith(frozen_prefixes)

    return trainable


def ltt_vit_progressive(cfg: LttViTConfig, section: str,
                        unfrozen: int) -> Callable[[str], bool]:
    """Progressive training: ladder maps and side layers train only below
    layer `unfrozen` (`:533-542`)."""
    def keep(name: str) -> bool:
        for marker in ("s_attn_maps.", "s_attn_layers."):
            if marker in name:
                tail = name.split(marker, 1)[1]
                return int(tail.split(".")[0].split("_")[1]) < unfrozen
        return True

    return keep
