"""The vanilla ViT family (port of `autognothi_tpu/models/vit.py`): the
pre-norm layer, the embeddings and the explainer head the LTT ViT runs
too, and the vanilla towers: classifier, surrogate (the classifier's
architecture), explainer (a backbone, `explainer_attn_num_layers` more
pre-norm layers, the first without `layernorm_before`, and the LayerNorm
+ MLP head) and final (the three towers under `classifier.`,
`surrogate.` and `explainer.`, with the `surrogate_null` buffer).  The
inits return flat numpy dicts (`init_vit_classifier`, ...); a section's
module is `vanilla_vit_model(cfg, section)`.

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
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import gates
from ..ops.attention_block import attention_block
from ..ops.head_block import explainer_head_block
from ..ops.mlp_block import mlp_block
from ..ops.shapley import normalize_shapley_explanation
from ..parallel.tp import dense_col, dense_row
from .common import (dense, dense_serving, dropout, fused_dims_ok, gelu,
                     init_embedding, init_layer_norm, init_linear,
                     layer_norm, maybe_remat, pallas_mode,
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
        masked attention op in mode "1", and which runs tensor-parallel
        where `parallel.mesh.shard_params` sharded the layer's weights
        (`parallel/tp.py`)."""
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
        h = h + dropout(rng, dense_row(ctx, out.weight, out.bias),
                        cfg.hidden_dropout_prob, deterministic)
        normed = layer_norm(h, self.layernorm_after.weight,
                            self.layernorm_after.bias, eps)
        inter = gelu(dense_col(normed, self.intermediate.dense.weight,
                               self.intermediate.dense.bias))
        out = dense_row(inter, self.output.dense.weight,
                        self.output.dense.bias)
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


class ViTBackbone(nn.Module):
    """The `vit.` section (`init_vit_backbone`): `embeddings.*`,
    `encoder.layers.{i}.*` and the final `layernorm.*`."""

    def __init__(self, cfg: VanillaViTConfig):
        super().__init__()
        self.embeddings = ViTEmbeddings(cfg)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            ViTLayer(cfg.hidden_size, cfg.intermediate_size)
            for _ in range(cfg.num_hidden_layers))
        self.layernorm = norm(cfg.hidden_size)

    def reset_parameters(self, generator: torch.Generator) -> None:
        fill_embeddings(self.embeddings, generator)
        for layer in self.encoder.layers:
            layer.reset_parameters(generator)
        fill_norm(self.layernorm)


class ViTClassifier(nn.Module):
    """The vanilla ViT classifier's (and surrogate's) parameters under the
    JAX names (`init_vit_classifier`): `vit.embeddings.*`,
    `vit.encoder.layers.{i}.*`, `vit.layernorm.*`, `classifier.*`."""

    def __init__(self, cfg: VanillaViTConfig):
        super().__init__()
        self.vit = ViTBackbone(cfg)
        self.classifier = linear(cfg.num_labels, cfg.hidden_size)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.vit.reset_parameters(generator)
        fill_linear(self.classifier, generator)


def explainer_layers(cfg: VanillaViTConfig) -> nn.ModuleList:
    """`explainer_attn.{i}.*`: the explainer's pre-norm layers at the trunk
    width, the first without `layernorm_before`."""
    return nn.ModuleList(
        ViTLayer(cfg.hidden_size, cfg.intermediate_size, skip_ln1=(i == 0))
        for i in range(cfg.explainer_attn_num_layers))


def fill_explainer_head(layers: nn.ModuleList, head: nn.ModuleDict,
                        generator: torch.Generator) -> None:
    for layer in layers:
        layer.reset_parameters(generator)
    fill_norm(head["0"])
    for k in ("1", "3", "5"):
        fill_linear(head[k], generator)


class ViTExplainer(nn.Module):
    """The vanilla ViT explainer (`init_vit_explainer`): `vit.*`,
    `explainer_attn.{i}.*` and `explainer_mlp.{0,1,3,5}.*`."""

    def __init__(self, cfg: VanillaViTConfig):
        super().__init__()
        self.vit = ViTBackbone(cfg)
        self.explainer_attn = explainer_layers(cfg)
        self.explainer_mlp = explainer_mlp_head_module(
            cfg.hidden_size, cfg.explainer_head_hidden_size, cfg.num_labels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.vit.reset_parameters(generator)
        fill_explainer_head(self.explainer_attn, self.explainer_mlp,
                            generator)


class ViTFinal(nn.Module):
    """The vanilla ViT final (`init_vit_final`): the three towers under
    `classifier.`, `surrogate.` and `explainer.`, and `surrogate_null`
    <1, n_classes>."""

    def __init__(self, cfg: VanillaViTConfig):
        super().__init__()
        self.classifier = ViTClassifier(cfg)
        self.surrogate = ViTClassifier(cfg)
        self.explainer = ViTExplainer(cfg)
        self.register_buffer("surrogate_null", torch.zeros(1, cfg.num_labels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for tower in (self.classifier, self.surrogate, self.explainer):
            tower.reset_parameters(generator)
        with torch.no_grad():
            self.surrogate_null.zero_()


VANILLA_SECTIONS = {"classifier": ViTClassifier, "surrogate": ViTClassifier,
                    "explainer": ViTExplainer, "final": ViTFinal}


def vanilla_vit_model(cfg: VanillaViTConfig,
                      section: str = "final") -> nn.Module:
    """A checkpoint section's module, created empty: fill it with an init
    or a state dict."""
    if section not in VANILLA_SECTIONS:
        raise ValueError(f"unknown vanilla ViT section {section!r}")
    return VANILLA_SECTIONS[section](cfg)


def _flat(model: nn.Module, generator: torch.Generator
          ) -> Dict[str, np.ndarray]:
    model.reset_parameters(generator)
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def init_vit_backbone(cfg: VanillaViTConfig, generator: torch.Generator
                      ) -> Dict[str, np.ndarray]:
    """A fresh `vit.` section as a flat dict of fp32 numpy arrays."""
    return {f"vit.{k}": v
            for k, v in _flat(ViTBackbone(cfg), generator).items()}


def init_vit_classifier(cfg: VanillaViTConfig, generator: torch.Generator
                        ) -> Dict[str, np.ndarray]:
    """A fresh vanilla ViT classifier as a flat dict of fp32 numpy arrays,
    drawn from `generator` with the JAX package's laws (its keys and
    shapes; not its numbers)."""
    return _flat(ViTClassifier(cfg), generator)


def init_vit_explainer(cfg: VanillaViTConfig, generator: torch.Generator
                       ) -> Dict[str, np.ndarray]:
    return _flat(ViTExplainer(cfg), generator)


def init_vit_final(cfg: VanillaViTConfig, generator: torch.Generator
                   ) -> Dict[str, np.ndarray]:
    return _flat(ViTFinal(cfg), generator)


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


# ------------------------------------------------------- vanilla towers


def vit_encoder(vit: ViTBackbone, cfg: VanillaViTConfig, h: torch.Tensor,
                mask: Optional[torch.Tensor], *, deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """The encoder layers in order (`:286-309`), each under
    `maybe_remat`."""
    for layer in vit.encoder.layers:
        h = maybe_remat(layer, h, mask, cfg, deterministic, rng,
                        generator=rng)
    return h


def vit_backbone(vit: ViTBackbone, cfg: VanillaViTConfig,
                 pixels: torch.Tensor, mask: torch.Tensor, *,
                 deterministic: bool = True,
                 rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """The `vit.` tower: embeddings -> encoder -> final LayerNorm; pixels
    <B, C, H, W> or patches <B, n_patches, C*ps*ps>."""
    h = vit_embeddings(vit.embeddings, cfg, pixels,
                       deterministic=deterministic, rng=rng)
    h = vit_encoder(vit, cfg, h, mask, deterministic=deterministic, rng=rng)
    return layer_norm(h, vit.layernorm.weight, vit.layernorm.bias,
                      cfg.layer_norm_eps)


def _cls_probs(head: nn.Module, h: torch.Tensor) -> torch.Tensor:
    return torch.softmax(dense(h[:, 0, :], head.weight.to(h.dtype),
                               head.bias.to(h.dtype)), dim=-1)


def vit_classifier_fwd(model: ViTClassifier, cfg: VanillaViTConfig,
                       pixels: torch.Tensor, mask: torch.Tensor, *,
                       deterministic: bool = True,
                       rng: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, dict]:
    """-> (<B, n_classes> softmax probabilities, {"repr_cls": the backbone's
    hidden states}) (`:341-355`)."""
    h = vit_backbone(model.vit, cfg, pixels, mask,
                     deterministic=deterministic, rng=rng)
    return _cls_probs(model.classifier, h), {"repr_cls": h}


# the surrogate shares the classifier's architecture
vit_surrogate_fwd = vit_classifier_fwd


def vit_explainer_head(model: nn.Module, cfg: VanillaViTConfig,
                       h: torch.Tensor, mask: torch.Tensor,
                       grand: torch.Tensor, null: torch.Tensor, *,
                       deterministic: bool = True,
                       rng: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """`model`'s explainer layers and MLP head on the backbone's output h;
    the efficiency normalisation runs over all T tokens including CLS,
    then CLS is dropped -> <B, n_classes, n_players> (`:413-435`)."""
    for layer in model.explainer_attn:
        h = layer(h, mask, cfg, deterministic, rng)
    out = explainer_mlp_head(model.explainer_mlp, h)
    if cfg.explainer_normalize:
        out = normalize_shapley_explanation(out, grand, null)
    return out[:, 1:, :].transpose(1, 2)


def vit_explainer_fwd(model: ViTExplainer, cfg: VanillaViTConfig,
                      pixels: torch.Tensor, mask: torch.Tensor,
                      grand: torch.Tensor, null: torch.Tensor, *,
                      deterministic: bool = True,
                      rng: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, dict]:
    """-> (attributions <B, n_classes, n_players>, {"repr_exp": the
    backbone's hidden states}) (`:438-455`)."""
    h = vit_backbone(model.vit, cfg, pixels, mask,
                     deterministic=deterministic, rng=rng)
    attr = vit_explainer_head(model, cfg, h, mask, grand, null,
                              deterministic=deterministic, rng=rng)
    return attr, {"repr_exp": h}


def vit_final_fwd(model: ViTFinal, cfg: VanillaViTConfig,
                  pixels: torch.Tensor, mask: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """-> (class probabilities, attributions, the three towers'
    representations) (`:458-494`): the pixels' patch rearrange is done
    once and shared by the three towers."""
    patches = vit_patch_extract(cfg, pixels) if pixels.dim() == 4 \
        else pixels
    probs, obs_c = vit_classifier_fwd(model.classifier, cfg, patches, mask)
    obs = {"repr_cls": obs_c["repr_cls"]}
    if cfg.explainer_normalize:
        grand, obs_s = vit_surrogate_fwd(model.surrogate, cfg, patches, mask)
        obs["repr_srg"] = obs_s["repr_cls"]
    else:
        grand = torch.zeros_like(probs)
    attr, obs_e = vit_explainer_fwd(model.explainer, cfg, patches, mask,
                                    grand, model.surrogate_null)
    obs["repr_exp"] = obs_e["repr_exp"]
    return probs, attr, obs


def vit_surrogate_coalitions_fwd(model: ViTClassifier, cfg: VanillaViTConfig,
                                 pixels: torch.Tensor,  # <B, C, H, W>
                                 masks: torch.Tensor,   # <B, M, 1 + P>
                                 *, deterministic: bool = True
                                 ) -> torch.Tensor:
    """The surrogate over B*M coalition-masked copies of each image, the
    patch projection and position embedding computed once per image and
    broadcast over M -> <B, M, n_classes> (`:500-533`).  A no-grad teacher
    sweep: eval mode only."""
    if not deterministic:
        raise NotImplementedError(
            "the coalition fast path is a no-grad teacher sweep and runs "
            "eval-mode only")
    b, m, t = masks.shape
    vit = model.vit
    emb = vit_embeddings(vit.embeddings, cfg, pixels)
    h = emb[:, None].expand(b, m, t, emb.shape[-1]).reshape(
        b * m, t, emb.shape[-1])
    h = vit_encoder(vit, cfg, h, masks.reshape(b * m, t))
    h = layer_norm(h, vit.layernorm.weight, vit.layernorm.bias,
                   cfg.layer_norm_eps)
    return _cls_probs(model.classifier, h).reshape(b, m, -1)
