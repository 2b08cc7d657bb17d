"""The vanilla BERT family (port of `autognothi_tpu/models/bert.py`): the
config, the embeddings and the post-norm layer the LTT BERT runs too, and
the vanilla towers: classifier and surrogate (`bert.*`,
`bert_pooler.dense.*`, `classifier.*`), explainer (`bert.*`,
`explainer_attn.{i}.*`, the first layer without
`attention.output.LayerNorm`, and the head `explainer_mlp.{0,2,4}.*`,
three denses without a LayerNorm) and final (the three towers under
`classifier.`, `surrogate.` and `explainer.`, and `surrogate_null`).  The
inits return flat numpy dicts; a section's module is
`vanilla_bert_model(cfg, section)`.

Modules hold parameters under exactly the JAX flat names (e.g.
`attention.self.query.weight`, `attention.output.LayerNorm.bias`), so a
JAX parameter dict loads with `load_state_dict(strict=True)`.  The mask
enters as BERT's additive bias (`models/common.py:additive_mask_bias`).
In pallas mode "2" with no active dropout, at a width no narrower than
the fused floor (`fused_dims_ok`), the layer runs through the
attention-block op with the "add" mask and the LN epilogue (no LN where
`ident_ln1`, the first explainer side layer) and the MLP-block op with
the LN epilogue, int8 in int8 mode: each op consults the JAX budget
gates itself (`ops/gates.py`).  Otherwise the unfused, unquantized
post-norm math with dropout, whose attention takes the masked attention
op in mode "1".
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
from .common import (additive_mask_bias, dense, dense_serving, dropout,
                     fused_dims_ok, gelu, init_embedding, layer_norm,
                     maybe_remat, pallas_mode, quant_mode, self_attention)
from .vit import fill_linear, fill_norm, linear, norm


@dataclasses.dataclass(frozen=True)
class VanillaBertConfig:
    attention_probs_dropout_prob: float
    explainer_attn_num_layers: int
    explainer_head_hidden_size: int
    explainer_normalize: bool
    hidden_dropout_prob: float
    hidden_size: int
    intermediate_size: int
    layer_norm_eps: float
    max_position_embeddings: int
    num_attention_heads: int
    num_hidden_layers: int
    num_labels: int
    pad_token_id: int
    type_vocab_size: int
    vocab_size: int


def _table(n: int, d: int) -> nn.Module:
    m = nn.Module()
    m.weight = nn.Parameter(torch.empty(n, d))
    return m


class BertEmbeddings(nn.Module):
    """`embeddings.{word,position,token_type}_embeddings.weight` and
    `embeddings.LayerNorm.*`."""

    def __init__(self, cfg: VanillaBertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.pad_token_id = cfg.pad_token_id
        self.word_embeddings = _table(cfg.vocab_size, h)
        self.position_embeddings = _table(cfg.max_position_embeddings, h)
        self.token_type_embeddings = _table(cfg.type_vocab_size, h)
        self.LayerNorm = norm(h)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1) tables, the padding row zero (torch's padding_idx)."""
        with torch.no_grad():
            for m in (self.word_embeddings, self.position_embeddings,
                      self.token_type_embeddings):
                m.weight.copy_(init_embedding(generator, *m.weight.shape))
            self.word_embeddings.weight[self.pad_token_id].zero_()
        fill_norm(self.LayerNorm)


def bert_embeddings(emb: BertEmbeddings, cfg: VanillaBertConfig,
                    input_ids: torch.Tensor, token_type_ids: torch.Tensor, *,
                    deterministic: bool = True,
                    rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """word + token type + position rows, summed and LayerNorm'd in the
    word table's dtype (`:160-188`: bf16 parameters compute in bf16)."""
    dtype = emb.word_embeddings.weight.dtype
    word = emb.word_embeddings.weight[input_ids]
    ttype = emb.token_type_embeddings.weight[token_type_ids]
    pos = emb.position_embeddings.weight[:input_ids.shape[-1]]
    x = (word + ttype + pos).to(dtype)
    x = layer_norm(x, emb.LayerNorm.weight.to(dtype),
                   emb.LayerNorm.bias.to(dtype), cfg.layer_norm_eps)
    return dropout(rng, x, cfg.hidden_dropout_prob, deterministic)


class BertLayer(nn.Module):
    """Post-norm BERT layer (`_bert_layer_body`, `:191-285`); `ident_ln1`
    leaves out `attention.output.LayerNorm` (the first explainer layer)."""

    def __init__(self, hidden: int, inter: int, ident_ln1: bool = False):
        super().__init__()
        self.attention = nn.Module()
        self_attn = nn.Module()
        for name in ("query", "key", "value"):
            self_attn.add_module(name, linear(hidden, hidden))
        self.attention.add_module("self", self_attn)
        self.attention.output = nn.Module()
        self.attention.output.dense = linear(hidden, hidden)
        self.has_ln1 = not ident_ln1
        if self.has_ln1:
            self.attention.output.LayerNorm = norm(hidden)
        self.intermediate = nn.Module()
        self.intermediate.dense = linear(inter, hidden)
        self.output = nn.Module()
        self.output.dense = linear(hidden, inter)
        self.output.LayerNorm = norm(hidden)

    def reset_parameters(self, generator: torch.Generator) -> None:
        sa = self.attention.get_submodule("self")
        for m in (sa.query, sa.key, sa.value, self.attention.output.dense,
                  self.intermediate.dense, self.output.dense):
            fill_linear(m, generator)
        if self.has_ln1:
            fill_norm(self.attention.output.LayerNorm)
        fill_norm(self.output.LayerNorm)

    def forward(self, h: torch.Tensor, mask_bias: Optional[torch.Tensor],
                cfg: VanillaBertConfig, deterministic: bool = True,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """mask_bias <B, 1, 1, T> (`additive_mask_bias`).  The unfused
        math runs tensor-parallel where the layer's weights are sharded
        (`parallel/tp.py`)."""
        heads, eps = cfg.num_attention_heads, cfg.layer_norm_eps
        sa = self.attention.get_submodule("self")
        out_dense = self.attention.output.dense
        ln1 = self.attention.output.LayerNorm if self.has_ln1 else None
        ln2 = self.output.LayerNorm
        dropout_off = deterministic or (
            cfg.attention_probs_dropout_prob == 0.0
            and cfg.hidden_dropout_prob == 0.0)
        if pallas_mode() == "2" and dropout_off and mask_bias is not None \
                and h.dim() == 3 and fused_dims_ok(cfg.hidden_size):
            quant = quant_mode()
            h = attention_block(
                h, mask_bias[:, 0, 0, :],
                (sa.query.weight, sa.query.bias, sa.key.weight, sa.key.bias,
                 sa.value.weight, sa.value.bias, out_dense.weight,
                 out_dense.bias), heads, "add",
                ln=None if ln1 is None else (ln1.weight, ln1.bias, eps),
                ln_position="epilogue", quant=quant)
            return mlp_block(h, self.intermediate.dense.weight,
                             self.intermediate.dense.bias,
                             self.output.dense.weight, self.output.dense.bias,
                             ln=(ln2.weight, ln2.bias, eps),
                             ln_position="epilogue", quant=quant)
        ctx = self_attention(
            h, sa.query.weight, sa.query.bias, sa.key.weight, sa.key.bias,
            sa.value.weight, sa.value.bias, heads, mask_bias, "additive",
            attn_dropout=cfg.attention_probs_dropout_prob, generator=rng,
            deterministic=deterministic)
        attn_out = dropout(rng, dense_row(ctx, out_dense.weight,
                                          out_dense.bias),
                           cfg.hidden_dropout_prob, deterministic) + h
        if ln1 is not None:
            attn_out = layer_norm(attn_out, ln1.weight, ln1.bias, eps)
        inter = gelu(dense_col(attn_out, self.intermediate.dense.weight,
                               self.intermediate.dense.bias))
        out = dropout(rng, dense_row(inter, self.output.dense.weight,
                                     self.output.dense.bias),
                      cfg.hidden_dropout_prob, deterministic)
        return layer_norm(out + attn_out, ln2.weight, ln2.bias, eps)


# ------------------------------------------------------------ sections


class BertBackbone(nn.Module):
    """The `bert.` section (`init_bert_backbone`, `:82-99`): `embeddings.*`
    and `encoder.layers.{i}.*`; the LTT BERT adds its ladders under
    `encoder` beside the layers."""

    def __init__(self, cfg: VanillaBertConfig):
        super().__init__()
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            BertLayer(cfg.hidden_size, cfg.intermediate_size)
            for _ in range(cfg.num_hidden_layers))


def fill_bert_backbone(bert: nn.Module, generator: torch.Generator) -> None:
    """The JAX init's laws: N(0, 1) tables with a zero padding row, ones /
    zeros LayerNorms, every linear U(+-1/sqrt(fan_in))."""
    bert.embeddings.reset_parameters(generator)
    for layer in bert.encoder.layers:
        layer.reset_parameters(generator)


class BertClassifier(nn.Module):
    """The vanilla BERT classifier's (and surrogate's) parameters under the
    JAX names (`init_bert_classifier`, `:102-111`): `bert.*`,
    `bert_pooler.dense.*`, `classifier.*`."""

    def __init__(self, cfg: VanillaBertConfig):
        super().__init__()
        self.bert = BertBackbone(cfg)
        self.bert_pooler = nn.Module()
        self.bert_pooler.dense = linear(cfg.hidden_size, cfg.hidden_size)
        self.classifier = linear(cfg.num_labels, cfg.hidden_size)

    def reset_parameters(self, generator: torch.Generator) -> None:
        fill_bert_backbone(self.bert, generator)
        fill_linear(self.bert_pooler.dense, generator)
        fill_linear(self.classifier, generator)


def explainer_layers(cfg: VanillaBertConfig) -> nn.ModuleList:
    """`explainer_attn.{i}.*`: the explainer's post-norm layers at the trunk
    width, the first without `attention.output.LayerNorm`."""
    return nn.ModuleList(
        BertLayer(cfg.hidden_size, cfg.intermediate_size, ident_ln1=(i == 0))
        for i in range(cfg.explainer_attn_num_layers))


def explainer_mlp_module(d_in: int, d_hidden: int,
                         n_labels: int) -> nn.ModuleDict:
    """Three denses under the keys "0", "2", "4" (`explainer_mlp.*`, and
    the LTT BERT's `s_attn_explainer.*`)."""
    return nn.ModuleDict({"0": linear(d_hidden, d_in),
                          "2": linear(d_hidden, d_hidden),
                          "4": linear(n_labels, d_hidden)})


def fill_explainer_head(layers: nn.ModuleList, head: nn.ModuleDict,
                        generator: torch.Generator) -> None:
    for layer in layers:
        layer.reset_parameters(generator)
    for k in ("0", "2", "4"):
        fill_linear(head[k], generator)


class BertExplainer(nn.Module):
    """The vanilla BERT explainer (`init_bert_explainer`, `:114-133`)."""

    def __init__(self, cfg: VanillaBertConfig):
        super().__init__()
        self.bert = BertBackbone(cfg)
        self.explainer_attn = explainer_layers(cfg)
        self.explainer_mlp = explainer_mlp_module(
            cfg.hidden_size, cfg.explainer_head_hidden_size, cfg.num_labels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        fill_bert_backbone(self.bert, generator)
        fill_explainer_head(self.explainer_attn, self.explainer_mlp,
                            generator)


class BertFinal(nn.Module):
    """The vanilla BERT final (`init_bert_final`, `:136-147`)."""

    def __init__(self, cfg: VanillaBertConfig):
        super().__init__()
        self.classifier = BertClassifier(cfg)
        self.surrogate = BertClassifier(cfg)
        self.explainer = BertExplainer(cfg)
        self.register_buffer("surrogate_null", torch.zeros(1, cfg.num_labels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for tower in (self.classifier, self.surrogate, self.explainer):
            tower.reset_parameters(generator)
        with torch.no_grad():
            self.surrogate_null.zero_()


VANILLA_SECTIONS = {"classifier": BertClassifier,
                    "surrogate": BertClassifier,
                    "explainer": BertExplainer, "final": BertFinal}


def vanilla_bert_model(cfg: VanillaBertConfig,
                       section: str = "final") -> nn.Module:
    """A checkpoint section's module, created empty: fill it with an init
    or a state dict."""
    if section not in VANILLA_SECTIONS:
        raise ValueError(f"unknown vanilla BERT section {section!r}")
    return VANILLA_SECTIONS[section](cfg)


def _flat(model: nn.Module, generator: torch.Generator
          ) -> Dict[str, np.ndarray]:
    model.reset_parameters(generator)
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def init_bert_backbone(cfg: VanillaBertConfig, generator: torch.Generator
                       ) -> Dict[str, np.ndarray]:
    """A fresh `bert.` section as a flat dict of fp32 numpy arrays."""
    bert = BertBackbone(cfg)
    fill_bert_backbone(bert, generator)
    return {f"bert.{k}": v.detach().numpy()
            for k, v in bert.state_dict().items()}


def init_bert_classifier(cfg: VanillaBertConfig, generator: torch.Generator
                         ) -> Dict[str, np.ndarray]:
    """A fresh vanilla BERT classifier as a flat dict of fp32 numpy arrays,
    drawn from `generator` with the JAX package's laws (its keys and
    shapes; not its numbers)."""
    return _flat(BertClassifier(cfg), generator)


def init_bert_explainer(cfg: VanillaBertConfig, generator: torch.Generator
                        ) -> Dict[str, np.ndarray]:
    return _flat(BertExplainer(cfg), generator)


def init_bert_final(cfg: VanillaBertConfig, generator: torch.Generator
                    ) -> Dict[str, np.ndarray]:
    return _flat(BertFinal(cfg), generator)


# --------------------------------------------------------------- apply


def bert_encoder(bert: BertBackbone, cfg: VanillaBertConfig,
                 h: torch.Tensor, mask_bias: Optional[torch.Tensor], *,
                 deterministic: bool = True,
                 rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """The encoder layers in order (`:288-309`), each under
    `maybe_remat`; mask_bias <B, 1, 1, T>."""
    for layer in bert.encoder.layers:
        h = maybe_remat(layer, h, mask_bias, cfg, deterministic, rng,
                        generator=rng)
    return h


def bert_backbone(bert: BertBackbone, cfg: VanillaBertConfig,
                  input_ids: torch.Tensor, attention_mask: torch.Tensor,
                  token_type_ids: torch.Tensor, *,
                  deterministic: bool = True,
                  rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Embeddings, the additive bias of `attention_mask` in their dtype,
    the encoder (`:312-332`)."""
    emb = bert_embeddings(bert.embeddings, cfg, input_ids, token_type_ids,
                          deterministic=deterministic, rng=rng)
    return bert_encoder(bert, cfg, emb, additive_mask_bias(attention_mask,
                                                           emb.dtype),
                        deterministic=deterministic, rng=rng)


def pooled_probs(pooler: nn.Module, classifier: nn.Module, h: torch.Tensor,
                 cfg: VanillaBertConfig, deterministic: bool = True,
                 rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """tanh pooler on the CLS row, dropout, then the classifier's softmax
    (`_cls_head`, `:335-352`)."""
    pooled = torch.tanh(dense(h[:, 0, :], pooler.weight.to(h.dtype),
                              pooler.bias.to(h.dtype)))
    pooled = dropout(rng, pooled, cfg.hidden_dropout_prob, deterministic)
    return torch.softmax(dense(pooled, classifier.weight.to(h.dtype),
                               classifier.bias.to(h.dtype)), dim=-1)


def _cls_head(model: nn.Module, h: torch.Tensor, cfg: VanillaBertConfig, *,
              deterministic: bool = True,
              rng: Optional[torch.Generator] = None) -> torch.Tensor:
    return pooled_probs(model.bert_pooler.dense, model.classifier, h, cfg,
                        deterministic, rng)


def bert_classifier_fwd(model: BertClassifier, cfg: VanillaBertConfig,
                        input_ids: torch.Tensor, attention_mask: torch.Tensor,
                        token_type_ids: torch.Tensor, *,
                        deterministic: bool = True,
                        rng: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, dict]:
    """-> (<B, n_classes> probabilities, {"repr_cls": the encoder's hidden
    states}) (`:355-373`)."""
    h = bert_backbone(model.bert, cfg, input_ids, attention_mask,
                      token_type_ids, deterministic=deterministic, rng=rng)
    probs = _cls_head(model, h, cfg, deterministic=deterministic, rng=rng)
    return probs, {"repr_cls": h}


bert_surrogate_fwd = bert_classifier_fwd


def bert_explainer_mlp(head: nn.ModuleDict, h: torch.Tensor) -> torch.Tensor:
    """d1 -> GELU -> d2 -> GELU -> d3, no LayerNorm: in int8 mode with
    equally wide d1 and d2, where a token tile fits the JAX budget
    (`gates.head_token_tile`), the fused int8 head op (K3), else
    `dense_serving` denses, W8A8 in int8 mode (`:399-414`)."""
    d1, d2, d3 = (head[k] for k in ("0", "2", "4"))
    if quant_mode() == "int8" and h.dim() == 3 \
            and d1.weight.shape[0] == d2.weight.shape[0] \
            and gates.head_token_tile(h.shape[-2], h.shape[-1],
                                      d1.weight.shape[0],
                                      d3.weight.shape[0]) is not None:
        return explainer_head_block(h, d1.weight, d1.bias, d2.weight,
                                    d2.bias, d3.weight, d3.bias, None, None,
                                    1e-5)
    h = gelu(dense_serving(h, d1.weight, d1.bias))
    h = gelu(dense_serving(h, d2.weight, d2.bias))
    return dense(h, d3.weight, d3.bias)


def bert_explainer_head(model: nn.Module, cfg: VanillaBertConfig,
                        h: torch.Tensor, attention_mask: torch.Tensor,
                        grand: torch.Tensor, null: torch.Tensor, *,
                        deterministic: bool = True,
                        rng: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """`model`'s explainer layers and head on the encoder's output h; the
    efficiency normalisation runs over all T tokens including CLS, then
    CLS is dropped -> <B, n_classes, T - 1> (`:379-417`)."""
    bias = additive_mask_bias(attention_mask, h.dtype)
    for layer in model.explainer_attn:
        h = layer(h, bias, cfg, deterministic, rng)
    h = dropout(rng, h, cfg.hidden_dropout_prob, deterministic)
    out = bert_explainer_mlp(model.explainer_mlp, h)
    if cfg.explainer_normalize:
        out = normalize_shapley_explanation(out, grand, null)
    return out[:, 1:, :].transpose(1, 2)


def bert_explainer_fwd(model: BertExplainer, cfg: VanillaBertConfig,
                       input_ids: torch.Tensor, attention_mask: torch.Tensor,
                       token_type_ids: torch.Tensor, grand: torch.Tensor,
                       null: torch.Tensor, *, deterministic: bool = True,
                       rng: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, dict]:
    """-> (attributions <B, n_classes, T - 1>, {"repr_exp": the encoder's
    hidden states}) (`:420-443`)."""
    h = bert_backbone(model.bert, cfg, input_ids, attention_mask,
                      token_type_ids, deterministic=deterministic, rng=rng)
    attr = bert_explainer_head(model, cfg, h, attention_mask, grand, null,
                               deterministic=deterministic, rng=rng)
    return attr, {"repr_exp": h}


def bert_final_fwd(model: BertFinal, cfg: VanillaBertConfig,
                   input_ids: torch.Tensor, attention_mask: torch.Tensor,
                   token_type_ids: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """-> (class probabilities, attributions, the three towers'
    representations) (`:446-480`)."""
    args = (input_ids, attention_mask, token_type_ids)
    probs, obs_c = bert_classifier_fwd(model.classifier, cfg, *args)
    obs = {"repr_cls": obs_c["repr_cls"]}
    if cfg.explainer_normalize:
        grand, obs_s = bert_surrogate_fwd(model.surrogate, cfg, *args)
        obs["repr_srg"] = obs_s["repr_cls"]
    else:
        grand = torch.zeros_like(probs)
    attr, obs_e = bert_explainer_fwd(model.explainer, cfg, *args, grand,
                                     model.surrogate_null)
    obs["repr_exp"] = obs_e["repr_exp"]
    return probs, attr, obs


def bert_surrogate_coalitions_fwd(model: BertClassifier,
                                  cfg: VanillaBertConfig,
                                  input_ids: torch.Tensor,  # <B, T>
                                  masks: torch.Tensor,  # <B, M, T>
                                  token_type_ids: torch.Tensor, *,
                                  deterministic: bool = True
                                  ) -> torch.Tensor:
    """The surrogate over B*M coalitions, the embeddings computed once per
    sentence and broadcast over M; masks carry the CLS column -> <B, M,
    n_classes> (`:486-510`).  A no-grad teacher sweep: eval mode only."""
    if not deterministic:
        raise NotImplementedError(
            "the coalition fast path is a no-grad teacher sweep and runs "
            "eval-mode only")
    b, m, t = masks.shape
    emb = bert_embeddings(model.bert.embeddings, cfg, input_ids,
                          token_type_ids)
    emb = emb[:, None].expand(b, m, t, emb.shape[-1]).reshape(
        b * m, t, emb.shape[-1])
    h = bert_encoder(model.bert, cfg, emb,
                     additive_mask_bias(masks.reshape(b * m, t), emb.dtype))
    return _cls_head(model, h, cfg).reshape(b, m, -1)
