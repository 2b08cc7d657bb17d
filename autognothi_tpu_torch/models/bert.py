"""BERT building blocks (port of the parts of `autognothi_tpu/models/bert.py`
that the LTT BERT runs: the config, the embeddings, the post-norm layer,
and the backbone and classifier sections with their inits, `bert.*`,
`bert_pooler.dense.*` and `classifier.*`, `:64-118`).

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
from typing import Dict, Optional

import numpy as np

import torch
from torch import nn

from ..ops.attention_block import attention_block
from ..ops.mlp_block import mlp_block
from .common import (dense, dropout, fused_dims_ok, gelu, init_embedding,
                     layer_norm, pallas_mode, quant_mode, self_attention)
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
        """mask_bias <B, 1, 1, T> (`additive_mask_bias`)."""
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
        attn_out = dropout(rng, dense(ctx, out_dense.weight, out_dense.bias),
                           cfg.hidden_dropout_prob, deterministic) + h
        if ln1 is not None:
            attn_out = layer_norm(attn_out, ln1.weight, ln1.bias, eps)
        inter = gelu(dense(attn_out, self.intermediate.dense.weight,
                           self.intermediate.dense.bias))
        out = dropout(rng, dense(inter, self.output.dense.weight,
                                 self.output.dense.bias),
                      cfg.hidden_dropout_prob, deterministic)
        return layer_norm(out + attn_out, ln2.weight, ln2.bias, eps)


# ------------------------------------------------------------ sections


def bert_backbone(cfg: VanillaBertConfig) -> nn.Module:
    """The `bert.` section: `embeddings.*` and `encoder.layers.{i}.*`
    (`init_bert_backbone`, `:82-99`); a model adds its own parts under
    `encoder` beside the layers."""
    bert = nn.Module()
    bert.embeddings = BertEmbeddings(cfg)
    bert.encoder = nn.Module()
    bert.encoder.layers = nn.ModuleList(
        BertLayer(cfg.hidden_size, cfg.intermediate_size)
        for _ in range(cfg.num_hidden_layers))
    return bert


def fill_bert_backbone(bert: nn.Module, generator: torch.Generator) -> None:
    """The JAX init's laws: N(0, 1) tables with a zero padding row, ones /
    zeros LayerNorms, every linear U(+-1/sqrt(fan_in))."""
    bert.embeddings.reset_parameters(generator)
    for layer in bert.encoder.layers:
        layer.reset_parameters(generator)


class BertClassifier(nn.Module):
    """The vanilla BERT classifier's parameters under the JAX names
    (`init_bert_classifier`, `:102-111`): `bert.*`, `bert_pooler.dense.*`,
    `classifier.*`."""

    def __init__(self, cfg: VanillaBertConfig):
        super().__init__()
        self.bert = bert_backbone(cfg)
        self.bert_pooler = nn.Module()
        self.bert_pooler.dense = linear(cfg.hidden_size, cfg.hidden_size)
        self.classifier = linear(cfg.num_labels, cfg.hidden_size)


def init_bert_classifier(cfg: VanillaBertConfig, generator: torch.Generator
                         ) -> Dict[str, np.ndarray]:
    """A fresh vanilla BERT classifier as a flat dict of fp32 numpy arrays,
    drawn from `generator` with the JAX package's laws (its keys and
    shapes; not its numbers)."""
    model = BertClassifier(cfg)
    fill_bert_backbone(model.bert, generator)
    fill_linear(model.bert_pooler.dense, generator)
    fill_linear(model.classifier, generator)
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}
