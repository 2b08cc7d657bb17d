"""LTT BERT (port of `autognothi_tpu/models/ltt_bert.py`): one frozen BERT
trunk with 96-wide post-norm side ladders beside it.  After trunk layer i,
branch b updates side_b <- SideLayer_{b,i}(side_b + gelu(Map_{b,i}(h_i))).
The surrogate carries branch 0, its side pooler and classifier; the
explainer carries branch 0, the explainer side layers and the explainer
MLP head; the final carries both ladders (branch 0 the surrogate, branch
1 the explainer) and gives class probabilities and per-token attributions
in one forward pass.

Per trunk layer the encoder takes one of two ladder branches, as the JAX
scan body does (`:236-284`): in pallas mode "2" with no active dropout,
where the side width is at the fused floor (`fused_dims_ok`) and the
ladder op fits the JAX budget (`gates.ladder_block_fits`, on
`max_position_embeddings`), the ladder op for every branch ("add" mask,
post-norm: K5); otherwise both branch maps as one dense and each branch's
side layer (`BertLayer`, whose own ops are fused and int8 as the mode
says).  The trunk layer is `BertLayer` either way.  With dropout active
(a training forward with a non-zero rate) every layer takes the unfused
math, which draws its dropout masks from the caller's generator.

The sections' forwards (`ltt_bert_{surrogate,explainer,final}_fwd`), the
embed-once coalition forward of the surrogate and the freeze rules
(`ltt_bert_trainable`, `ltt_bert_progressive`) follow the JAX functions
of the same names.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import gates
from ..ops.ladder_block import ladder_block
from ..ops.shapley import normalize_shapley_explanation
from .bert import (BertBackbone, BertLayer, VanillaBertConfig,
                   bert_embeddings, bert_explainer_mlp, explainer_mlp_module,
                   fill_bert_backbone, pooled_probs)
from .common import (additive_mask_bias, dense, dropout, fused_dims_ok, gelu,
                     maybe_remat, pallas_mode)
from .vit import fill_linear, linear

BRANCHES = (0, 1)
# what each checkpoint section holds (`init_ltt_bert_{surrogate,explainer,
# final}`): its ladder branches, the surrogate's side pooler + classifier,
# the explainer side layers + head (the classifier has the surrogate's
# layout, as `init_classifier` is `init_ltt_bert_surrogate` in the JAX
# recipe)
SECTIONS = {
    "classifier": dict(branches=(0,), srg_head=True, explainer=False),
    "surrogate": dict(branches=(0,), srg_head=True, explainer=False),
    "explainer": dict(branches=(0,), srg_head=False, explainer=True),
    "final": dict(branches=BRANCHES, srg_head=True, explainer=True),
}


@dataclasses.dataclass(frozen=True)
class LttBertConfig:
    attention_probs_dropout_prob: float
    explainer_s_attn_num_layers: int
    explainer_s_head_hidden_size: int
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
    s_attn_hidden_size: int
    s_attn_intermediate_size: int
    type_vocab_size: int
    vocab_size: int

    def into(self) -> VanillaBertConfig:
        return VanillaBertConfig(
            attention_probs_dropout_prob=self.attention_probs_dropout_prob,
            explainer_attn_num_layers=self.explainer_s_attn_num_layers,
            explainer_head_hidden_size=self.explainer_s_head_hidden_size,
            explainer_normalize=self.explainer_normalize,
            hidden_dropout_prob=self.hidden_dropout_prob,
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            layer_norm_eps=self.layer_norm_eps,
            max_position_embeddings=self.max_position_embeddings,
            num_attention_heads=self.num_attention_heads,
            num_hidden_layers=self.num_hidden_layers,
            num_labels=self.num_labels,
            pad_token_id=self.pad_token_id,
            type_vocab_size=self.type_vocab_size,
            vocab_size=self.vocab_size,
        )

    def side(self) -> VanillaBertConfig:
        """A VanillaBertConfig at the side-ladder width."""
        return dataclasses.replace(
            self.into(), hidden_size=self.s_attn_hidden_size,
            intermediate_size=self.s_attn_intermediate_size)


class LttBert(nn.Module):
    """Parameters of one checkpoint section, "classifier", "surrogate",
    "explainer" or "final", under the JAX package's names.  Created empty:
    fill with `reset_parameters` or a state dict."""

    def __init__(self, cfg: LttBertConfig, section: str = "final"):
        super().__init__()
        if section not in SECTIONS:
            raise ValueError(f"unknown LTT BERT section {section!r}")
        self.cfg, self.section = cfg, section
        parts = SECTIONS[section]
        self.branches = parts["branches"]
        h, s = cfg.hidden_size, cfg.s_attn_hidden_size
        n_layers = cfg.num_hidden_layers
        self.bert = BertBackbone(cfg.into())
        self.bert.encoder.s_attn_maps = nn.ModuleDict(
            {f"{b}_{i}": linear(s, h) for b in self.branches
             for i in range(n_layers)})
        self.bert.encoder.s_attn_layers = nn.ModuleDict(
            {f"{b}_{i}": BertLayer(s, cfg.s_attn_intermediate_size)
             for b in self.branches for i in range(n_layers)})
        self.bert_pooler = nn.Module()
        self.bert_pooler.dense = linear(h, h)
        self.classifier = linear(cfg.num_labels, h)
        if parts["srg_head"]:
            self.bert_s_attn_pooler = nn.Module()
            self.bert_s_attn_pooler.dense = linear(s, s)
            self.s_attn_classifier = linear(cfg.num_labels, s)
        if parts["explainer"]:
            self.s_attn_attention_layers = nn.ModuleList(
                BertLayer(s, cfg.s_attn_intermediate_size,
                          ident_ln1=(i == 0))
                for i in range(cfg.explainer_s_attn_num_layers))
            self.s_attn_explainer = explainer_mlp_module(
                s, cfg.explainer_s_head_hidden_size, cfg.num_labels)
        if section == "final":
            self.register_buffer("surrogate_null",
                                 torch.empty(1, cfg.num_labels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Fresh values on the CPU from `generator`, with the JAX package's
        distributions (`init_ltt_bert_*`: its keys and shapes, not its
        numbers); surrogate_null is zero."""
        fill_bert_backbone(self.bert, generator)
        for i in range(self.cfg.num_hidden_layers):
            for b in self.branches:
                fill_linear(self.bert.encoder.s_attn_maps[f"{b}_{i}"],
                            generator)
                self.bert.encoder.s_attn_layers[f"{b}_{i}"].reset_parameters(
                    generator)
        fill_linear(self.bert_pooler.dense, generator)
        fill_linear(self.classifier, generator)
        if SECTIONS[self.section]["srg_head"]:
            fill_linear(self.bert_s_attn_pooler.dense, generator)
            fill_linear(self.s_attn_classifier, generator)
        if SECTIONS[self.section]["explainer"]:
            for layer in self.s_attn_attention_layers:
                layer.reset_parameters(generator)
            for m in self.s_attn_explainer.values():
                fill_linear(m, generator)
        if self.section == "final":
            with torch.no_grad():
                self.surrogate_null.zero_()


def init_ltt_bert(cfg: LttBertConfig, section: str,
                  generator: torch.Generator) -> LttBert:
    """A fresh section on the CPU, drawn from `generator` with the JAX
    package's distributions (`init_ltt_bert_*`, `:113-167`)."""
    model = LttBert(cfg, section)
    model.reset_parameters(generator)
    return model


# --------------------------------------------------------------- apply


def _ladder_weights(model: LttBert, branch: int,
                    layer: int) -> Dict[str, torch.Tensor]:
    """The dict `ladder_block` takes, for one branch at one trunk layer
    (post-norm: ln1 is the attention-output LN, ln2 the output LN)."""
    m = model.bert.encoder.s_attn_maps[f"{branch}_{layer}"]
    s = model.bert.encoder.s_attn_layers[f"{branch}_{layer}"]
    sa = s.attention.get_submodule("self")
    return {
        "map_w": m.weight, "map_b": m.bias,
        "ln1_w": s.attention.output.LayerNorm.weight,
        "ln1_b": s.attention.output.LayerNorm.bias,
        "wq": sa.query.weight, "bq": sa.query.bias,
        "wk": sa.key.weight, "bk": sa.key.bias,
        "wv": sa.value.weight, "bv": sa.value.bias,
        "wo": s.attention.output.dense.weight,
        "bo": s.attention.output.dense.bias,
        "ln2_w": s.output.LayerNorm.weight, "ln2_b": s.output.LayerNorm.bias,
        "w1": s.intermediate.dense.weight, "b1": s.intermediate.dense.bias,
        "w2": s.output.dense.weight, "b2": s.output.dense.bias,
    }


def ltt_bert_encoder(model: LttBert, cfg: LttBertConfig, emb: torch.Tensor,
                     mask_bias: torch.Tensor, branches: Sequence[int], *,
                     ltt_active_layers: Optional[int] = None,
                     deterministic: bool = True,
                     rng: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The trunk layers with every branch's ladder step after each
    (`:172-291`) -> (hidden, [side_b for b in branches]).  A branch's
    update at layer i is kept only where i < ltt_active_layers (default:
    every layer)."""
    enc = model.bert.encoder
    trunk_cfg, side_cfg = cfg.into(), cfg.side()
    b_sz, t = emb.shape[:2]
    s_hidden, heads = cfg.s_attn_hidden_size, cfg.num_attention_heads
    sides = [emb.new_zeros((b_sz, t, s_hidden)) for _ in branches]
    n_layers = cfg.num_hidden_layers
    active = n_layers if ltt_active_layers is None else int(ltt_active_layers)
    dropout_off = deterministic or (cfg.attention_probs_dropout_prob == 0.0
                                    and cfg.hidden_dropout_prob == 0.0)
    use_ladder_kernel = (
        pallas_mode() == "2" and dropout_off and len(branches) > 0
        and fused_dims_ok(s_hidden)
        and gates.ladder_block_fits(cfg.hidden_size,
                                    cfg.max_position_embeddings, s_hidden,
                                    heads, len(branches)))

    def body(i, layer, h, *sides):
        # the trunk layer and every branch's ladder update: one JAX scan
        # body, one `maybe_remat`
        h = layer(h, mask_bias, trunk_cfg, deterministic, rng)
        ladders = [_ladder_weights(model, b, i) for b in branches]
        if use_ladder_kernel:
            upds = list(ladder_block(h, sides, mask_bias[:, 0, 0, :], ladders,
                                     heads, "add", False,
                                     cfg.layer_norm_eps))
        else:
            # both branch maps as one dense, h read once (`:262-269`)
            joint = gelu(dense(h, torch.cat([w["map_w"] for w in ladders]),
                               torch.cat([w["map_b"] for w in ladders])))
            upds = [
                enc.s_attn_layers[f"{b}_{i}"](
                    side + joint[..., slot * s_hidden:(slot + 1) * s_hidden],
                    mask_bias, side_cfg, deterministic, rng)
                for slot, (b, side) in enumerate(zip(branches, sides))]
        return (h, *(upd if i < active else side
                     for upd, side in zip(upds, sides)))

    h = emb
    for i, layer in enumerate(enc.layers):
        h, *sides = maybe_remat(body, i, layer, h, *sides, generator=rng)
    return h, sides


def ltt_bert_backbone(model: LttBert, cfg: LttBertConfig,
                      input_ids: torch.Tensor, attention_mask: torch.Tensor,
                      token_type_ids: torch.Tensor, branches: Sequence[int],
                      **kw) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Embeddings, the additive bias of `attention_mask` in their dtype,
    the encoder (`:294-318`)."""
    emb = bert_embeddings(model.bert.embeddings, cfg.into(), input_ids,
                          token_type_ids,
                          deterministic=kw.get("deterministic", True),
                          rng=kw.get("rng"))
    bias = additive_mask_bias(attention_mask, emb.dtype)
    return ltt_bert_encoder(model, cfg, emb, bias, branches, **kw)


def _main_head(model: LttBert, h, cfg, deterministic=True, rng=None):
    return pooled_probs(model.bert_pooler.dense, model.classifier, h, cfg,
                        deterministic, rng)


def _side_cls_head(model: LttBert, side, cfg, deterministic=True, rng=None):
    return pooled_probs(model.bert_s_attn_pooler.dense,
                        model.s_attn_classifier, side, cfg, deterministic,
                        rng)


def ltt_bert_explainer_head(model: LttBert, cfg: LttBertConfig,
                            side: torch.Tensor, attention_mask: torch.Tensor,
                            grand: torch.Tensor, null: torch.Tensor, *,
                            deterministic: bool = True,
                            rng: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """Explainer side layers, then the MLP head without LN: in int8 mode
    with equally wide d1 and d2, where a token tile fits the JAX budget
    (`gates.head_token_tile`), the fused int8 head op (K3), else
    `dense_serving` denses; the efficiency normalisation runs over all T
    tokens including CLS, then CLS is dropped -> <B, C, T - 1>
    (`:369-418`)."""
    side_cfg = cfg.side()
    bias = additive_mask_bias(attention_mask, side.dtype)
    for layer in model.s_attn_attention_layers:
        side = layer(side, bias, side_cfg, deterministic, rng)
    side = dropout(rng, side, cfg.hidden_dropout_prob, deterministic)
    out = bert_explainer_mlp(model.s_attn_explainer, side)
    if cfg.explainer_normalize:
        out = normalize_shapley_explanation(out, grand, null)
    return out[:, 1:, :].transpose(1, 2)


def ltt_bert_surrogate_fwd(model: LttBert, cfg: LttBertConfig,
                           input_ids: torch.Tensor,
                           attention_mask: torch.Tensor,
                           token_type_ids: torch.Tensor, **kw
                           ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """-> (side branch-0 probabilities, trunk probabilities, the
    representations {"repr_cls": trunk h, "repr_srg": branch 0's side})
    (`:349-366`).  kw: ltt_active_layers, deterministic, rng."""
    deterministic, rng = kw.get("deterministic", True), kw.get("rng")
    h, (side,) = ltt_bert_backbone(model, cfg, input_ids, attention_mask,
                                   token_type_ids, (0,), **kw)
    logits = _main_head(model, h, cfg, deterministic, rng)
    srg = _side_cls_head(model, side, cfg, deterministic, rng)
    return srg, logits, {"repr_cls": h, "repr_srg": side}


def ltt_bert_explainer_fwd(model: LttBert, cfg: LttBertConfig,
                           input_ids: torch.Tensor,
                           attention_mask: torch.Tensor,
                           token_type_ids: torch.Tensor,
                           grand: torch.Tensor, null: torch.Tensor, **kw
                           ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """-> (attributions <B, C, T - 1>, trunk probabilities, the
    representations {"repr_cls": trunk h, "repr_exp": branch 0's side})
    (`:421-443`)."""
    deterministic, rng = kw.get("deterministic", True), kw.get("rng")
    h, (side,) = ltt_bert_backbone(model, cfg, input_ids, attention_mask,
                                   token_type_ids, (0,), **kw)
    logits = _main_head(model, h, cfg, deterministic, rng)
    attr = ltt_bert_explainer_head(model, cfg, side, attention_mask, grand,
                                   null, deterministic=deterministic, rng=rng)
    return attr, logits, {"repr_cls": h, "repr_exp": side}


def ltt_bert_final_fwd(model: LttBert, cfg: LttBertConfig,
                       input_ids: torch.Tensor, attention_mask: torch.Tensor,
                       token_type_ids: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One trunk traversal feeding both ladders -> (class probabilities
    <B, C>, attributions <B, C, T - 1>) (`:446-476`)."""
    if cfg.explainer_normalize:
        h, (srg_side, exp_side) = ltt_bert_backbone(
            model, cfg, input_ids, attention_mask, token_type_ids, (0, 1))
        grand = _side_cls_head(model, srg_side, cfg)
    else:
        h, (exp_side,) = ltt_bert_backbone(
            model, cfg, input_ids, attention_mask, token_type_ids, (1,))
        grand = h.new_zeros((input_ids.shape[0], cfg.num_labels))
    logits = _main_head(model, h, cfg)
    attr = ltt_bert_explainer_head(model, cfg, exp_side, attention_mask,
                                   grand, model.surrogate_null)
    return logits, attr


def ltt_bert_surrogate_coalitions_fwd(model: LttBert, cfg: LttBertConfig,
                                      input_ids: torch.Tensor,  # <B, T>
                                      masks: torch.Tensor,  # <B, M, T>
                                      token_type_ids: torch.Tensor, *,
                                      deterministic: bool = True
                                      ) -> torch.Tensor:
    """The surrogate (branch 0) over B*M coalitions, the embeddings
    computed once per sentence and broadcast over M; masks carry the CLS
    column -> <B, M, n_classes> side probabilities (`:482-512`).  A no-grad
    teacher sweep: eval mode only, as in the JAX package."""
    if not deterministic:
        raise NotImplementedError(
            "the coalition fast path is a no-grad teacher sweep and runs "
            "eval-mode only")
    b, m, t = masks.shape
    emb = bert_embeddings(model.bert.embeddings, cfg.into(), input_ids,
                          token_type_ids)
    emb = emb[:, None].expand(b, m, t, emb.shape[-1]).reshape(
        b * m, t, emb.shape[-1])
    bias = additive_mask_bias(masks.reshape(b * m, t), emb.dtype)
    _, (side,) = ltt_bert_encoder(model, cfg, emb, bias, (0,))
    return _side_cls_head(model, side, cfg).reshape(b, m, -1)


# --------------------------------------------------------- freeze rules


def ltt_bert_trainable(cfg: LttBertConfig,
                       section: str) -> Callable[[str], bool]:
    """The frozen trunk: embeddings, trunk layers, its pooler and
    classifier receive no updates (`:515-525`)."""
    frozen_prefixes = ("bert.embeddings.", "bert.encoder.layers.",
                       "bert_pooler.", "classifier.")

    def trainable(name: str) -> bool:
        return not name.startswith(frozen_prefixes)

    return trainable


def ltt_bert_progressive(cfg: LttBertConfig, section: str,
                         unfrozen: int) -> Callable[[str], bool]:
    """Progressive training: ladder maps and side layers train only below
    layer `unfrozen` (`:528-541`)."""
    def keep(name: str) -> bool:
        for marker in ("s_attn_maps.", "s_attn_layers."):
            if marker in name:
                tail = name.split(marker, 1)[1]
                return int(tail.split(".")[0].split("_")[1]) < unfrozen
        return True

    return keep
