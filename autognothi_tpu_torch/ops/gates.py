"""The JAX package's on-chip memory gates that choose arithmetic.

The JAX ops size their Pallas kernels against a 15 MiB on-chip budget
(`autognothi_tpu/ops/attention_block.py:_VMEM_BUDGET_BYTES`).  Where a
shape does not fit, the JAX op does not merely schedule differently: it
computes another function.  The int8 attention block falls back to the
unquantized block; the MLP block splits its intermediate dimension into
2, 4 or 8 chained tiles, each int8 tile re-quantizing its own slice; the
BERT encoder takes per-branch side layers instead of the ladder op; the
BERT explainer head takes the eager W8A8 denses instead of the fused int8
head.  So the port keeps the same predicates, on the same shapes and
dtypes (never the device), and each op consults its own, as the JAX op
does.  `VMEM_BUDGET_BYTES` is read at each call, so a test can lower it.

At BERT-base T = 512 (hidden 768, MLP 3072, 96-wide ladders, 12 heads):
fp32 + int8 attention does not fit (float attention), bf16 + int8 does;
the int8 MLP takes 2 tiles in fp32 and bf16, the float fp32 MLP 4; the
ladder op and the int8 head fit.  At ViT-B T = 197 everything fits but
the float fp32 MLP (2 tiles).  At ViT-B@384 (T = 577) and ViT-L (T =
197) the ladder op fits but the fused int8 trunk-MLP + ladder step (K2)
does not (`mlp_ladder_fits`): the LTT ViT then runs the int8 trunk MLP as
its own op, split into int8 tiles where its gate says so.
"""

from __future__ import annotations

from typing import Optional

import torch

VMEM_BUDGET_BYTES = 15 * 1024 * 1024
MLP_TILE_COUNTS = (2, 4, 8)


def attention_block_fits(t: int, h: int, dtype: torch.dtype,
                         quant: str = "none", group: int = 1) -> bool:
    """`attention_block.py:_fits_vmem`: False sends the block, int8 or not,
    to the unquantized math."""
    itemsize = dtype.itemsize
    w_item = 1 if quant == "int8" else itemsize
    weights = 4 * h * h * w_item
    acts = 2 * group * t * h * itemsize + 4 * t * h * itemsize + t * t * 4
    if quant == "int8":
        acts += 2 * t * h * 4 + 2 * t * h + t * h * 4
    return weights + acts < VMEM_BUDGET_BYTES


def _mlp_fits(t: int, h: int, inter: int, dtype: torch.dtype, quant: str,
              group: int = 1) -> bool:
    """`mlp_block.py:_fits_vmem` for an intermediate width `inter`."""
    itemsize = dtype.itemsize
    w_item = 1 if quant == "int8" else itemsize
    weights = 2 * h * inter * w_item
    acts = (2 * group * t * h * itemsize + t * inter * (4 + itemsize)
            + t * h * itemsize)
    if quant == "int8":
        acts += t * inter
    return weights + acts < VMEM_BUDGET_BYTES


def mlp_block_tiles(t: int, h: int, inter: int, dtype: torch.dtype,
                    quant: str = "none", group: int = 1) -> Optional[int]:
    """The intermediate-dim split of `mlp_block.py:mlp_block` (`:429-438`):
    1 (one block), 2, 4 or 8 chained tiles, or None where no split fits
    (the JAX op then computes the unquantized block)."""
    if _mlp_fits(t, h, inter, dtype, quant, group):
        return 1
    for n in MLP_TILE_COUNTS:
        if inter % n == 0 and _mlp_fits(t, h, inter // n, dtype, quant):
            return n
    return None


def _score_stack_ok(t: int, n_heads: int) -> bool:
    """`ladder_block.py:_score_stack_ok`: the cap on the stacked <n_heads *
    T, T> fp32 scores."""
    return n_heads * t * t * 4 <= 16 * 1024 * 1024


def _ladder_weight_bytes(hidden: int, s_hidden: int, n_branches: int) -> int:
    return n_branches * 2 * (hidden * s_hidden + 4 * s_hidden * s_hidden
                             + 2 * s_hidden * 4 * s_hidden)


def ladder_block_fits(hidden: int, t: int, s_hidden: int, n_heads: int,
                      n_branches: int) -> bool:
    """`ladder_block.py:ladder_fits_vmem`: False sends the encoders' ladder
    step to per-branch side layers."""
    acts = t * hidden * (2 + 4) + n_branches * 4 * t * s_hidden * 4
    return (_ladder_weight_bytes(hidden, s_hidden, n_branches) + acts
            < VMEM_BUDGET_BYTES and _score_stack_ok(t, n_heads))


def mlp_ladder_fits(hidden: int, inter: int, t: int, s_hidden: int,
                    n_branches: int, n_heads: int = 12) -> bool:
    """`ladder_block.py:mlp_ladder_fits_vmem`: False keeps the LTT ViT's int8
    trunk MLP out of the fused trunk-MLP + ladder step (K2); the trunk MLP
    then runs as the int8 MLP op (whose own split may apply) and the
    ladder as its own op."""
    weights = 2 * hidden * inter + _ladder_weight_bytes(hidden, s_hidden,
                                                        n_branches)
    acts = (t * inter * (4 + 4 + 1) + 4 * t * hidden * 2 + t * hidden * 4
            + n_branches * 4 * t * s_hidden * 4 + t * t * 4)
    return weights + acts < VMEM_BUDGET_BYTES and _score_stack_ok(t, n_heads)


def _head_chunks(inter: int) -> int:
    return 4 if inter % (4 * 128) == 0 else 1


def head_token_tile(t: int, h_in: int, inter: int, c: int) -> Optional[int]:
    """`head_block.py:_pick_tile`: the fused int8 head's token tile, or None
    (the head then runs as eager W8A8 denses)."""
    c_pad = max(c, 128)
    weights = h_in * inter + inter * inter + inter * c_pad * 2
    chunk = inter // _head_chunks(inter)
    for tile in (256, 128, 64, 32):
        acts = (tile * h_in * (4 + 2) + tile * inter * (4 + 1)
                + tile * chunk * (4 + 4 + 2) + tile * c_pad * (4 + 4))
        if weights + acts < VMEM_BUDGET_BYTES and tile <= max(t, 32):
            return tile
    return None
