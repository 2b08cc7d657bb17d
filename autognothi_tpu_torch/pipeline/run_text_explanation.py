"""Terminal text-explanation demo (port of
`autognothi_tpu/pipeline/run_text_explanation.py`): each test sentence the
final model classifies right, its tokens colored by their attribution to
the label, and all of them saved as JSON.

    python -m autognothi_tpu_torch run_text_explanation <experiment_dir> \\
        --into out.json [--limit N] [--dataset KIND] --device cuda

The final runs on `--device` one sentence at a time; a host final
(KernelSHAP's WLS, `recipe.fw_final_host`) is called as it is.  The JSON
is the JAX package's: `{"items": {"<i>": [[token, attribution], ...]}}`,
indented by 2.  `rich` colors the terminal where it imports.
"""

from __future__ import annotations

import json
import pathlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data.loader import DatasetLoader
from ..utils.devices import resolve_device
from .env import ExpEnv
from .reports import to_json
from .resources import get_recipe, load_cfg_dataset, load_epoch_model, load_misc

try:
    import rich

    _console = rich.get_console()

    def _print(text: str, style: str) -> None:
        _console.print(text, style=style, end="", highlight=False)

except ImportError:

    def _print(text: str, style: str) -> None:
        print(text, end="")


def real_tokenize_text(token_ids: List[int],
                       tokenizer) -> List[Tuple[int, str]]:
    """-> (position, display text) of each token but the specials: a `##`
    continuation glues to the token before it, an alphabetic token gets a
    leading space; the first and last are stripped."""
    special = set(getattr(tokenizer, "all_special_ids", []))
    out: List[Tuple[int, str]] = []
    for i, tk in enumerate(token_ids):
        if tk in special:
            continue
        s = str(tokenizer.decode(tk)).strip()
        if not s:
            s = " "
        if s.startswith("##"):
            s = s[2:]
        elif s[0].isalpha():
            s = " " + s
        out.append((i, s))
    if out:
        out[0] = (out[0][0], out[0][1].lstrip())
        out[-1] = (out[-1][0], out[-1][1].rstrip())
    return out


def _mix_color(cl, cr, r: float):
    return tuple(int(cl[i] * r + cr[i] * (1 - r)) for i in range(3))


def print_label(label: int, pred: int) -> None:
    _print(f"[{label}] ", "bold green" if label == pred else "white")


def print_text_attr(tks_scores: List[Tuple[str, float]]) -> None:
    """Each token in a color from blue (< 0) through grey to red (> 0),
    scaled by the largest |attribution|."""
    attrs = [a for _, a in tks_scores]
    cl_lim = max(abs(min(attrs)), abs(max(attrs))) or 1.0
    cl_begin, cl_mid, cl_end = (18, 132, 255), (224, 224, 224), \
        (237, 127, 127)
    for tk, at in tks_scores:
        if at < -cl_lim:
            color = cl_begin
        elif at < 0:
            color = _mix_color(cl_begin, cl_mid, -at / cl_lim)
        elif at < cl_lim:
            color = _mix_color(cl_mid, cl_end, 1.0 - at / cl_lim)
        else:
            color = cl_end
        _print(tk, f"rgb({color[0]},{color[1]},{color[2]})")


def run_text_explanation(env: ExpEnv, d_loader: Optional[DatasetLoader],
                         into: pathlib.Path, limit: Optional[int],
                         device: str = "cuda") -> None:
    config = env.config
    recipe, m_config = get_recipe(config)
    dev = resolve_device(device)
    if d_loader is None:
        d_loader = load_cfg_dataset(config.dataset)

    _, final = load_epoch_model(env, recipe, "final", dev)
    m_misc = load_misc(env, recipe, m_config)
    gen_input = recipe.gen_input(m_config, m_misc)

    result_buffer: List[List[Tuple[str, float]]] = []
    for i, (_inputs, _targets) in enumerate(d_loader.test(1)):
        if limit is not None and i >= limit:
            break
        xs, zs = gen_input(_inputs, _targets)
        with torch.inference_mode():
            logits, attr = recipe.fw_final(
                m_config, final, torch.from_numpy(xs).to(dev))
        label = int(np.asarray(zs)[0])
        if label != int(np.argmax(logits[0].float().cpu().numpy())):
            continue
        attr = attr.float().cpu().numpy()
        tokens = real_tokenize_text([int(t) for t in xs[0]],
                                    m_misc.tokenizer)
        pairs = [(w, float(attr[0, label, idx])) for idx, w in tokens
                 if idx < attr.shape[2]]
        print(f"# {i}")
        print_label(label, label)
        print_text_attr(pairs)
        print("\n")
        result_buffer.append(pairs)

    env.log(f"saving into: {into}")
    with open(into, "w", encoding="utf-8") as f:
        f.write(json.dumps(to_json({"items": dict(enumerate(result_buffer))}),
                           indent=2) + "\n")
