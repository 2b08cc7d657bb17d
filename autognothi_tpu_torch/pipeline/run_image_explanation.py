"""Image-explanation demo (port of `autognothi_tpu/pipeline/
run_image_explanation.py`): each test image the final model classifies
right, saved as a base64 JPEG beside its per-patch attributions.

    python -m autognothi_tpu_torch run_image_explanation <experiment_dir> \\
        --into out.json [--limit N] [--dataset KIND] --device cuda

Two parts.  `explain_images`, on `--device`, runs the final on each test
image and keeps those whose prediction is the label, with their
attributions <C, P>.  `_to_b64_jpeg`, on the host, resizes the raw image
to the model's size and encodes it with Pillow, which only this part
imports: the verb checks for it before it loads any model and raises an
ImportError naming it where it is missing.  The JSON is the JAX
package's: `{"items": {"<i>": {"img_channels", "img_px_size",
"img_patch_size", "image", "explanation" [label][patch]}}}` on one line.
"""

from __future__ import annotations

import base64
import io
import json
import pathlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data.loader import DatasetLoader, _resize_chw
from ..utils.devices import resolve_device
from .env import ExpEnv
from .reports import to_json
from .resources import get_recipe, load_cfg_dataset, load_epoch_model, load_misc


def _to_b64_jpeg(img_chw: np.ndarray, px: int) -> str:
    import PIL.Image

    img = _resize_chw(np.asarray(img_chw, dtype=np.float32), px, px)
    img = np.clip(img.transpose(1, 2, 0) * 255, 0, 255).astype("uint8")
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode("utf-8")


def require_pillow() -> None:
    try:
        import PIL.Image  # noqa: F401
    except ImportError as err:
        raise ImportError(
            "run_image_explanation writes each image as a JPEG, which needs "
            "Pillow (the `PIL` package); it is not installed") from err


def explain_images(env: ExpEnv, d_loader: Optional[DatasetLoader],
                   limit: Optional[int], device: str = "cuda"
                   ) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """The device part: -> (test index, raw image <C, h, w>, attributions
    <C, P> fp32) of each of the first `limit` test images whose predicted
    class is its label."""
    config = env.config
    recipe, m_config = get_recipe(config)
    dev = resolve_device(device)
    if d_loader is None:
        d_loader = load_cfg_dataset(config.dataset)

    _, final = load_epoch_model(env, recipe, "final", dev)
    gen_input = recipe.gen_input(m_config, load_misc(env, recipe, m_config))
    n_patches = (m_config.img_px_size // m_config.img_patch_size) ** 2

    kept = []
    for i, (_inputs, _targets, _inputs_raw, _targets_raw) in enumerate(
            d_loader.test_raw(1)):
        if limit is not None and i >= limit:
            break
        xs, zs = gen_input(_inputs, _targets)
        with torch.inference_mode():
            logits, attr = recipe.fw_final(m_config, final,
                                           torch.from_numpy(xs).to(dev))
        label = int(np.asarray(zs)[0])
        if label != int(np.argmax(logits[0].float().cpu().numpy())):
            continue
        attr = attr.float().cpu().numpy()
        if attr.shape != (1, m_config.num_labels, n_patches):
            raise ValueError(f"attributions {attr.shape}, expected "
                             f"{(1, m_config.num_labels, n_patches)}")
        kept.append((i, np.asarray(_inputs_raw[0]), attr[0]))
        print(f"    visualized #{i}...")
    return kept


def run_image_explanation(env: ExpEnv, d_loader: Optional[DatasetLoader],
                          into: pathlib.Path, limit: Optional[int],
                          device: str = "cuda") -> None:
    require_pillow()
    m_config = get_recipe(env.config)[1]
    px = m_config.img_px_size
    items = [{"img_channels": m_config.img_channels, "img_px_size": px,
              "img_patch_size": m_config.img_patch_size,
              "image": _to_b64_jpeg(raw, px), "explanation": attr.tolist()}
             for _, raw, attr in explain_images(env, d_loader, limit,
                                                device)]
    env.log(f"saving into: {into}")
    with open(into, "w", encoding="utf-8") as f:
        f.write(json.dumps(to_json({"items": dict(enumerate(items))}),
                           indent=None) + "\n")
