"""Feature-heatmap visualisation.

Counterpart of ``mmidet_tpu/utils/gradcam.py``; reference
``utils/gradcam.py:44-79`` (``calcGradCam``: the channel sum of an
intermediate feature map, min-max normalised, resized and overlaid on the
input).  The JAX package reads the map from flax's
``capture_intermediates``; the port reads it by a forward hook on the
module of the same name.  The names are the JAX package's: ``enhance``
(the CEM) and ``l{index}_{row}`` for every row with a module (a repeated
row's copies ``..._r{r}``); the rows the forward computes inline (Concat,
Add, Add2, the upsamplings, the pools and pads) have none, as flax
captures nothing for them.  ``layer`` takes the first name in sorted order
that starts with it, as the JAX package's lookup does: on a model with
ten rows or more, ``"l1"`` takes ``l10_...`` before ``l1_...``.
"""

from __future__ import annotations

import numpy as np
import torch


def capture_names(model) -> dict[str, torch.nn.Module]:
    """{JAX intermediate name: the port module whose output it is}."""
    from mmidet_tpu_torch.models.detector import _PARAMETER_FREE, _ROWS
    names = {}
    if model.use_cem:
        names["enhance"] = model.Enhance
    for rl, mod in zip(model.resolved, model.model):
        if rl.name in _PARAMETER_FREE:
            continue
        base = f"l{rl.index}_{rl.name.replace('.', '_')}"
        if rl.name in _ROWS and rl.n > 1:  # nn.Sequential of the copies
            names[base] = mod[0]
            names.update({f"{base}_r{r}": mod[r] for r in range(1, rl.n)})
        else:
            names[base] = mod
    return names


def feature_heatmap(model, rgb: torch.Tensor, ir: torch.Tensor | None = None,
                    layer: str = "l6") -> np.ndarray:
    """Channel-summed, min-max normalised heatmap (H, W) of the first
    image's map at the first module whose name starts with ``layer``
    (a fusion row's first output).  ``rgb``/``ir``: NHWC in [0, 1]."""
    names = capture_names(model)
    key = next(k for k in sorted(names) if k.startswith(layer))
    got = []
    hook = names[key].register_forward_hook(
        lambda mod, inp, out: got.append(out))
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(rgb) if ir is None else model(rgb, ir)
    finally:
        hook.remove()
        model.train(was)
    feat = got[0]
    if isinstance(feat, (list, tuple)):
        feat = feat[0]
    hm = feat[0].float().sum(0).cpu().numpy()  # NCHW -> HW
    return (hm - hm.min()) / max(hm.max() - hm.min(), 1e-12)


def overlay_heatmap(image: np.ndarray, heatmap: np.ndarray,
                    alpha: float = 0.5) -> np.ndarray:
    """Resize the heatmap to the image and blend it as a red overlay
    (uint8)."""
    from PIL import Image
    h, w = image.shape[:2]
    hm = np.asarray(Image.fromarray(
        (heatmap * 255).astype(np.uint8)).resize((w, h)))
    overlay = image.astype(np.float32).copy()
    overlay[..., 0] = np.clip(
        overlay[..., 0] * (1 - alpha) + hm * alpha * 2, 0, 255)
    return overlay.astype(np.uint8)
