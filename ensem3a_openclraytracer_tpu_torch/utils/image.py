"""Image IO: float ``[H, W, 3]`` in [0, 1] <-> PNG (FileManager.py:334-338)."""

from __future__ import annotations

import numpy as np
import torch


def save_png(img, path: str) -> None:
    """Save an image (tensor or array, image first, path second)."""
    from PIL import Image

    arr = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    data = (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)
    if not path.endswith(".png"):
        path = path + ".png"
    Image.fromarray(data, "RGB").save(path)


def load_png(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float32) / 255.0
