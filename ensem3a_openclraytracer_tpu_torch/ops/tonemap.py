"""Output-stage post-processing.

Counterpart of the JAX package's ``ops/tonemap.py``.  The reference clamps
to [0, 1] in the kernel (Raytracing.cl:216-219) and ships a bypassed
'gamma' kernel that raises to the power 2.2, darkening rather than
encoding (ImgProcessing.cl:1-9, main.py:97).  Here: plain clamp, the
display encode, and the reference's curve.
"""

from __future__ import annotations

import torch


def clamp01(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(img, 0.0, 1.0)


def gamma_encode(img: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Display encode: clamp, then ``pow(1 / gamma)``."""
    return torch.pow(clamp01(img), 1.0 / gamma)


def reference_imgprocess(img: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """The reference's bypassed ImgProcessing kernel: clamp, then
    ``pow(gamma)`` (darkens)."""
    return torch.pow(clamp01(img), gamma)


def postprocess(img: torch.Tensor, mode: str = "clamp") -> torch.Tensor:
    """``mode``: 'clamp' (the reference's output), 'gamma' (display
    encode) or 'reference_gamma' (the pow-2.2 curve)."""
    if mode == "clamp":
        return clamp01(img)
    if mode == "gamma":
        return gamma_encode(img)
    if mode == "reference_gamma":
        return reference_imgprocess(img)
    raise ValueError(f"unknown postprocess mode: {mode!r}")
