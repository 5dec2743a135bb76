"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Asking for CUDA without a card raises:
    nothing moves to the CPU unless the caller says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev
