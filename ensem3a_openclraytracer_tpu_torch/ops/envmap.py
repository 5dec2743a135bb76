"""Lat-long environment lighting and the directional sun.

Counterpart of the JAX package's ``ops/envmap.py`` (the reference's
MathLib.cl:72-90 IBL lookup and Raytracing.cl:115-136 sun).  The lookup
gathers texels with ``ops/gathers.gather_rows``, so gradients flow into
them with a deterministic backward pass.
"""

from __future__ import annotations

import torch

from ensem3a_openclraytracer_tpu_torch.ops.gathers import gather_rows
from ensem3a_openclraytracer_tpu_torch.ops.geometry import (
    normalize,
    rotate_euler_xyz_deg,
)
from ensem3a_openclraytracer_tpu_torch.ops.sampling import PI


def spherical_uv(direction: torch.Tensor) -> torch.Tensor:
    """Map directions ``[..., 3]`` to lat-long uv in [0, 1]^2, pre-rotated
    90 deg about X then 90 deg about Y like the reference
    (MathLib.cl:72-80)."""
    d = normalize(direction)
    rx, ry, rz = d[..., 1], -d[..., 2], -d[..., 0]
    u = torch.atan2(rz, rx) * (0.5 / PI) + 0.5
    v = torch.asin(torch.clamp(ry, -1.0, 1.0)) * (1.0 / PI) + 0.5
    return torch.stack([u, v], dim=-1)


def sample_ibl(ibl: torch.Tensor, direction: torch.Tensor, bilinear: bool = True):
    """Sample an ``[H, W, 3]`` environment image by direction.

    ``bilinear=True`` filters between texels with clamp-to-edge
    addressing; ``bilinear=False`` is the reference's nearest-texel lookup
    (MathLib.cl:87)."""
    h, w = ibl.shape[0], ibl.shape[1]
    texels = ibl.reshape(h * w, ibl.shape[2])
    uv = spherical_uv(direction)
    x = uv[..., 0] * w
    y = uv[..., 1] * h
    if not bilinear:
        xi = torch.clamp(x.to(torch.int64), 0, w - 1)
        yi = torch.clamp(y.to(torch.int64), 0, h - 1)
        return gather_rows(texels, yi * w + xi)
    x = x - 0.5
    y = y - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    # the four corners in one gather: one sort and one dense texel gradient backward
    c00, c01, c10, c11 = gather_rows(
        texels, torch.stack([y0i * w + x0i, y0i * w + x1i, y1i * w + x0i, y1i * w + x1i]))
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sun_direction(sun_angles_deg: torch.Tensor) -> torch.Tensor:
    """Unit sun direction: Euler-rotated (1, 1, 1) (Raytracing.cl:115-118),
    normalized."""
    v = torch.ones(3, dtype=torch.float32, device=sun_angles_deg.device)
    return normalize(rotate_euler_xyz_deg(v, sun_angles_deg))
