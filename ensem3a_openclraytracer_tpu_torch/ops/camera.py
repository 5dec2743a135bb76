"""Pinhole camera ray generation.

Counterpart of the JAX package's ``ops/camera.py`` (the reference's
Raytracing.cl:18-37): a unit-width image plane in the camera's x-z plane,
the focal point ``1 / (2 tan(fov/2))`` behind it along -y, Euler X->Y->Z
rotation in degrees, pixel centres at half-texel offsets.  Rows map to
-z and columns to +x.
"""

from __future__ import annotations

import math

import torch

from ensem3a_openclraytracer_tpu_torch.ops.geometry import euler_xyz_matrix, normalize


def focal_distance(fov_rad) -> torch.Tensor:
    """Distance from the unit-width image plane to the focal point."""
    return 1.0 / (2.0 * torch.tan(torch.as_tensor(fov_rad, dtype=torch.float32) / 2.0))


def _centres(n: int, dev) -> torch.Tensor:
    """``(i + 0.5) / n`` for ``i < n`` in float32, made on ``dev`` (no copy
    from the host, so a CUDA graph can capture it) and divided by a tensor:
    on the card a division by a Python number multiplies by its rounded
    reciprocal, which is not always the quotient."""
    i = torch.arange(n, dtype=torch.float32, device=dev)
    return (i + 0.5) / torch.full((), n, dtype=torch.float32, device=dev)


def camera_rays(position: torch.Tensor, rot_deg: torch.Tensor, fov_deg: torch.Tensor,
                height: int, width: int):
    """One primary ray per pixel: ``(origins [H*W, 3], unit directions
    [H*W, 3])`` in row-major pixel order, on ``position``'s device."""
    dev = position.device
    fov_rad = fov_deg.to(torch.float32) * (math.pi / 180.0)
    f = focal_distance(fov_rad)
    rows, cols = _centres(height, dev), _centres(width, dev)
    gz, gx = torch.meshgrid((0.5 - rows) * (height / width), cols - 0.5, indexing="ij")
    local = torch.stack([gx, f.expand_as(gx), gz], dim=-1)
    m = euler_xyz_matrix(rot_deg.to(torch.float32))
    d = normalize(torch.einsum("ij,hwj->hwi", m, local)).reshape(-1, 3)
    o = position.to(torch.float32).expand(d.shape[0], 3)
    return o, d
