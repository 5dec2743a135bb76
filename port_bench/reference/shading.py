"""Camera rays, BSDF sampling, the lat-long IBL and the sun, in plain torch.

Frozen copies of the port's ``ops/geometry.py`` (``normalize`` :62,
``_rot`` / ``euler_xyz_matrix`` :82-100), ``ops/camera.py`` (``camera_rays``
:31-45, ``_centres`` :23-29), ``ops/sampling.py`` (``orthonormal_basis``
:20-29), ``ops/bsdf.py`` (``eval_lambert`` :33, ``eval_ggx`` :38-70,
``sample_bounce`` :96-138 with tint glass) and ``ops/envmap.py``
(``spherical_uv`` :21-29, ``sample_ibl`` :32-64 with plain indexing in
place of ``gather_rows``, ``sun_direction`` :67-71).  Material type codes:
0 emissive, 1 diffuse, 2 glossy, 3 glass.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EMISSIVE, DIFFUSE, GLOSSY, GLASS = 0, 1, 2, 3
PI = np.float32(np.pi)
_SQRT_2_OVER_PI = np.sqrt(np.float32(2.0) / PI)


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def normalize(v, eps: float = 1e-20):
    return v * (1.0 / torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=eps)))


def _rot(c, s, axis: int):
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rows = {
        0: [[o, z, z], [z, c, -s], [z, s, c]],
        1: [[c, z, s], [z, o, z], [-s, z, c]],
        2: [[c, -s, z], [s, c, z], [z, z, o]],
    }[axis]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def euler_xyz_matrix(angles_deg):
    a = angles_deg.to(torch.float32) * (math.pi / 180.0)
    mats = [_rot(torch.cos(a[..., k]), torch.sin(a[..., k]), k) for k in range(3)]
    return mats[2] @ mats[1] @ mats[0]


def _centres(n: int, dev):
    i = torch.arange(n, dtype=torch.float32, device=dev)
    return (i + 0.5) / torch.full((), n, dtype=torch.float32, device=dev)


def camera_rays(position, rot_deg, fov_deg, height: int, width: int):
    """``(origins [H*W, 3], unit directions [H*W, 3])`` in row-major pixel
    order."""
    dev = position.device
    fov_rad = fov_deg.to(torch.float32) * (math.pi / 180.0)
    f = 1.0 / (2.0 * torch.tan(torch.as_tensor(fov_rad, dtype=torch.float32) / 2.0))
    rows, cols = _centres(height, dev), _centres(width, dev)
    gz, gx = torch.meshgrid((0.5 - rows) * (height / width), cols - 0.5, indexing="ij")
    local = torch.stack([gx, f.expand_as(gx), gz], dim=-1)
    m = euler_xyz_matrix(rot_deg.to(torch.float32))
    d = normalize(torch.einsum("ij,hwj->hwi", m, local)).reshape(-1, 3)
    return position.to(torch.float32).expand(d.shape[0], 3), d


def sun_direction(sun_angles_deg):
    v = torch.ones(3, dtype=torch.float32, device=sun_angles_deg.device)
    return normalize(torch.einsum("ij,...j->...i", euler_xyz_matrix(sun_angles_deg), v))


def orthonormal_basis(n):
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, torch.ones_like(nz), -torch.ones_like(nz))
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def eval_lambert(color):
    return color / PI


def eval_ggx(color, roughness, v, l, n):
    h = normalize(l + v)
    alpha_sqr = torch.square(roughness)
    ndoth = torch.clamp(dot(n, h), min=0.0)
    d_den = torch.clamp(PI * torch.square(torch.square(ndoth) * (alpha_sqr - 1.0) + 1.0), min=1e-12)
    k = roughness * _SQRT_2_OVER_PI
    ndotv = torch.clamp(dot(n, v), min=0.0)
    ndotl = torch.clamp(dot(n, l), min=0.0)
    g1_den = torch.clamp(ndotv * (1.0 - k) + k, min=1e-12)
    g2_den = torch.clamp(ndotl * (1.0 - k) + k, min=1e-12)
    f0 = 0.04
    one_m_hv = 1.0 - torch.clamp(dot(h, v), min=0.0)
    p2 = one_m_hv * one_m_hv
    f = f0 + (1.0 - f0) * (p2 * p2 * one_m_hv)
    specular = (f * alpha_sqr * ndotv * ndotl) / torch.clamp(
        d_den * g1_den * g2_den * torch.clamp(4.0 * ndotv * ndotl, min=1e-3), min=1e-12)
    kd = (1.0 - f) * 0.5
    return kd[..., None] * color / PI + specular[..., None]


def sample_bounce(mat_type, color, roughness, in_dir, n, u1, u2):
    """Bounce direction and throughput factor ``BRDF * inv_pdf * |cos|``:
    cosine-weighted Lambert, uniform-hemisphere GGX, straight-through tint
    glass."""
    t, bt = orthonormal_basis(n)
    phi = 2.0 * PI * u2
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    r = torch.sqrt(u1)
    z_cos = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    d_diff = t * (r * cphi)[..., None] + bt * (r * sphi)[..., None] + n * z_cos[..., None]
    invpdf_diff = PI / torch.clamp(z_cos, min=1e-6)
    cos_u = 1.0 - u1
    sin_u = torch.sqrt(torch.clamp(1.0 - cos_u * cos_u, min=0.0))
    d_unif = t * (sin_u * cphi)[..., None] + bt * (sin_u * sphi)[..., None] + n * cos_u[..., None]
    is_glossy = (mat_type == GLOSSY)[..., None]
    is_glass = (mat_type == GLASS)[..., None]
    bounce_dir = torch.where(is_glass, in_dir, torch.where(is_glossy, d_unif, d_diff)).detach()
    cos_abs = torch.abs(dot(bounce_dir, n))
    factor_diff = eval_lambert(color) * (invpdf_diff * cos_abs)[..., None]
    factor_glossy = (eval_ggx(color, roughness, -in_dir, bounce_dir, n)
                     * (2.0 * PI * cos_abs)[..., None])
    factor = torch.where(is_glass, color, torch.where(is_glossy, factor_glossy, factor_diff))
    return bounce_dir, factor


def spherical_uv(direction):
    d = normalize(direction)
    rx, ry, rz = d[..., 1], -d[..., 2], -d[..., 0]
    u = torch.atan2(rz, rx) * (0.5 / PI) + 0.5
    v = torch.asin(torch.clamp(ry, -1.0, 1.0)) * (1.0 / PI) + 0.5
    return torch.stack([u, v], dim=-1)


def sample_ibl(ibl, direction):
    """Bilinear lookup of an ``[H, W, 3]`` lat-long image, clamp to edge."""
    h, w = ibl.shape[0], ibl.shape[1]
    texels = ibl.reshape(h * w, ibl.shape[2])
    uv = spherical_uv(direction)
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    c00, c01 = texels[y0i * w + x0i], texels[y0i * w + x1i]
    c10, c11 = texels[y1i * w + x0i], texels[y1i * w + x1i]
    top = c00 * (1.0 - fx) + c01 * fx
    bot = c10 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy
