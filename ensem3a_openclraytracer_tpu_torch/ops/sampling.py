"""Direction sampling on the hemisphere as pure functions of uniforms.

Counterpart of the JAX package's ``ops/sampling.py`` (the reference's
MathLib.cl:294-395 samplers).  Every sampler returns
``(direction, inv_pdf)`` with the direction in world space around the
unit normal ``n``; the uniforms come from the caller, so a test can feed
the JAX estimator and this one the same stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ensem3a_openclraytracer_tpu_torch.ops.geometry import dot

PI = np.float32(np.pi)


def orthonormal_basis(n: torch.Tensor):
    """Branchless Frisvad/Duff orthonormal basis around unit ``n [..., 3]``."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, torch.ones_like(nz), -torch.ones_like(nz))
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def local_to_world(local_v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Map a local (+z = normal) direction into world space."""
    t, bt = orthonormal_basis(n)
    return t * local_v[..., 0:1] + bt * local_v[..., 1:2] + n * local_v[..., 2:3]


def sample_hemisphere_cosine(n, u1, u2):
    """Cosine-weighted hemisphere sample (MathLib.cl:313-339);
    ``inv_pdf = pi / max(cos_theta, 1e-6)``."""
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return local_to_world(local, n), PI / torch.clamp(z, min=1e-6)


def sample_hemisphere_uniform(n, u1, u2):
    """Uniform hemisphere sample (MathLib.cl:342-366); ``inv_pdf = 2 pi``."""
    phi = 2.0 * PI * u2
    cos_theta = 1.0 - u1
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    local = torch.stack(
        [torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta], dim=-1
    )
    d = local_to_world(local, n)
    return d, torch.full_like(d[..., 0], 2.0 * PI)


def sample_ggx_half_vector(roughness, n, u1, u2):
    """GGX NDF half-vector sample (MathLib.cl:369-387).  Returns
    ``(h_world, d_ndf)``."""
    alpha_sqr = roughness * roughness
    phi = 2.0 * PI * u2
    cos_theta = torch.sqrt(
        torch.clamp((1.0 - u1) / ((alpha_sqr - 1.0) * u1 + 1.0), min=0.0)
    )
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    local = torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )
    h = local_to_world(local, n)
    ndoth = torch.clamp(dot(n, h), min=0.0)
    d_ndf = alpha_sqr / torch.clamp(
        PI * torch.square(torch.square(ndoth) * (alpha_sqr - 1.0) + 1.0), min=1e-12
    )
    return h, d_ndf


def sample_glass(incoming_dir):
    """Glass 'sampling': the ray continues straight through
    (MathLib.cl:391-395)."""
    return incoming_dir, torch.ones_like(incoming_dir[..., 0])
