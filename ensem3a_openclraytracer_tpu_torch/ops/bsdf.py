"""BSDF evaluation and branch-free lobe-select bounce sampling.

Counterpart of the JAX package's ``ops/bsdf.py`` (the reference's
MathLib.cl:461-512 and Raytracing.cl:58-78): type 0 emissive (power in
the roughness slot), 1 diffuse Lambert with cosine sampling, 2 glossy
(uniform hemisphere sampling + GGX/Fresnel/Smith evaluation), 3 glass
(straight-through tint, or Snell refraction with ``glass_mode="refract"``).
Every lane evaluates every lobe and selects by material type.
"""

from __future__ import annotations

import numpy as np
import torch

from ensem3a_openclraytracer_tpu_torch.ops.geometry import dot, normalize
from ensem3a_openclraytracer_tpu_torch.ops.sampling import (
    PI,
    orthonormal_basis,
    sample_glass,
)

# Material type codes (UI.py:215).
EMISSIVE = 0
DIFFUSE = 1
GLOSSY = 2
GLASS = 3

_SQRT_2_OVER_PI = np.sqrt(np.float32(2.0) / PI)


def eval_lambert(color):
    """Lambert BRDF (MathLib.cl:503-506)."""
    return color / PI


def eval_ggx(color, roughness, v, l, n):
    """GGX + Schlick-Fresnel + Smith-ish BRDF (MathLib.cl:461-500).

    ``v`` points toward the viewer, ``l`` toward the light, ``n`` is the
    unit normal (scalar F0 = 0.04, k = roughness * sqrt(2/pi),
    kd = (1 - F) * 0.5).  The product denominator is clamped so degenerate
    lanes give 0 and not 0/0."""
    h = normalize(l + v)
    alpha_sqr = torch.square(roughness)
    ndoth = torch.clamp(dot(n, h), min=0.0)
    d_den = torch.clamp(
        PI * torch.square(torch.square(ndoth) * (alpha_sqr - 1.0) + 1.0), min=1e-12
    )
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
        d_den * g1_den * g2_den * torch.clamp(4.0 * ndotv * ndotl, min=1e-3),
        min=1e-12,
    )
    kd = (1.0 - f) * 0.5
    diffuse = kd[..., None] * color / PI
    return diffuse + specular[..., None]


def eval_glass(color):
    """Glass 'BRDF' - pure tint (MathLib.cl:509-512)."""
    return color


def sample_glass_refract(in_dir, n, ior, u1):
    """Snell refraction with an exact dielectric Fresnel reflect/refract
    coin and total internal reflection.  ``in_dir`` points INTO the
    surface; ``n`` is the outward normal; ``u1`` is the Fresnel coin."""
    cos_raw = dot(in_dir, n)
    entering = cos_raw < 0.0
    n_eff = torch.where(entering[..., None], n, -n)
    ci = torch.clamp(-dot(in_dir, n_eff), 0.0, 1.0)
    eta = torch.where(entering, 1.0 / ior, ior)
    k = 1.0 - eta * eta * (1.0 - ci * ci)
    tir = k < 0.0
    ct = torch.sqrt(torch.clamp(k, min=0.0))
    refr = in_dir * eta[..., None] + n_eff * (eta * ci - ct)[..., None]
    refl = in_dir + n_eff * (2.0 * ci)[..., None]
    rs = (eta * ci - ct) / torch.clamp(eta * ci + ct, min=1e-12)
    rp = (eta * ct - ci) / torch.clamp(eta * ct + ci, min=1e-12)
    fres = 0.5 * (rs * rs + rp * rp)
    reflect = tir | (u1 < fres)
    return torch.where(reflect[..., None], refl, normalize(refr))


def sample_bounce(mat_type, color, roughness, in_dir, n, u1, u2,
                  ior=None, glass_mode: str = "tint"):
    """Sample the bounce direction and the per-bounce throughput factor
    ``BRDF * inv_pdf * |cos|`` (Raytracing.cl:86-87).

    ``in_dir`` points into the surface, ``n`` is the unit shading normal,
    ``u1, u2`` are uniforms in [0, 1).  Emissive lanes get the diffuse
    lobe, which the caller ignores.  The direction is detached: it does
    not depend on a differentiable parameter."""
    t, bt = orthonormal_basis(n)
    phi = 2.0 * PI * u2
    cphi = torch.cos(phi)
    sphi = torch.sin(phi)
    r = torch.sqrt(u1)
    z_cos = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    d_diff = t * (r * cphi)[..., None] + bt * (r * sphi)[..., None] + n * z_cos[..., None]
    invpdf_diff = PI / torch.clamp(z_cos, min=1e-6)
    cos_u = 1.0 - u1
    sin_u = torch.sqrt(torch.clamp(1.0 - cos_u * cos_u, min=0.0))
    d_unif = t * (sin_u * cphi)[..., None] + bt * (sin_u * sphi)[..., None] + n * cos_u[..., None]
    invpdf_unif = 2.0 * PI
    if glass_mode == "refract":
        if ior is None:
            raise ValueError("glass_mode='refract' requires per-lane ior")
        d_glass = sample_glass_refract(in_dir, n, ior, u1)
    elif glass_mode == "tint":
        d_glass, _ = sample_glass(in_dir)
    else:
        raise ValueError(f"unknown glass_mode {glass_mode!r}")

    is_glossy = (mat_type == GLOSSY)[..., None]
    is_glass = (mat_type == GLASS)[..., None]
    bounce_dir = torch.where(is_glass, d_glass, torch.where(is_glossy, d_unif, d_diff))
    bounce_dir = bounce_dir.detach()

    cos_abs = torch.abs(dot(bounce_dir, n))
    factor_diff = eval_lambert(color) * (invpdf_diff * cos_abs)[..., None]
    factor_glossy = eval_ggx(color, roughness, -in_dir, bounce_dir, n) * (
        invpdf_unif * cos_abs
    )[..., None]
    # glass: attenuation forced to 1 (Raytracing.cl:76), only the tint stays
    factor = torch.where(
        is_glass, eval_glass(color), torch.where(is_glossy, factor_glossy, factor_diff)
    )
    return bounce_dir, factor
