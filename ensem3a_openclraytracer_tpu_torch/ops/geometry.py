"""Core ray/triangle/AABB geometry on batched ``[..., 3]`` float32 tensors.

Counterpart of the JAX package's ``ops/geometry.py`` (the reference's
MathLib.cl:117-199 Moller-Trumbore and slab test, :51-65 rotations).
Every function broadcasts over leading dimensions.
"""

from __future__ import annotations

import math

import torch

# Hit-distance conventions shared with the reference estimator
# (MathLib.cl:120 maxDist, :263 min-k threshold, :119 MT epsilon).
MAX_DIST = 1000.0
MIN_HIT_DIST = 1e-4
MT_EPSILON = 1e-7


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3-vector dot product over the trailing axis."""
    return torch.sum(a * b, dim=-1)


def dot_rn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`dot` as ``(a0*b0 + a1*b1) + a2*b2``, each product and sum
    rounded on its own, as the port's CUDA kernels add a 3-vector on every
    device: torch's CUDA ``sum`` need not add the three products in index
    order, so on the card :func:`dot`'s bits can differ from the CPU's."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return (a0 * b0 + a1 * b1) + a2 * b2


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.where`` with a lane mask ``[N]`` broadcast over trailing axes."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def cross_rn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`cross` with each product and difference rounded on its own,
    as ``jnp.cross`` op by op and the port's CUDA kernels compute it, on
    every device and build: ``torch.linalg.cross``'s CPU kernel is
    contracted into FMAs in builds for AVX2 / AVX-512, so its bits depend
    on the build, and a ray through the edge that two triangles share can
    pick the other one."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize over the trailing axis."""
    return v * (1.0 / torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=eps)))


def rotate_axis_angle(v: torch.Tensor, axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation of ``v`` about ``axis`` (normalized here) by
    ``angle`` in radians; the reference's quaternion ``rotateVec``
    (MathLib.cl:56-65) without the quaternion products."""
    axis = normalize(axis)
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    kv = cross(axis, v)
    kkv = axis * dot(axis, v)[..., None]
    return v * c + kv * s + kkv * (1.0 - c)


def _rot(c, s, axis: int) -> torch.Tensor:
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rows = {
        0: [[o, z, z], [z, c, -s], [z, s, c]],
        1: [[c, z, s], [z, o, z], [-s, z, c]],
        2: [[c, -s, z], [s, c, z], [z, z, o]],
    }[axis]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def euler_xyz_matrix(angles_deg: torch.Tensor) -> torch.Tensor:
    """3x3 matrix applying X, then Y, then Z rotations (angles in degrees):
    ``v' = Rz @ Ry @ Rx @ v`` (Raytracing.cl:33-35, :116-118)."""
    a = angles_deg.to(torch.float32) * (math.pi / 180.0)
    mats = [_rot(torch.cos(a[..., k]), torch.sin(a[..., k]), k) for k in range(3)]
    return mats[2] @ mats[1] @ mats[0]


def rotate_euler_xyz_deg(v: torch.Tensor, angles_deg: torch.Tensor) -> torch.Tensor:
    """Rotate vectors ``v [..., 3]`` by Euler X->Y->Z angles in degrees."""
    return torch.einsum("ij,...j->...i", euler_xyz_matrix(angles_deg), v)


def moller_trumbore(ray_o, ray_d, v0, v1, v2, eps: float = MT_EPSILON, cross=cross, dot=dot):
    """Batched Moller-Trumbore ray/triangle intersection.

    Returns ``(t, u, v, hit)``; ``t`` is ``MAX_DIST`` on a miss.  Front
    and back faces both hit, parallel rays (|det| < eps) miss, and only
    ``t > eps`` counts (MathLib.cl:117-160).  ``cross`` and ``dot``:
    :func:`cross` and :func:`dot`, or :func:`cross_rn` and :func:`dot_rn`
    where the bits must be a CUDA kernel's on any device."""
    e1 = v1 - v0
    e2 = v2 - v0
    h = cross(ray_d, e2)
    det = dot(e1, h)
    parallel = torch.abs(det) < eps
    inv_det = 1.0 / torch.where(parallel, torch.ones_like(det), det)
    s = ray_o - v0
    u = inv_det * dot(s, h)
    q = cross(s, e1)
    v = inv_det * dot(ray_d, q)
    t = inv_det * dot(e2, q)
    hit = (~parallel) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    t = torch.where(hit, t, torch.full_like(t, MAX_DIST))
    return t, u, v, hit


def ray_aabb(ray_o, ray_d, box_min, box_max):
    """Batched slab test (MathLib.cl:167-190), returning ``(tmin, tmax)``.

    Zero direction components are nudged to +-1e-12 so the divisions stay
    finite and an origin on a slab never makes ``inf * 0 = NaN``."""
    tiny = 1e-12
    d = torch.where(
        torch.abs(ray_d) < tiny,
        torch.where(ray_d < 0, torch.full_like(ray_d, -tiny), torch.full_like(ray_d, tiny)),
        ray_d,
    )
    inv = 1.0 / d
    t1 = (box_min - ray_o) * inv
    t2 = (box_max - ray_o) * inv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    return tmin, tmax


def aabb_hit(ray_o, ray_d, box_min, box_max, t_cap=None):
    """Boolean slab test with optional early-out cap on entry distance."""
    tmin, tmax = ray_aabb(ray_o, ray_d, box_min, box_max)
    hit = (tmax >= tmin) & (tmax >= 0.0)
    if t_cap is not None:
        hit = hit & (tmin <= t_cap)
    return hit


def triangle_area(v0, v1, v2):
    """Area of triangles (MathLib.cl:398-402)."""
    return 0.5 * norm(cross(v0 - v1, v0 - v2))


def sample_point_in_triangle(v0, v1, v2, u1, u2):
    """Uniform point sampling in a triangle (MathLib.cl:404-416)."""
    s = torch.sqrt(u1)
    x = 1.0 - s
    y = u2 * s
    return v0 + (v1 - v0) * x[..., None] + (v2 - v0) * y[..., None]
