"""Closest-hit record and the brute-force tiled Moller-Trumbore engine.

The hit record is SoA: ``(t [N], tri [N], hit [N] bool)`` with the
reference's conventions - closest hit with ``t`` in
``(MIN_HIT_DIST, MAX_DIST)`` (MathLib.cl:263, :282-286).  Counterpart of
the JAX package's ``ops/intersect.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ensem3a_openclraytracer_tpu_torch.ops.geometry import (
    MAX_DIST,
    MIN_HIT_DIST,
    moller_trumbore,
)


class Hit(NamedTuple):
    """SoA closest-hit record for a batch of rays."""

    t: torch.Tensor  # [N] float32, MAX_DIST on miss
    tri: torch.Tensor  # [N] int64 triangle index (0 on miss)
    hit: torch.Tensor  # [N] bool


def trace_bruteforce(v0, v1, v2, ray_o, ray_d, tile: int = 128) -> Hit:
    """Closest hit of ``[N]`` rays against all ``[T, 3]`` triangles,
    ``tile`` triangles at a time.  Among equal ``t`` the lowest triangle
    index wins (first argmin inside a tile, strict ``<`` across tiles)."""
    n = ray_o.shape[0]
    best_t = torch.full((n,), MAX_DIST, dtype=torch.float32, device=ray_o.device)
    best_i = torch.zeros((n,), dtype=torch.int64, device=ray_o.device)
    ro = ray_o[:, None, :]
    rd = ray_d[:, None, :]
    for base in range(0, v0.shape[0], tile):
        sl = slice(base, base + tile)
        t, _, _, hit = moller_trumbore(ro, rd, v0[None, sl], v1[None, sl], v2[None, sl])
        t = torch.where(hit & (t > MIN_HIT_DIST), t, torch.full_like(t, MAX_DIST))
        tmin, arg = torch.min(t, dim=1)
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, base + arg, best_i)
    return Hit(t=best_t, tri=best_i, hit=best_t < MAX_DIST)
