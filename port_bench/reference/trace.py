"""The closest hit by brute force: every ray against every triangle.

The port's rule (``ops/closest_hit.py:14-22``): a ray hits triangle A, B, C
when its Plucker side tests ``w = e . [d, d x o]`` against the three edge
features share a sign (``w == 0`` counts on both sides) and the plane
distance ``t = ([o, 1] . [-n, n.A]) / (d . n)`` exceeds ``MIN_HIT_DIST``;
among equal ``t`` the lowest triangle index wins; a ``t`` of
``MAX_DIST * 0.999`` or more is a miss.  The dot products are matrix
products here (TF32 off), so the work is a few large kernels a chunk.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_DIST = 1000.0
MIN_HIT_DIST = 1e-4
MISS_T = MAX_DIST * 0.999
CHUNK_ELEMS = 1 << 26  # (ray, triangle) pairs per chunk: a few [C, T] float tensors


class Hit(NamedTuple):
    t: torch.Tensor  # [N] float32, MAX_DIST on a miss
    tri: torch.Tensor  # [N] int64, 0 on a miss
    hit: torch.Tensor  # [N] bool


def closest_hit(scene, o: torch.Tensor, d: torch.Tensor, dtype=torch.float32) -> Hit:
    """Closest hit of rays ``o, d [N, 3]`` on ``scene`` (``reference/scene``),
    computed in ``dtype``."""
    n, t_count = o.shape[0], scene.num_tris
    dev = o.device
    edges = scene.edges.to(dtype)  # [3, 6, T]
    plane = scene.plane.to(dtype)
    normal_d = scene.normal_d.to(dtype)
    best_t = torch.full((n,), MAX_DIST, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    tri_tile = min(t_count, CHUNK_ELEMS // 256)
    rays = max(256, CHUNK_ELEMS // max(tri_tile, 1))
    for r0 in range(0, n, rays):
        oc, dc = o[r0:r0 + rays].to(dtype), d[r0:r0 + rays].to(dtype)
        r6 = torch.cat([dc, torch.linalg.cross(dc, oc, dim=-1)], dim=-1)
        q4 = torch.cat([oc, torch.ones_like(oc[:, :1])], dim=-1)
        bt = best_t[r0:r0 + rays]
        bi = best_i[r0:r0 + rays]
        for t0 in range(0, t_count, tri_tile):
            sl = slice(t0, t0 + tri_tile)
            w1, w2, w3 = (r6 @ edges[e, :, sl] for e in range(3))
            inside = ((w1 >= 0) & (w2 >= 0) & (w3 >= 0)) | ((w1 <= 0) & (w2 <= 0) & (w3 <= 0))
            den = dc @ normal_d[:, sl]
            t = ((q4 @ plane[:, sl]) / torch.where(den == 0, torch.ones_like(den), den)).float()
            t = torch.where(inside & (den != 0) & (t > MIN_HIT_DIST), t, MAX_DIST)
            tmin, arg = torch.min(t, dim=1)
            better = tmin < bt
            bt = torch.where(better, tmin, bt)
            bi = torch.where(better, t0 + arg, bi)
        best_t[r0:r0 + rays] = bt
        best_i[r0:r0 + rays] = bi
    hit = best_t < MISS_T
    return Hit(t=torch.where(hit, best_t, MAX_DIST), tri=torch.where(hit, best_i, 0), hit=hit)
