"""Quads and boxes as triangle lists ``(a, b, c, material id)``.

Frozen copy of ``ensem3a_openclraytracer_tpu_torch/testing.py`` :33-53
(``_quad``, ``_cube``)."""

from __future__ import annotations

import numpy as np


def quad(a, b, c, d, mat):
    """Two CCW triangles for the quad a-b-c-d, tagged with material id."""
    return [(a, b, c, mat), (a, c, d, mat)]


def cube(center, size, mat):
    cx, cy, cz = center
    sx, sy, sz = (size, size, size) if np.isscalar(size) else size
    x0, x1 = cx - sx / 2, cx + sx / 2
    y0, y1 = cy - sy / 2, cy + sy / 2
    z0, z1 = cz - sz / 2, cz + sz / 2
    tris = []
    # windings so cross(b-a, c-a) points out of the cube
    tris += quad((x0, y1, z0), (x1, y1, z0), (x1, y0, z0), (x0, y0, z0), mat)  # -z
    tris += quad((x1, y0, z1), (x1, y1, z1), (x0, y1, z1), (x0, y0, z1), mat)  # +z
    tris += quad((x0, y0, z1), (x0, y1, z1), (x0, y1, z0), (x0, y0, z0), mat)  # -x
    tris += quad((x1, y1, z0), (x1, y1, z1), (x1, y0, z1), (x1, y0, z0), mat)  # +x
    tris += quad((x1, y0, z0), (x1, y0, z1), (x0, y0, z1), (x0, y0, z0), mat)  # -y
    tris += quad((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0), mat)  # +y
    return tris
