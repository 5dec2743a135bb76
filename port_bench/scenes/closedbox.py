"""The port's Cornell box with a dense closed mesh in it: the 36 triangles of
``scenes/cornell.py`` and a UV sphere of ``bands`` latitude bands and
``segments`` segments, ``2 * segments * (bands - 1)`` triangles (a fan of
``segments`` triangles at each pole, two a quad in every other band).

The sphere stands in for the upstream Monkey mesh, which is not in this
repository: at ``bands`` 61 and ``segments`` 131 it has 15,720 triangles,
15,756 with the box, as the Monkey scene has.  Its vertices lie on the
sphere of ``params["radius"]`` about ``params["center"]``, wound so that
``cross(b - a, c - a)`` points out of it, and it takes the glossy material
(``scenes/cornell.M_GLOSSY``).  The run's seed changes nothing: the
configuration is one fixed scene."""

from __future__ import annotations

import numpy as np

from port_bench.scenes import cornell
from port_bench.scenes.shapes import quad


def sphere(center, radius: float, bands: int, segments: int, mat):
    """The UV sphere's triangles ``(a, b, c, material id)``, outward wound:
    ring ``j`` of ``bands - 1`` at polar angle ``pi * j / bands`` from +z."""
    c = np.asarray(center, np.float64)
    theta = np.pi * np.arange(1, bands) / bands
    phi = 2.0 * np.pi * np.arange(segments) / segments
    rings = [[tuple(c + radius * np.array([np.sin(t) * np.cos(f), np.sin(t) * np.sin(f),
                                           np.cos(t)])) for f in phi] for t in theta]
    top, bottom = tuple(c + [0.0, 0.0, radius]), tuple(c - [0.0, 0.0, radius])
    tris = []
    for k in range(segments):
        k1 = (k + 1) % segments
        tris.append((top, rings[0][k], rings[0][k1], mat))
        for j in range(bands - 2):
            tris += quad(rings[j][k], rings[j + 1][k], rings[j + 1][k1], rings[j][k1], mat)
        tris.append((bottom, rings[-1][k1], rings[-1][k], mat))
    return tris


def triangles(params: dict, seed: int):
    """The box's triangles, then the sphere's."""
    return cornell.triangles({}, seed) + sphere(
        params["center"], float(params["radius"]), int(params["bands"]),
        int(params["segments"]), cornell.M_GLOSSY)
