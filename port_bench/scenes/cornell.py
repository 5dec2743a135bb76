"""The port's Cornell box: 36 triangles, one triangle block.

Frozen copy of ``ensem3a_openclraytracer_tpu_torch/testing.py`` :89-104
(``cornell_geometry``): a box interior along +y (the camera's forward
axis), x and z in [-1, 1], y in [0, 4], open at y = 0 behind the camera; a
light panel under the ceiling, a glossy and a glass box.  Material ids
index the configuration's ``materials`` rows."""

from __future__ import annotations

from port_bench.scenes.shapes import cube, quad

M_LIGHT, M_WHITE, M_RED, M_GREEN, M_GLOSSY, M_GLASS = range(6)


def triangles(params: dict, seed: int):
    """The box's triangles ``(a, b, c, material id)``; ``params`` and
    ``seed`` change nothing."""
    tris = []
    tris += quad((-1, 0, -1), (1, 0, -1), (1, 4, -1), (-1, 4, -1), M_WHITE)  # floor
    tris += quad((-1, 0, 1), (-1, 4, 1), (1, 4, 1), (1, 0, 1), M_WHITE)  # ceiling
    tris += quad((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1), M_WHITE)  # back
    tris += quad((-1, 0, -1), (-1, 4, -1), (-1, 4, 1), (-1, 0, 1), M_RED)  # left
    tris += quad((1, 0, -1), (1, 0, 1), (1, 4, 1), (1, 4, -1), M_GREEN)  # right
    tris += quad((-0.4, 2.2, 0.98), (-0.4, 3.2, 0.98), (0.4, 3.2, 0.98), (0.4, 2.2, 0.98), M_LIGHT)
    tris += cube((-0.45, 2.9, -0.62), (0.55, 0.55, 0.75), M_GLOSSY)
    tris += cube((0.45, 2.2, -0.7), (0.5, 0.5, 0.6), M_GLASS)
    return tris
