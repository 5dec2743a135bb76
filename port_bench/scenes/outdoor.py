"""A ground plane and a grid of jittered cubes: ``12 * n_cubes + 2``
triangles.

Frozen copy of ``ensem3a_openclraytracer_tpu_torch/testing.py`` :131-146
(``make_outdoor_scene``'s triangles, without the optional light panel).
The jitter comes from ``params["geometry_seed"]``, not from the run's
seed: the configuration is one fixed scene, so every run does the same
work."""

from __future__ import annotations

import numpy as np

from port_bench.scenes.shapes import cube, quad

M_WHITE, M_RED, M_GREEN, M_GLOSSY = 1, 2, 3, 4


def triangles(params: dict, seed: int):
    """The scene's triangles ``(a, b, c, material id)``."""
    n_cubes = int(params["n_cubes"])
    rng = np.random.default_rng(int(params["geometry_seed"]))
    tris = quad((-40, -40, 0), (40, -40, 0), (40, 40, 0), (-40, 40, 0), M_WHITE)
    side = int(np.ceil(np.sqrt(n_cubes)))
    for i in range(n_cubes):
        gx, gy = i % side, i // side
        x = (gx - side / 2) * 3.0 + rng.uniform(-0.8, 0.8)
        y = 6.0 + gy * 3.0 + rng.uniform(-0.8, 0.8)
        s = rng.uniform(0.5, 1.4)
        m = [M_WHITE, M_RED, M_GREEN, M_GLOSSY][i % 4]
        tris += cube((x, y, s / 2), s, m)
    return tris
