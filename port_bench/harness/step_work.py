"""The work an inverse-rendering step must do whatever implements it, for
``roofline.opt`` (``harness/counts.least_seconds``).

Counted, as the reference (``reference/optimize_lanes``) does the step:

* the forward of one step: one ray-triangle test for every primary ray
  and every segment traced, the shading of every live lane and bounce and
  of every sun ray (``reference/render.radiance``'s ``counts``);
* 28 bytes for every value whose second moment the reference holds
  non-zero after its last compared step: from then on an exact Adam must
  read and write that value's parameter and both moments and read its
  gradient at every step (4 + 4 + 8 + 8 + 4);
* the other values once: those of the small leaves (colours, roughness,
  powers) whose moment is still zero, the triangles and the material
  table, the target and the image.

Left out, so the count is a lower bound that no program can pass: the
backward's operations, the sums of the gradients, the sky's texels that
no lane reached (no exact step needs to read or write them: a dense pass
over every texel is the program's choice, not the step's need), and the
sums' and the optimizer's operations.
"""

from __future__ import annotations

from typing import Dict

import torch

BYTES_PER_LIVE_VALUE = 28
TEXELS = "ibl"  # the reference's leaf of the sky's texels


def step_counts(scene, tally: Dict[str, int], nu: Dict[str, torch.Tensor],
                resolution: int) -> Dict[str, float]:
    """``segments``, ``lanes``, ``sun`` and ``bytes`` of one step:
    ``tally`` is the reference's forward count of one step, ``nu`` its
    second moment after its last compared step, per leaf."""
    live = {k: int(torch.count_nonzero(v)) for k, v in nu.items()}
    still = sum(v.numel() - live[k] for k, v in nu.items() if k != TEXELS)
    image = resolution * resolution * 3 * 4
    scene_bytes = scene.num_tris * (4 * 12 + 4) + scene.mtype.numel() * 24
    nbytes = BYTES_PER_LIVE_VALUE * sum(live.values()) + 4 * still + scene_bytes + 2 * image
    return dict(segments=resolution * resolution + tally["segments"], lanes=tally["lanes"],
                sun=tally["sun"], bytes=nbytes)
