"""The inverse-rendering step written out plainly, on the lanes the
program's recorder takes: :mod:`port_bench.reference.optimize` with the
lane order of a multi-block scene.

The port's replay (``models/replay.py:26-35``) draws its paths from the
Philox stream of its recorder.  On the card, on a scene of more than one
triangle block, that is the fused recorder (``record_paths_fused``,
``models/replay.py:113-140``): its kernels draw the stream in the Morton
order of the primary hits, lane ``j`` holding ray ``order[j]``, and
scatter the records back to pixel order.  On the CPU, and on one block,
lane ``r`` is pixel ``r``.  So the loss and gradients here take the lanes
as :func:`port_bench.reference.render.fused_lane_order` says the program
takes them, as the forward reference does, and count the work of one
step's forward for the roofline (:mod:`port_bench.harness.step_work`).

Loss, Adam, the clamps and the leaves are
:mod:`port_bench.reference.optimize`'s.  TF32 is off while a step runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch

from port_bench.reference import philox, render
from port_bench.reference.optimize import LEAVES, adam, clamp


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products and convolutions in float32, not TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def loss_and_grads(scene, params: Dict[str, torch.Tensor], target: torch.Tensor, key: torch.Tensor,
                   *, morton: bool, dtype=torch.float32, counts: Optional[Dict[str, int]] = None):
    """``(loss, grads)`` of one iteration on ``key``, lane ``r`` in the
    Morton order of the primary hits where ``morton`` is set, else pixel
    ``r``; ``counts`` receives the forward's segments, lanes and sun rays
    (:func:`port_bench.reference.render.radiance`)."""
    leaves = {k: v.detach().to(dtype).requires_grad_(True) for k, v in params.items()}
    primary = render.Primary(scene, dtype)
    n = primary.o.shape[0]
    pixels = torch.arange(n, device=target.device)
    acc = render.radiance(scene, key, primary, pixels, primary.lanes(morton), range(scene.spp),
                          params=leaves, dtype=dtype, counts=counts)
    img = acc / scene.spp + render.miss_radiance(scene, primary, pixels, params=leaves, dtype=dtype)
    loss = torch.sum((img.float() - target.reshape(n, 3)) ** 2) / (n * 3)
    grads = torch.autograd.grad(loss, [leaves[k] for k in LEAVES], allow_unused=True)
    return loss.detach(), {k: (torch.zeros_like(leaves[k]) if g is None else g).float()
                           for k, g in zip(LEAVES, grads)}


def train_steps(scene, target: torch.Tensor, seed: int, steps: int, *, resolution: int, spp: int,
                max_bounce: int, lr: float, morton: bool, dtype=torch.float32,
                counts: Optional[Dict[str, int]] = None) -> List[dict]:
    """The first ``steps`` iterations from the scene's own values: per step
    its loss, its gradients and the values after its update; the last
    also holds Adam's second moment (``nu``).  ``counts`` receives the
    first step's forward work."""
    scene = dataclasses.replace(scene, resolution=resolution, spp=spp, max_bounce=max_bounce)
    params = {k: v.detach().clone() for k, v in render.params_of(scene).items()}
    state = dict(count=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
                 nu={k: torch.zeros_like(v) for k, v in params.items()})
    out = []
    with no_tf32():
        for i in range(steps):
            key = philox.key_from_seed(philox.fold_seed(seed, i), target.device)
            loss, grads = loss_and_grads(scene, params, target, key, morton=morton, dtype=dtype,
                                         counts=counts if i == 0 else None)
            with torch.no_grad():
                params, state = adam(grads, state, params, lr)
                params = clamp(params)
            out.append(dict(loss=float(loss), grads=grads, params=params))
    if out:
        out[-1]["nu"] = state["nu"]
    return out
