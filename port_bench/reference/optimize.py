"""The inverse-rendering step written out plainly: the loss, its gradient
by autograd through :func:`port_bench.reference.render.radiance`, Adam and
the clamps.

As the port's ``models/optimize.py`` defines the step (``value_and_grad``
:170-200, ``Adam`` :121-152, ``make_train_step``'s update :240-252): the
loss is the mean over pixels and channels of ``(radiance - target)^2`` of
the unclamped radiance image; Adam is ``optax.adam`` (``eps`` outside the
square root) in optax's order of operations; then colours are clamped to
[0, 1] and roughness, powers and texels to >= 0.  Iteration ``i`` draws
its key words from a generator seeded with ``fold_seed(seed, i)``
(``models/optimize.py:255-261``), and its paths are the forward
estimator's on that key (``models/replay.py:26-35``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from port_bench.reference import philox, render

LEAVES = ("color", "rough", "sun_power", "ibl_power", "ibl")


def adam(grads: Dict[str, torch.Tensor], state: dict, params: Dict[str, torch.Tensor], lr: float,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    mu = {k: (1 - b1) * grads[k] + b1 * state["mu"][k] for k in LEAVES}
    nu = {k: (1 - b2) * (grads[k] * grads[k]) + b2 * state["nu"][k] for k in LEAVES}
    count = state["count"] + 1
    c = torch.tensor(float(count), dtype=torch.float32)
    bc1 = 1 - torch.full_like(c, b1) ** c
    bc2 = 1 - torch.full_like(c, b2) ** c
    new = {k: params[k] + (-lr) * ((mu[k] / bc1.to(mu[k].device))
                                   / (torch.sqrt(nu[k] / bc2.to(nu[k].device)) + eps))
           for k in LEAVES}
    return new, dict(count=count, mu=mu, nu=nu)


def clamp(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.clamp(v, 0.0, 1.0) if k == "color" else torch.clamp(v, min=0.0)
            for k, v in params.items()}


def loss_and_grads(scene, params: Dict[str, torch.Tensor], target: torch.Tensor, key: torch.Tensor,
                   dtype=torch.float32):
    """``(loss, grads)`` of one iteration on ``key``; ``scene`` at the
    step's resolution, samples and bounces."""
    leaves = {k: v.detach().to(dtype).requires_grad_(True) for k, v in params.items()}
    primary = render.Primary(scene, dtype)
    n = primary.o.shape[0]
    pixels = torch.arange(n, device=target.device)
    acc = render.radiance(scene, key, primary, pixels, primary.lanes(False), range(scene.spp),
                          params=leaves, dtype=dtype)
    img = acc / scene.spp + render.miss_radiance(scene, primary, pixels, params=leaves, dtype=dtype)
    loss = torch.sum((img.float() - target.reshape(n, 3)) ** 2) / (n * 3)
    grads = torch.autograd.grad(loss, [leaves[k] for k in LEAVES], allow_unused=True)
    return loss.detach(), {k: (torch.zeros_like(leaves[k]) if g is None else g).float()
                           for k, g in zip(LEAVES, grads)}


def train_steps(scene, target: torch.Tensor, seed: int, steps: int, *, resolution: int, spp: int,
                max_bounce: int, lr: float, dtype=torch.float32) -> List[dict]:
    """The first ``steps`` iterations from the scene's own values: per step
    its loss, its gradients and the values after its update."""
    scene = dataclasses.replace(scene, resolution=resolution, spp=spp, max_bounce=max_bounce)
    params = {k: v.detach().clone() for k, v in render.params_of(scene).items()}
    state = dict(count=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
                 nu={k: torch.zeros_like(v) for k, v in params.items()})
    out = []
    for i in range(steps):
        key = philox.key_from_seed(philox.fold_seed(seed, i), target.device)
        loss, grads = loss_and_grads(scene, params, target, key, dtype)
        with torch.no_grad():
            params, state = adam(grads, state, params, lr)
            params = clamp(params)
        out.append(dict(loss=float(loss), grads=grads, params=params))
    return out
