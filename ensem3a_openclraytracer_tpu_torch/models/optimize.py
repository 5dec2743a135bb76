"""Inverse rendering: gradient-based optimization of scene parameters.

Counterpart of the JAX package's ``models/optimize.py``: render, an image
loss against a target, gradients by ``torch.autograd`` through the
path-replay engine (``models/replay.py``), an Adam update and the clamps
that keep the parameters physical.  The differentiable parameters are
material colors, roughness (emissive power for emissive materials), sun
and IBL powers and the IBL texels; geometry and visibility are detached.

Adam is written out (:class:`Adam`) as ``optax.adam`` computes it, and its
state is plain tensors, so a run stopped at iteration k resumes from an
``.npz`` checkpoint with the same loss trajectory bit for bit: iteration
``i`` renders with the generator :func:`iteration_generator` makes from
(base seed, ``i``).  The JAX package's ``fold_in(key, i)`` plays that part
there; the two packages' streams differ.

The train step of :func:`make_train_step` is the counterpart of the JAX
package's ``jax.jit`` step: on a one-rank mesh on the card the whole step
(record, replay, backward, the fixed-point gradient sums, Adam and the
clamps) is one captured CUDA graph (``utils/graphs.Graphed``), replayed
with each step's inputs copied in and its key words drawn before the
replay; on the CPU and on a mesh of several ranks it runs eagerly.
:func:`value_and_grad` stays eager, as the JAX package's un-jitted
function does.
"""

from __future__ import annotations

import functools
import os
import tempfile
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ensem3a_openclraytracer_tpu_torch._device import DeviceLike, resolve_device
from ensem3a_openclraytracer_tpu_torch.models.pathtracer import radiance_for_rays
from ensem3a_openclraytracer_tpu_torch.models.replay import radiance_for_rays_replay
from ensem3a_openclraytracer_tpu_torch.ops import rng
from ensem3a_openclraytracer_tpu_torch.parallel.mesh import Mesh, single_device_mesh
from ensem3a_openclraytracer_tpu_torch.parallel.render import fold_ranks, render_rows
from ensem3a_openclraytracer_tpu_torch.scene.materials import EnvParams, MaterialParams
from ensem3a_openclraytracer_tpu_torch.utils.graphs import Graphed
from ensem3a_openclraytracer_tpu_torch.utils.profiling import span


class TrainableParams(NamedTuple):
    """The differentiable leaves of the material table and the
    environment (material types and geometry stay fixed)."""

    color: torch.Tensor  # [M, 3]
    roughness: torch.Tensor  # [M] (emissive power for type-0 materials)
    sun_power: torch.Tensor  # []
    ibl_power: torch.Tensor  # []
    ibl: torch.Tensor  # [H, W, 3]

    @staticmethod
    def from_scene_params(materials: MaterialParams, env: EnvParams) -> "TrainableParams":
        return TrainableParams(color=materials.color, roughness=materials.roughness,
                               sun_power=env.sun_power, ibl_power=env.ibl_power, ibl=env.ibl)

    def apply(self, materials: MaterialParams,
              env: EnvParams) -> Tuple[MaterialParams, EnvParams]:
        """The full parameter structs with these leaves grafted on."""
        m = materials._replace(color=self.color, roughness=self.roughness)
        e = env._replace(sun_power=self.sun_power, ibl_power=self.ibl_power, ibl=self.ibl)
        return m, e


def image_loss(rendered: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error in linear radiance."""
    return torch.mean((rendered - target) ** 2)


def render_for_grad(params: TrainableParams, geom, materials: MaterialParams, env: EnvParams,
                    camera, gen: Optional[torch.Generator] = None, *, height: int, width: int,
                    spp: int, max_bounce: int, sun_enabled: bool = True,
                    mesh: Optional[Mesh] = None, nee: bool = False, lights=None,
                    mis: bool = False, **stream) -> torch.Tensor:
    """Differentiable radiance image from :class:`TrainableParams`: the one
    entry point of every gradient consumer.  It renders with the
    path-replay engine; ``nee=True`` (with ``lights``) switches it to the
    next-event estimator, and ``mis=True`` (implies NEE) renders with the
    scan estimator, since the recorder has no MIS mode.  ``stream`` may
    hold explicit ``uniforms`` / ``light_uniforms`` in place of the
    generator's, and ``key`` the generator's key words on a one-rank mesh.

    It returns this rank's rows ``[height / dp, width, 3]`` of ``mesh``
    (``parallel/mesh``; default 1x1, the whole image), averaged over the
    ``sp`` group; the gradient reaches this rank's own samples only, and
    :func:`value_and_grad` sums the parameters' gradients over the mesh."""
    m, e = params.apply(materials, env)
    radiance = (functools.partial(radiance_for_rays, fused=False, nee=True, mis=True) if mis
                else functools.partial(radiance_for_rays_replay, nee=nee))
    return render_rows(mesh if mesh is not None else single_device_mesh(), radiance, geom, m, e,
                       camera, gen, height=height, width=width, spp=spp, max_bounce=max_bounce,
                       sun_enabled=sun_enabled, lights=lights, **stream)


class AdamState(NamedTuple):
    """``optax.adam``'s state: the step count and the two moments."""

    count: torch.Tensor  # [] int32
    mu: TrainableParams
    nu: TrainableParams


class Adam(NamedTuple):
    """``optax.adam(learning_rate)`` written out (Kingma and Ba's
    Algorithm 1, ``eps`` outside the square root), in optax's order of
    operations, on float32 tensors."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: TrainableParams) -> AdamState:
        zeros = lambda: TrainableParams(*(torch.zeros_like(x) for x in params))
        return AdamState(count=torch.zeros((), dtype=torch.int32, device=params.color.device),
                         mu=zeros(), nu=zeros())

    def update(self, grads: TrainableParams, state: AdamState,
               params: TrainableParams) -> Tuple[TrainableParams, AdamState]:
        """``(params + updates, state)``."""
        b1, b2 = self.b1, self.b2
        mu = TrainableParams(*((1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)))
        nu = TrainableParams(*((1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)))
        count = state.count + 1
        c = count.to(torch.float32)
        bc1 = 1 - torch.full_like(c, b1) ** c
        bc2 = 1 - torch.full_like(c, b2) ** c
        new = TrainableParams(*(
            p + (-self.learning_rate) * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps))
            for p, m, v in zip(params, mu, nu)))
        return new, AdamState(count=count, mu=mu, nu=nu)


def value_and_grad(params: TrainableParams, target: torch.Tensor, geom,
                   materials: MaterialParams, env: EnvParams, camera,
                   gen: Optional[torch.Generator] = None, *, height: int, width: int,
                   mesh: Optional[Mesh] = None, **kwargs) -> Tuple[torch.Tensor, TrainableParams]:
    """``(loss, grads)`` of :func:`image_loss` of :func:`render_for_grad`
    (keyword arguments as there) against ``target``; a parameter that the
    image does not reach gets a zero gradient.

    ``target`` is this rank's rows of ``mesh`` (default 1x1, the whole
    image; ``parallel/render.shard_target_image``) and every rank of the
    mesh calls it with the same arguments.  The loss is the mean over all
    pixels, taken as each rank's sum over its rows divided by the pixel
    count, and the gradients are summed over the mesh in rank order, so
    every rank holds the same loss and gradients bit for bit."""
    mesh = mesh if mesh is not None else single_device_mesh()
    leaves = [x.detach().requires_grad_(True) for x in params]
    img = render_for_grad(TrainableParams(*leaves), geom, materials, env, camera, gen,
                          height=height, width=width, mesh=mesh, **kwargs)
    if tuple(target.shape) != tuple(img.shape):
        raise ValueError(f"target {tuple(target.shape)}: pass this rank's rows "
                         f"{tuple(img.shape)} (shard_target_image)")
    loss = torch.sum((img - target) ** 2) / (height * width * 3)  # this rank's part
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    loss = loss.detach()
    if mesh.group is not None:
        flat = fold_ranks(torch.cat([g.reshape(-1) for g in grads]), mesh.group, mesh.size)
        grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
        loss = fold_ranks(loss, mesh.dp_group, mesh.dp)
    return loss, TrainableParams(*grads)


def make_train_step(geom, materials: MaterialParams, env: EnvParams, camera, optimizer: Adam, *,
                    height: int, width: int, spp: int, max_bounce: int,
                    mesh: Optional[Mesh] = None, sun_enabled: bool = True, nee: bool = False,
                    lights=None, mis: bool = False):
    """``(init, step)`` for inverse rendering against a target image.

    ``init(params=None) -> (params, opt_state)`` starts from the scene's
    parameters; ``step(params, opt_state, target, gen) -> (params,
    opt_state, loss)`` takes :func:`value_and_grad`, updates with
    ``optimizer`` and clamps colors to [0, 1] and powers, roughness and
    texels to >= 0.  The inputs are not modified.  The target is this
    rank's rows of ``mesh`` (default 1x1) and every rank takes the same
    update.

    On a one-rank mesh on the card ``step`` replays one captured CUDA
    graph of the whole step (module docstring): the first step captures
    it, the spp chunking of the replay decided before the capture; the key
    words are drawn from ``gen`` before each replay, so a step gives the
    same update bit for bit, graph or eager.  ``step.graph`` is its
    ``Graphed`` (None on several ranks) and ``step.eager(params, opt_state,
    target, gen)`` the same step without a graph.  While a profiler
    records, each call is the span ``train_step`` (``utils/profiling``),
    with ``Graphed``'s spans inside it."""
    kw = dict(height=height, width=width, spp=spp, max_bounce=max_bounce,
              sun_enabled=sun_enabled, nee=nee, lights=lights, mis=mis, mesh=mesh)

    def update(params: TrainableParams, opt_state: AdamState, target: torch.Tensor,
               gen: Optional[torch.Generator] = None, key: Optional[torch.Tensor] = None):
        loss, grads = value_and_grad(params, target, geom, materials, env, camera, gen, key=key,
                                     **kw)
        with torch.no_grad():
            new, opt_state = optimizer.update(grads, opt_state, TrainableParams(*params))
            new = TrainableParams(
                color=torch.clamp(new.color, 0.0, 1.0),
                roughness=torch.clamp(new.roughness, min=0.0),
                sun_power=torch.clamp(new.sun_power, min=0.0),
                ibl_power=torch.clamp(new.ibl_power, min=0.0),
                ibl=torch.clamp(new.ibl, min=0.0),
            )
        return new, opt_state, loss

    graphed = Graphed(update) if mesh is None or mesh.size == 1 else None

    def step(params: TrainableParams, opt_state: AdamState, target: torch.Tensor,
             gen: Optional[torch.Generator]):
        with span("train_step"):
            if graphed is None:  # several ranks: the gradient sum over the mesh stays eager
                return update(params, opt_state, target, gen)
            return graphed(params, opt_state, target,
                           key=rng.key_from_generator(gen, target.device))

    step.graph, step.eager = graphed, update  # the captures, and the step without a graph

    def init(params: Optional[TrainableParams] = None):
        p = TrainableParams.from_scene_params(materials, env) if params is None else params
        p = TrainableParams(*(x.detach() for x in p))
        return p, optimizer.init(p)

    return init, step


def iteration_generator(seed: int, i: int, device: DeviceLike = None) -> torch.Generator:
    """The random source of iteration ``i`` of a run with base ``seed``: a
    generator on ``device`` seeded with ``ops/rng.fold_seed(seed, i)``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(rng.fold_seed(seed, i))
    return gen


# ---------------------------------------------------------------------------
# Checkpoints: a stopped run resumes with the identical loss trajectory.
# ---------------------------------------------------------------------------

_FIELDS = TrainableParams._fields


def save_optimizer_checkpoint(path, params: TrainableParams, opt_state: AdamState,
                              iteration: int, seed: int) -> None:
    """Write ``(params, opt_state, iteration, seed)`` to an ``.npz``
    atomically (a temporary file, then ``os.replace``): ``param.<field>``,
    ``mu.<field>``, ``nu.<field>``, ``count``, ``iteration``, ``seed``."""
    payload = {}
    for prefix, tree in (("param", params), ("mu", opt_state.mu), ("nu", opt_state.nu)):
        for name, x in zip(_FIELDS, tree):
            payload[f"{prefix}.{name}"] = x.detach().cpu().numpy()
    payload["count"] = opt_state.count.detach().cpu().numpy().astype(np.int32)
    payload["iteration"] = np.asarray(iteration, np.int64)
    payload["seed"] = np.asarray(seed, np.int64)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)  # a crash never leaves a half-written checkpoint
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_optimizer_checkpoint(path, device: DeviceLike = None):
    """``(params, opt_state, iteration, seed)`` saved by
    :func:`save_optimizer_checkpoint`, on ``device``."""
    dev = resolve_device(device)
    with np.load(path) as z:
        tree = lambda prefix: TrainableParams(*(torch.as_tensor(z[f"{prefix}.{n}"], device=dev)
                                                for n in _FIELDS))
        params = tree("param")
        opt_state = AdamState(count=torch.as_tensor(z["count"], device=dev), mu=tree("mu"),
                              nu=tree("nu"))
        return params, opt_state, int(z["iteration"]), int(z["seed"])


def run_optimization(init, step, target: torch.Tensor, seed: int, *, iters: int,
                     checkpoint_path: Optional[str] = None, checkpoint_every: int = 25,
                     log: Optional[Callable[[int, float], None]] = None):
    """Drive ``step`` for ``iters`` iterations with resumable checkpoints;
    returns ``(params, opt_state, last_loss)``.

    Iteration ``i`` takes ``iteration_generator(seed, i)``, so a run
    stopped after iteration k and resumed from its checkpoint (which holds
    the base seed) draws the same random numbers: the loss trajectory is
    the same bit for bit.  A step that raises ``RuntimeError`` is retried
    (three attempts) with the same generator seed, so a retry gives the
    same update.  On the card the attempt synchronizes inside the ``try``,
    so an asynchronous CUDA error is caught by the retry and not after
    it.  Under ``torch.distributed`` only rank 0 writes the checkpoint;
    every rank reads it to resume."""
    dev = target.device
    params, opt_state = init()
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        params, opt_state, start, seed = load_optimizer_checkpoint(checkpoint_path, dev)
    writer = not dist.is_initialized() or dist.get_rank() == 0
    loss = None
    for i in range(start, iters):
        for attempt in range(3):
            try:
                params_i, opt_state_i, loss = step(params, opt_state, target,
                                                   iteration_generator(seed, i, dev))
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                break
            except RuntimeError:
                if attempt == 2:
                    raise
                print(f"optimization step {i} failed, retrying", flush=True)
        params, opt_state = params_i, opt_state_i
        if log is not None:
            log(i, float(loss))
        if (checkpoint_path and writer
                and ((i + 1) % checkpoint_every == 0 or i == iters - 1)):
            save_optimizer_checkpoint(checkpoint_path, params, opt_state, i + 1, seed)
    return params, opt_state, loss
