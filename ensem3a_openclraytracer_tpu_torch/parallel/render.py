"""Sharded rendering: pixel rows over ``dp``, samples over ``sp``.

Counterpart of the JAX package's ``parallel/render.py`` on
``torch.distributed``.  Every rank holds the whole scene and renders its
block of ``height / dp`` rows with ``spp / sp`` samples; the ranks of one
row block then average their sample sets (one collective over the ``sp``
group), and on request the row blocks are gathered over ``dp``.  Sums
across ranks are taken in rank order from an all-gather, so every rank
holds the same bits and two runs on the same mesh agree bit for bit.

Random numbers: rank ``(dp_idx, sp_idx)`` renders with a generator
seeded ``fold_seed(fold_seed(seed, dp_idx), sp_idx)``
(``ops/rng.fold_seed``), the counterpart of JAX's
``fold_in(fold_in(key, dp), sp)``; ``seed`` is the caller's integer, or
is drawn from the caller's generator.  A mesh of one rank renders with
the caller's generator itself, so a 1x1 sharded render is
``render_radiance``'s image bit for bit; its sums over one rank are the
rank's own tensor, with no collective.  Explicit ``uniforms`` /
``light_uniforms`` are sliced by row block and sample set instead, so the
sharded image equals the unsharded one up to the order of the sum over
samples.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import torch
import torch.distributed as dist

from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays
from ensem3a_openclraytracer_tpu_torch.ops.rng import fold_seed, key_from_generator
from ensem3a_openclraytracer_tpu_torch.parallel.mesh import Mesh
from ensem3a_openclraytracer_tpu_torch.utils.graphs import Graphed

GenOrSeed = Optional[Union[torch.Generator, int]]


def _check_shape(mesh: Mesh, height: int, spp: int) -> None:
    if height % mesh.dp != 0:
        raise ValueError(f"height {height} not divisible by dp={mesh.dp}")
    if spp % mesh.sp != 0:
        raise ValueError(f"spp {spp} not divisible by sp={mesh.sp}")


def shard_generator(mesh: Mesh, gen_or_seed: GenOrSeed, device) -> torch.Generator:
    """This rank's generator (module docstring); ``None`` is seed 0."""
    if mesh.size == 1 and isinstance(gen_or_seed, torch.Generator):
        return gen_or_seed
    if isinstance(gen_or_seed, torch.Generator):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen_or_seed,
                                 device=gen_or_seed.device))
    else:
        seed = int(gen_or_seed or 0)
    if mesh.size > 1:
        seed = fold_seed(fold_seed(seed, mesh.dp_idx), mesh.sp_idx)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def fold_ranks(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum of ``t`` over the ``n`` ranks of ``group``, added in rank
    order on every rank (an all-gather, then a left fold); ``t`` itself
    without a group or on one rank."""
    if group is None or n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class _SampleMean(torch.autograd.Function):
    """Mean over the ``sp`` group.  Its backward passes ``grad / sp`` to
    this rank's own samples only; the gradients of replicated parameters
    are summed over the mesh after ``backward`` (``models/optimize``)."""

    @staticmethod
    def forward(ctx, rad, mesh):
        ctx.sp = mesh.sp
        return fold_ranks(rad, mesh.sp_group, mesh.sp) / mesh.sp

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.sp, None


def shard_target_image(mesh: Mesh, target: torch.Tensor) -> torch.Tensor:
    """This rank's rows of an image ``[H, ...]`` (a target for the loss)."""
    h = target.shape[0] // mesh.dp
    return target[mesh.dp_idx * h:(mesh.dp_idx + 1) * h]


def gather_image(mesh: Mesh, rows: torch.Tensor) -> torch.Tensor:
    """The whole image from every row block (an all-gather over ``dp``)."""
    if mesh.dp_group is None or mesh.dp == 1:
        return rows
    parts = [torch.empty_like(rows) for _ in range(mesh.dp)]
    dist.all_gather(parts, rows.contiguous(), group=mesh.dp_group)
    return torch.cat(parts, dim=0)


def render_rows(mesh: Mesh, radiance: Callable, geom, materials, env, camera,
                gen_or_seed: GenOrSeed = None, *, height: int, width: int, spp: int,
                uniforms: Optional[torch.Tensor] = None,
                light_uniforms: Optional[torch.Tensor] = None,
                key: Optional[torch.Tensor] = None, **kwargs) -> torch.Tensor:
    """This rank's rows ``[height / dp, width, 3]`` of the image, averaged
    over the ``sp`` group; ``radiance(geom, materials, env, ray_o, ray_d,
    gen, spp=, uniforms=, light_uniforms=, key=, **kwargs)`` renders a ray
    batch (the forward estimator or the replay).  ``key`` (the key words
    of the one rank's generator, ``ops/rng.key_from_generator``) stands in
    for ``gen_or_seed`` on a one-rank mesh."""
    _check_shape(mesh, height, spp)
    if key is not None and mesh.size > 1:
        raise ValueError("key names one rank's stream: give a mesh of several ranks a "
                         "generator or a seed")
    h, spp_l = height // mesh.dp, spp // mesh.sp
    ray_o, ray_d = camera_rays(camera.position, camera.rotation_deg, camera.fov_deg,
                               height, width)
    px = slice(mesh.dp_idx * h * width, (mesh.dp_idx + 1) * h * width)
    ss = slice(mesh.sp_idx * spp_l, (mesh.sp_idx + 1) * spp_l)
    cut = lambda u: None if u is None else u[ss, :, px]
    gen = (None if uniforms is not None or key is not None
           else shard_generator(mesh, gen_or_seed, ray_o.device))
    rad = radiance(geom, materials, env, ray_o[px], ray_d[px], gen, spp=spp_l,
                   uniforms=cut(uniforms), light_uniforms=cut(light_uniforms), key=key, **kwargs)
    return _SampleMean.apply(rad, mesh).reshape(h, width, 3)


def render_radiance_sharded(mesh: Mesh, geom, materials, env, camera,
                            gen_or_seed: GenOrSeed = None, *, height: int, width: int,
                            spp: int, max_bounce: int, gather: bool = False,
                            **kwargs) -> torch.Tensor:
    """Radiance rendered over ``mesh``: this rank's rows ``[height / dp,
    width, 3]``, or with ``gather=True`` the whole image on every rank.
    ``height`` must divide by ``dp`` and ``spp`` by ``sp``; other keyword
    arguments as ``models/pathtracer.radiance_for_rays`` (``lights`` are
    replicated)."""
    # imported here: models/__init__ imports models/optimize, which imports
    # this module
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import radiance_for_rays

    rows = render_rows(mesh, radiance_for_rays, geom, materials, env, camera, gen_or_seed,
                       height=height, width=width, spp=spp, max_bounce=max_bounce, **kwargs)
    return gather_image(mesh, rows) if gather else rows


def make_sharded_renderer(mesh: Mesh, *, height: int, width: int, spp: int, max_bounce: int,
                          sun_enabled: bool = True, ibl_bilinear: bool = True, **kwargs):
    """``fn(geom, materials, env, camera, gen_or_seed) -> rows``: the
    sharded render at fixed settings, leaving the image sharded over
    ``dp``; ``kwargs`` (``lights``, ``nee``, ``glass_mode``, ``mis``) as
    ``models/pathtracer.radiance_for_rays``.

    On a one-rank mesh ``fn`` is the counterpart of the JAX package's
    jitted function: a captured CUDA graph of the render on the card
    (``utils/graphs.Graphed``; the geometry pack and the IBL read in place,
    the other tensors copied in, the key words drawn from this rank's generator
    before the replay), eager on the CPU; ``fn.graph`` is its ``Graphed``
    and ``fn.eager`` the same render without a graph.  A mesh of several
    ranks renders eagerly: its collectives stay outside any graph."""
    render = functools.partial(render_radiance_sharded, mesh, height=height, width=width,
                               spp=spp, max_bounce=max_bounce, sun_enabled=sun_enabled,
                               ibl_bilinear=ibl_bilinear, **kwargs)
    if mesh.size > 1:
        return render
    graphed = Graphed(render, in_place=("geom", "env.ibl"))

    def fn(geom, materials, env, camera, gen_or_seed=None):
        dev = geom.v0.device
        key = key_from_generator(shard_generator(mesh, gen_or_seed, dev), dev)
        return graphed(geom, materials, env, camera, key=key)

    fn.graph, fn.eager = graphed, render  # the captures, and the render without a graph
    return fn
