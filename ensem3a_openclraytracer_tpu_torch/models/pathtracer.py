"""Wavefront path tracer: the scan estimator.

Counterpart of the JAX package's ``models/pathtracer.py`` with
``fused=False``.  The whole image is one SoA ray batch; the bounce loop
and the loop over samples are Python loops over tensor operations, and
every closest-hit query goes through ``ops/closest_hit.trace`` (the CUDA
kernel on the card, the exact scan on the CPU).

Estimator (the reference's Raytracing.cl:39-221, with the JAX package's
additions):
  * the primary hit is traced once and reused by every sample;
  * unidirectional path tracing: lobe sampling as ``ops/bsdf``, paths
    still on a non-emissive surface after ``max_bounce`` bounces add 0;
  * an escaped path records its escape vertex; after the bounce loop one
    sun shadow ray per sample gives full sun when unoccluded and the
    escape vertex is not glass, tinted sun when glass occludes, and the
    lat-long IBL adds ``ibl_power * ibl(dir)``;
  * optional next-event estimation (``nee``) with binary emission
    suppression or the balance heuristic (``mis``), and Snell glass
    (``glass_mode="refract"``);
  * output: mean over spp (``render_image``/``render_scene`` clamp).

Engines: the scan estimator above, or the fused sample engine
(``ops/fused``), which adds the samples up inside its kernels: on a
one-block scene one CUDA kernel launch runs the whole render
(``render_fused_resident``: every sample's bounce loop, the IBL of each
escape and the sum over samples), on more blocks one launch per sample
runs its bounce loop, looks up the IBL of its escapes and adds it into
the running sum (``render_fused_queue``), with nothing between the
launches.  ``fused=None`` picks the fused engine for forward renders
on the card, without explicit uniforms, MIS, refraction or a tensor that
needs a gradient, at any number of triangle blocks
(:func:`fused_by_default`); the CPU stays on the scan path.

Random numbers: ``uniforms [spp, max_bounce+1, N, 2]`` (plus
``light_uniforms [..., 3]`` for NEE) from the caller, or the Philox
stream of ``ops/rng.py`` under two key words drawn from ``gen``: sample
``s`` takes ``uniforms(key, (max_bounce+1, N, n_u), s)`` with ``n_u`` 2,
or 5 with NEE (the bounce's two, then the light's three).  The fused
engine draws the same stream inside its kernel, with ``N`` indexed by
position in its (Morton-permuted, on multi-block scenes) batch.  Trace
outputs are detached; on the scan path material and environment tensors
stay live, so autograd reaches them.  The fused engine is forward-only.

Entry points: :func:`render_radiance` runs eagerly, as the JAX package's
un-jitted function does; :func:`render_radiance_jit`, its counterpart of
``jax.jit(render_radiance)``, replays a captured CUDA graph of the whole
render on the card (``utils/graphs.Graphed``: the geometry pack and the
IBL read in place, the other tensors copied in, the key words drawn from
``gen`` before the replay) and runs eagerly on the CPU.  :func:`render_scene`
calls it.

Tracing (``utils/profiling``, while a profiler records): spans
``render_scene`` (inside it ``render_scene.settings``: the settings, the
material, environment and camera tensors, the sun switch and the
generator; inside that, with NEE, ``render_scene.lights``: the light table
built on the host from the scene's faces and copied to the device) and
``render_radiance_jit`` (the key draw and ``Graphed``'s spans), none
inside the captured render.  A multi-block fused render gives
its sample launches one counter buffer (``ops/fused.render_stats``), which
:func:`render_radiance_jit` then keeps a clone of under ``"fused_queue"``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ensem3a_openclraytracer_tpu_torch.ops.bsdf import (
    EMISSIVE,
    GLASS,
    GLOSSY,
    eval_ggx,
    eval_lambert,
    sample_bounce,
)
from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays
from ensem3a_openclraytracer_tpu_torch.ops.closest_hit import resident, trace
from ensem3a_openclraytracer_tpu_torch.ops.envmap import sample_ibl, sun_direction
from ensem3a_openclraytracer_tpu_torch.ops import fused as fused_ops
from ensem3a_openclraytracer_tpu_torch.ops.gathers import gather_rows
from ensem3a_openclraytracer_tpu_torch.ops import rng
from ensem3a_openclraytracer_tpu_torch.ops.geometry import cross, sample_point_in_triangle, select
from ensem3a_openclraytracer_tpu_torch.ops.intersect import Hit
from ensem3a_openclraytracer_tpu_torch.ops.sampling import PI
from ensem3a_openclraytracer_tpu_torch.scene.materials import (
    CameraParams,
    EnvParams,
    MaterialParams,
)
from ensem3a_openclraytracer_tpu_torch.scene.scene import GeometryPack, LightPack
from ensem3a_openclraytracer_tpu_torch.utils import profiling
from ensem3a_openclraytracer_tpu_torch.utils.graphs import Graphed
from ensem3a_openclraytracer_tpu_torch.utils.profiling import span

class _Escape(NamedTuple):
    """Per-lane escape record: a path leaves the scene at most once."""

    escaped: torch.Tensor  # [N] bool
    p: torch.Tensor  # [N, 3] escape vertex (shadow-ray origin)
    dir: torch.Tensor  # [N, 3] escape direction (IBL lookup)
    thr: torch.Tensor  # [N, 3] throughput at escape
    glass: torch.Tensor  # [N] bool: escape vertex was glass (sun gate)


class _Surface(NamedTuple):
    """Per-lane shading state at the current path vertex."""

    p: torch.Tensor  # [N, 3] hit point
    n: torch.Tensor  # [N, 3] unit shading normal
    mtype: torch.Tensor  # [N] int32
    color: torch.Tensor  # [N, 3]
    rough: torch.Tensor  # [N] (emissive power for type 0)
    ior: torch.Tensor  # [N]


def _gather_surface(geom: GeometryPack, materials: MaterialParams, origin, direction,
                    hit: Hit) -> _Surface:
    midx = geom.mat[hit.tri].to(torch.int64)
    return _Surface(
        p=origin + direction * hit.t[:, None],
        n=geom.n[hit.tri],
        mtype=materials.mtype[midx],
        color=gather_rows(materials.color, midx),
        rough=gather_rows(materials.roughness, midx),
        ior=materials.ior[midx],
    )


def _needs_grad(*groups) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for g in groups if g is not None for t in g)


def fused_by_default(geom: GeometryPack, device, *, uniforms=None, glass_mode: str = "tint",
                     mis: bool = False, needs_grad: bool = False) -> bool:
    """The engine that ``fused=None`` picks: the fused engine for forward
    renders on the card of any scene with triangle features, unless the
    caller gives explicit uniforms, refract glass, MIS or a tensor that
    needs a gradient (the fused engine's refusals); the scan estimator
    otherwise, and always on the CPU.  The JAX package also caps the fused
    engine at 48 triangle blocks, a TPU rule that the port does not keep:
    on the card the fused engine beat the scan estimator at 47, 61 and 586
    blocks (PERF.md)."""
    return (torch.device(device).type == "cuda" and geom.feats is not None
            and uniforms is None and glass_mode == "tint" and not mis and not needs_grad)


def _fused_by_default(geom, materials, env, device, *, uniforms=None, glass_mode="tint",
                      mis=False, lights=None, **_) -> bool:
    """:func:`fused_by_default` for :func:`radiance_for_rays`' arguments."""
    return fused_by_default(geom, device, uniforms=uniforms, glass_mode=glass_mode, mis=mis,
                            needs_grad=_needs_grad(materials, env, lights))


def radiance_for_rays(
    geom: GeometryPack,
    materials: MaterialParams,
    env: EnvParams,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    *,
    spp: int,
    max_bounce: int,
    sun_enabled: bool = True,
    ibl_bilinear: bool = True,
    uniforms: Optional[torch.Tensor] = None,
    lights: Optional[LightPack] = None,
    nee: bool = False,
    fused: Optional[bool] = None,
    glass_mode: str = "tint",
    light_uniforms: Optional[torch.Tensor] = None,
    mis: bool = False,
    engine: str = "kernel",
    key: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Radiance ``[N, 3]`` of a primary-ray batch: the unclamped mean
    over ``spp`` samples.  ``fused`` picks the engine (module docstring;
    ``None`` chooses).  ``engine="plain"`` sends every kernel's work to
    its plain version even on the card (a reference for the kernels).
    ``key`` (``[2]`` int32, ``ops/rng.key_from_generator``) may stand in
    for ``gen``: the key words that ``gen`` would give.  Explicit
    ``uniforms`` take the place of both.  The fused engine renders every
    sample in one call, with the IBL of the escapes and the sum inside the
    kernels: ``render_fused_resident`` (one block), ``render_fused_queue``
    (more), or ``render_fused_plain`` for ``engine="plain"``."""
    if engine not in ("kernel", "plain"):
        raise ValueError(f"unknown engine {engine!r}")
    if key is not None and gen is not None:
        raise ValueError("give one random source: gen or key")
    if mis and not nee:
        raise ValueError("mis=True requires nee=True (and lights)")
    if nee and lights is None:
        raise ValueError("nee=True requires a LightPack")
    if nee and uniforms is not None and light_uniforms is None:
        raise ValueError(
            "nee with an explicit uniform stream also needs light_uniforms "
            "[spp, max_bounce + 1, N, 3]"
        )
    dev = ray_o.device
    n_rays = ray_o.shape[0]
    if fused is None:
        fused = _fused_by_default(geom, materials, env, dev, uniforms=uniforms,
                                  glass_mode=glass_mode, mis=mis, lights=lights)
    if fused:  # the JAX package's refusals
        if mis:
            raise ValueError("mis runs on the scan estimator (fused=False)")
        if geom.feats is None:
            raise ValueError("fused=True requires the triangle features (geom.feats)")
        if uniforms is not None or glass_mode != "tint":
            raise ValueError("fused=True supports the tint-glass path with its own random "
                             "stream (no explicit uniforms)")
        if _needs_grad(materials, env, lights):
            raise ValueError("the fused engine is forward-only: differentiate with fused=False")
    if uniforms is None and key is None:
        key = rng.key_from_generator(gen, dev)
    tr = lambda o, d: trace(geom, o, d, engine)

    primary_hit = tr(ray_o, ray_d)
    primary_surf = _gather_surface(geom, materials, ray_o, ray_d, primary_hit)
    sun_dir = sun_direction(env.sun_angles_deg).expand(n_rays, 3)

    def env_radiance(d):
        return sample_ibl(env.ibl, d, bilinear=ibl_bilinear) * env.ibl_power

    primary_miss_rad = select(primary_hit.hit, torch.zeros_like(ray_d), env_radiance(ray_d))

    if fused:
        # prepared once per render; multi-block scenes permute the rays by
        # the Morton order of their primary hit (one sort for every sample)
        f_args, order = fused_ops.fused_args(geom, materials, env, ray_o, ray_d, primary_hit,
                                             primary_surf)
        one = resident(geom.feats)  # the whole render in one launch, else one a sample
        run = (fused_ops.render_fused_plain if engine == "plain" else
               fused_ops.render_fused_resident if one else fused_ops.render_fused_queue)
        stats = None if one else fused_ops.render_stats(dev, max_bounce).zero_()  # 2b's counters
        acc = run(*f_args, key, 0, spp, ibl=env.ibl.contiguous(), ibl_power=env.ibl_power,
                  ibl_bilinear=ibl_bilinear, max_bounce=max_bounce, sun_enabled=sun_enabled,
                  nee=nee, lights=lights, stats=stats)
        if order is not None:
            acc = torch.empty_like(acc).index_copy_(0, order, acc)
        return acc / spp + primary_miss_rad

    n_lights = 0 if lights is None else lights.v0.shape[0]
    if mis:
        face_area = (0.5 * torch.linalg.norm(
            cross(geom.v1 - geom.v0, geom.v2 - geom.v0), dim=-1)).detach()

    def nee_contribution(live, thr, in_dir, surf, ul):
        """One shadow ray toward an area-sampled light point: the direct
        light of diffuse/glossy lanes (lights are double-sided)."""
        li = torch.clamp((ul[:, 0] * n_lights).to(torch.int64), 0, n_lights - 1)
        lmat = lights.mat[li].to(torch.int64)
        x = sample_point_in_triangle(lights.v0[li], lights.v1[li], lights.v2[li],
                                     ul[:, 1], ul[:, 2])
        ln, larea = lights.n[li], lights.area[li]
        lpow = gather_rows(materials.roughness, lmat)  # re-read so d/d(power) flows
        delta = x - surf.p
        dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-8)
        dist = torch.sqrt(dist2)
        ldir = (delta / dist[:, None]).detach()
        cos_s = torch.sum(ldir * surf.n, dim=-1)
        cos_l = torch.abs(torch.sum(ldir * ln, dim=-1))
        visible = tr(surf.p, ldir).t >= dist * (1.0 - 1e-3)
        is_glossy = surf.mtype == GLOSSY
        brdf = select(is_glossy, eval_ggx(surf.color, surf.rough, -in_dir, ldir, surf.n),
                      eval_lambert(surf.color))
        weight = (n_lights * larea) * cos_l / dist2
        sampled = live & (surf.mtype != EMISSIVE) & (surf.mtype != GLASS)
        ok = sampled & visible & (cos_s > 0.0) & (cos_l > 1e-6)
        contrib = thr * brdf * (torch.clamp(cos_s, min=0.0) * weight * lpow)[:, None]
        if mis:
            p_b = torch.where(is_glossy, torch.full_like(cos_s, 1.0 / (2.0 * PI)),
                              torch.clamp(cos_s, min=0.0) / PI)
            contrib = contrib / (1.0 + p_b * weight)[:, None]
        return select(ok, contrib, torch.zeros_like(contrib)), sampled

    def one_sample(us, uls):
        """One sample for every ray -> radiance [N, 3]."""
        live = primary_hit.hit
        thr = torch.ones_like(ray_d)
        rad = primary_miss_rad
        in_dir = ray_d
        surf = primary_surf
        emis_w = torch.ones_like(primary_hit.t)
        zeros3 = torch.zeros_like(ray_d)
        no = torch.zeros_like(primary_hit.hit)
        up = torch.zeros_like(ray_d)
        up[:, 2] = 1.0  # made on the device: a graph captures no copy from the host
        esc = _Escape(escaped=no, p=zeros3, dir=up, thr=zeros3, glass=no)
        sampled = None
        for j in range(max_bounce + 1):
            u1, u2 = us[j, :, 0], us[j, :, 1]
            emis = live & (surf.mtype == EMISSIVE)
            rad = rad + select(emis, thr * (surf.rough * emis_w)[:, None], zeros3)
            live = live & ~emis
            if nee:
                direct, sampled = nee_contribution(live, thr, in_dir, surf, uls[j])
                rad = rad + direct
                if not mis:
                    # suppress emission at the next vertex only when this
                    # vertex sampled the light (glass vertices never do)
                    emis_w = torch.where(live, 1.0 - sampled.to(emis_w.dtype), emis_w)
            bdir, factor = sample_bounce(surf.mtype, surf.color, surf.rough, in_dir, surf.n,
                                         u1, u2, ior=surf.ior, glass_mode=glass_mode)
            thr = select(live, thr * factor, thr)
            bh = tr(surf.p, bdir)
            miss = live & ~bh.hit
            esc = _Escape(
                escaped=esc.escaped | miss,
                p=select(miss, surf.p, esc.p),
                dir=select(miss, bdir, esc.dir),
                thr=select(miss, thr, esc.thr),
                glass=torch.where(miss, surf.mtype == GLASS, esc.glass),
            )
            live = live & bh.hit
            new_surf = _gather_surface(geom, materials, surf.p, bdir, bh)
            if mis:
                p_b = torch.where(surf.mtype == GLOSSY, torch.full_like(bh.t, 1.0 / (2.0 * PI)),
                                  torch.clamp(torch.sum(bdir * surf.n, dim=-1), min=0.0) / PI)
                cos_l = torch.abs(torch.sum(bdir * new_surf.n, dim=-1))
                p_nee_hit = (bh.t * bh.t) / (
                    n_lights * face_area[bh.tri] * torch.clamp(cos_l, min=1e-6))
                w_b = p_b / (p_b + p_nee_hit)
                emis_w = torch.where(live, torch.where(sampled, w_b, torch.ones_like(w_b)),
                                     emis_w)
            surf = _Surface(*(select(live, a, b) for a, b in zip(new_surf, surf)))
            in_dir = select(live, bdir, in_dir)

        # settle every escape at once: one sun shadow ray + one IBL lookup
        env_light = env_radiance(esc.dir)
        if sun_enabled:
            sun_hit = tr(esc.p, sun_dir)
            sun_midx = geom.mat[sun_hit.tri].to(torch.int64)
            unoccluded = (~sun_hit.hit) & ~esc.glass
            glass_occluded = sun_hit.hit & (materials.mtype[sun_midx] == GLASS)
            sun_color = gather_rows(materials.color, sun_midx)
            sun_light = (
                unoccluded[:, None].to(torch.float32) * env.sun_power
                + glass_occluded[:, None].to(torch.float32) * sun_color * env.sun_power
            )
        else:
            sun_light = torch.zeros_like(env_light)
        rad = rad + select(esc.escaped, esc.thr * (sun_light + env_light), zeros3)
        # a path whose last bounce landed on a light still contributes
        final_emis = live & (surf.mtype == EMISSIVE)
        return rad + select(final_emis, thr * (surf.rough * emis_w)[:, None], zeros3)

    acc = torch.zeros_like(ray_d)
    for s in range(spp):
        if uniforms is None:
            shape = (max_bounce + 1, n_rays, 5 if nee else 2)
            u = (rng.uniforms_plain if engine == "plain" else rng.uniforms)(key, shape, s)
            us, uls = u[..., :2], (u[..., 2:] if nee else None)
        else:
            us = uniforms[s]
            uls = light_uniforms[s] if nee else None
        acc = acc + one_sample(us, uls)
    return acc / spp


def render_radiance(
    geom: GeometryPack,
    materials: MaterialParams,
    env: EnvParams,
    camera: CameraParams,
    gen: Optional[torch.Generator] = None,
    *,
    height: int,
    width: int,
    **kwargs,
) -> torch.Tensor:
    """Radiance image ``[height, width, 3]`` (unclamped mean over spp) of a
    pinhole view; keyword arguments as :func:`radiance_for_rays`."""
    ray_o, ray_d = camera_rays(camera.position, camera.rotation_deg, camera.fov_deg,
                               height, width)
    rad = radiance_for_rays(geom, materials, env, ray_o, ray_d, gen, **kwargs)
    return rad.reshape(height, width, 3)


_RENDER_GRAPHS = Graphed(render_radiance, in_place=("geom", "env.ibl"))


def render_radiance_jit(
    geom: GeometryPack,
    materials: MaterialParams,
    env: EnvParams,
    camera: CameraParams,
    gen: Optional[torch.Generator] = None,
    *,
    height: int,
    width: int,
    **kwargs,
) -> torch.Tensor:
    """:func:`render_radiance` as one captured CUDA graph on the card, the
    counterpart of the JAX package's ``render_radiance_jit``: the first call
    with new Python settings (its ``static_argnames``: ``height``,
    ``width``, ``spp``, ``max_bounce``, ``sun_enabled``, ``ibl_bilinear``,
    ``nee``, ``fused``, ``glass_mode``, ``mis``), shapes, geometry pack or
    IBL renders eagerly and captures; later calls replay.  A graph goes,
    with its memory, when the pack or the IBL it reads is freed
    (``render_radiance_jit.graph.clear()`` drops them all).  The key words are
    drawn from ``gen`` (seed 0 when None) before the replay, so the same
    generator gives the same image bit for bit, graph or eager.  Forward
    only; on CPU tensors it runs :func:`render_radiance` eagerly."""
    with span("render_radiance_jit"):
        dev = geom.v0.device
        if kwargs.get("uniforms") is None and kwargs.get("key") is None:
            kwargs["key"] = rng.key_from_generator(gen, dev)
        out = _RENDER_GRAPHS(geom, materials, env, camera, height=height, width=width, **kwargs)
        if profiling.recording():
            _record_queue_stats(geom, materials, env, dev, kwargs)
        return out


def _record_queue_stats(geom, materials, env, dev, kwargs) -> None:
    """After a multi-block fused render, a device clone of 2b's counters
    (``ops/fused.render_stats``) into ``utils/profiling``'s record under
    ``"fused_queue"``."""
    fused = kwargs.get("fused")
    if fused is None:
        fused = _fused_by_default(geom, materials, env, dev, **kwargs)
    if not fused or resident(geom.feats):
        return
    max_bounce = kwargs["max_bounce"]
    stats = fused_ops.render_stats(dev, max_bounce, make=False)
    if stats is not None:
        profiling.record_counters("fused_queue", stats, fused_ops.queue_stats_fields(max_bounce))


render_radiance_jit.graph = _RENDER_GRAPHS  # its captures (utils/graphs.Graphed)


def render_image(*args, **kwargs) -> torch.Tensor:
    """Radiance clamped to [0, 1] (the reference's output stage,
    Raytracing.cl:216-219)."""
    return torch.clamp(render_radiance(*args, **kwargs), 0.0, 1.0)


def render_scene(scene, seed: int = 0, overrides: Optional[dict] = None) -> torch.Tensor:
    """Render a loaded ``Scene`` at its ini settings on the scene's
    device through :func:`render_radiance_jit`; ``overrides`` may set
    resolution, spp, max_bounce, nee, mis, glass_mode or fused.  Returns the
    clamped image ``[res, res, 3]``."""
    with span("render_scene"):
        with span("render_scene.settings"):
            overrides = overrides or {}
            rs = scene.config.render_settings()
            res = int(overrides.get("resolution", rs.resolution))
            spp = int(overrides.get("spp", rs.spp))
            max_bounce = int(overrides.get("max_bounce", rs.max_bounce))
            mis = bool(overrides.get("mis", False))
            nee = bool(overrides.get("nee", False)) or mis
            env = scene.env_params()
            materials = scene.material_params()
            camera = scene.camera_params()
            sun_enabled = float(env.sun_power) != 0.0
            lights = None
            if nee:
                with span("render_scene.lights"):
                    lights = scene.light_pack(materials)
                nee = lights is not None
            gen = torch.Generator(device=scene.device)
            gen.manual_seed(int(seed))
        radiance = render_radiance_jit(
            scene.geometry, materials, env, camera, gen,
            height=res, width=res, spp=spp, max_bounce=max_bounce, sun_enabled=sun_enabled,
            lights=lights, nee=nee, mis=mis and nee,
            glass_mode=str(overrides.get("glass_mode", "tint")), fused=overrides.get("fused"),
        )
        return torch.clamp(radiance, 0.0, 1.0)
