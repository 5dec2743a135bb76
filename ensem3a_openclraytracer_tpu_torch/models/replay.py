"""Path-replay differentiable rendering: trace once, differentiate a
shading-only replay.

Counterpart of the JAX package's ``models/replay.py``.  Visibility is not
differentiable (every trace takes detached rays), so the discrete path
structure can be recorded once and the radiance recomputed from it:

  1. **Record** (no gradient): per (sample, bounce, ray) the uniforms and
     the hit / sun-occluder triangle (-1 for a miss), plus, with NEE, the
     light uniforms, the shadow ray's visibility bit and the hit distance.
     Bounce directions depend on uniforms and geometry only, so the
     records hold for every value of the differentiable parameters.
  2. **Replay** (autograd): the scan estimator's shading, bounce for
     bounce, with each hit read from the records instead of traced.  Its
     backward pass runs no trace.

Two recorders: the scan recorder (:func:`record_paths` with
``fused=False``: the port's scan estimator's bounce loop, every trace
through ``ops/closest_hit.trace``) and the fused recorder
(:func:`record_paths_fused`: one ``ops/fused.sample_fused(record=True)``
launch per sample, tint glass, no NEE).  ``fused=None`` takes the fused
recorder on the card without NEE, explicit uniforms or refract glass, the
scan recorder otherwise and always on the CPU.

Random numbers: explicit ``uniforms [spp, max_bounce+1, N, 2]`` (and
``light_uniforms [..., 3]`` with NEE), or the scan estimator's Philox
stream under ``key`` (``ops/rng.py``): sample ``s`` takes
``uniforms(key, (max_bounce+1, N, n_u), s0 + s)``, ``n_u`` 2, or 5 with
NEE (the bounce's two, then the light's three).  The fused recorder's
kernels draw the same stream in Morton-permuted lane order, and its
records are scattered back to pixel order.  So on the same key the replay
is the scan estimator and, through the fused recorder, the fused forward
engine (to float order).

The records take 16 bytes per (sample, bounce, ray), 36 with NEE; a
512^2, 100-sample, 5-vertex render records 2.1 GB.
:func:`radiance_for_rays_replay` splits the samples into chunks when the
records would pass a quarter of the card's memory, and replays each chunk
under ``torch.utils.checkpoint``: its backward pass records the chunk
again from the same key and sample offset, which gives the same records
bit for bit (every trace is exact).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ensem3a_openclraytracer_tpu_torch.models.pathtracer import _gather_surface, fused_by_default
from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
from ensem3a_openclraytracer_tpu_torch.ops import fused as fused_ops
from ensem3a_openclraytracer_tpu_torch.ops import rng
from ensem3a_openclraytracer_tpu_torch.ops.bsdf import (
    EMISSIVE,
    GLASS,
    GLOSSY,
    eval_ggx,
    eval_lambert,
    sample_bounce,
)
from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays
from ensem3a_openclraytracer_tpu_torch.ops.envmap import sample_ibl, sun_direction
from ensem3a_openclraytracer_tpu_torch.ops.gathers import gather_rows
from ensem3a_openclraytracer_tpu_torch.ops.geometry import sample_point_in_triangle, select
from ensem3a_openclraytracer_tpu_torch.scene.materials import (
    CameraParams,
    EnvParams,
    MaterialParams,
)
from ensem3a_openclraytracer_tpu_torch.scene.scene import GeometryPack, LightPack


# Escapes per environment pass of the replay (a group of samples): bounds the
# lookup's intermediates, about 13 floats per escape while a pass runs.
ENV_LANES = 1 << 21


class PathRecords(NamedTuple):
    """Discrete path structure of ``spp`` samples of ``N`` rays, in pixel
    order.  ``tri`` and ``sun_tri`` are -1 for a miss (``sun_tri`` all -1
    without sun); indices are rows of the packed geometry.  The last four
    fields exist for NEE records only: the replay rebuilds hit positions
    from ``t``/``primary_t`` and reads shadow-ray visibility from
    ``light_vis``."""

    u: torch.Tensor  # [spp, B+1, N, 2] float32 bounce uniforms
    tri: torch.Tensor  # [spp, B+1, N] int32 bounce-segment hit
    sun_tri: torch.Tensor  # [spp, B+1, N] int32 sun-shadow occluder
    primary_tri: torch.Tensor  # [N] int32 cached primary hit
    light_u: Optional[torch.Tensor] = None  # [spp, B+1, N, 3] NEE uniforms
    light_vis: Optional[torch.Tensor] = None  # [spp, B+1, N] bool shadow-ray visibility
    t: Optional[torch.Tensor] = None  # [spp, B+1, N] float32 bounce hit distance
    primary_t: Optional[torch.Tensor] = None  # [N] float32 primary hit distance


def _check_stream(key, uniforms, nee, light_uniforms):
    if uniforms is None:
        if key is None:
            raise ValueError("give uniforms [spp, max_bounce + 1, N, 2] or a Philox key")
        rng._check_key(key)
    elif nee and light_uniforms is None:
        raise ValueError("nee with an explicit uniform stream also needs light_uniforms "
                         "[spp, max_bounce + 1, N, 3]")


def record_paths_fused(geom: GeometryPack, materials: MaterialParams, env: EnvParams,
                       ray_o: torch.Tensor, ray_d: torch.Tensor, key: torch.Tensor, *, spp: int,
                       max_bounce: int, sun_enabled: bool, s0: int = 0) -> PathRecords:
    """Record paths on the fused kernels: one
    ``ops/fused.sample_fused(record=True)`` launch per sample ``s0 + s``
    (``csrc/fused_sample.cu`` on one block, ``csrc/fused_queue.cu`` on
    more), on the arguments of ``ops/fused.fused_args``.  Multi-block
    scenes permute the lanes by Morton order there, and the kernels' stream
    indexes lanes by position, so the records are scattered back to pixel
    order.  BSDF only, tint glass, the Philox stream of ``key``; on the
    CPU the kernels' plain versions run.  A failed launch raises."""
    rng._check_key(key)
    n = ray_o.shape[0]
    mb1 = max_bounce + 1
    dev = ray_o.device
    with torch.no_grad():
        hit = ch.trace(geom, ray_o, ray_d)
        surf = _gather_surface(geom, materials, ray_o, ray_d, hit)
        args, order = fused_ops.fused_args(geom, materials, env, ray_o, ray_d, hit, surf)
        u = torch.empty((spp, mb1, n, 2), dtype=torch.float32, device=dev)
        tri = torch.empty((spp, mb1, n), dtype=torch.int32, device=dev)
        sun_tri = torch.full((spp, mb1, n), -1, dtype=torch.int32, device=dev)
        for s in range(spp):
            out = fused_ops.sample_fused(*args, key, s0 + s, max_bounce=max_bounce,
                                         sun_enabled=sun_enabled, record=True)
            recs = ((u, out[3]), (tri, out[4])) + (((sun_tri, out[5]),) if sun_enabled else ())
            for dst, src in recs:
                if order is None:
                    dst[s].copy_(src)
                else:  # lane j holds ray order[j]
                    dst[s].index_copy_(1, order, src)
        primary_tri = torch.where(hit.hit, hit.tri, -1).to(torch.int32)
    return PathRecords(u=u, tri=tri, sun_tri=sun_tri, primary_tri=primary_tri)


def record_paths(geom: GeometryPack, materials: MaterialParams, env: EnvParams,
                 ray_o: torch.Tensor, ray_d: torch.Tensor, key: Optional[torch.Tensor] = None, *,
                 spp: int, max_bounce: int, sun_enabled: bool,
                 uniforms: Optional[torch.Tensor] = None, glass_mode: str = "tint",
                 fused: Optional[bool] = None, nee: bool = False,
                 lights: Optional[LightPack] = None,
                 light_uniforms: Optional[torch.Tensor] = None, s0: int = 0) -> PathRecords:
    """Trace every path once, with no gradient.  Only geometry-derived
    state (positions, normals, material types, ior) steers the recorder,
    so the records serve every value of colors, roughness and powers.

    ``nee=True`` (with ``lights``) adds per vertex the light uniforms, the
    shadow ray's visibility bit and the bounce hit distances, so the
    replayed NEE estimator is the scan estimator's.  ``fused`` picks the
    recorder (module docstring); ``fused=True`` refuses NEE, explicit
    uniforms and refract glass.  ``s0`` offsets the sample index of the
    ``key`` stream (a chunk of a longer render)."""
    if nee and lights is None:
        raise ValueError("nee=True requires a LightPack")
    _check_stream(key, uniforms, nee, light_uniforms)
    dev = ray_o.device
    if fused is None:
        fused = not nee and fused_by_default(geom, dev, uniforms=uniforms, glass_mode=glass_mode)
    if fused:
        if nee:
            raise ValueError("the fused recorder has no NEE mode")
        if uniforms is not None or glass_mode != "tint":
            raise ValueError("the fused recorder supports the tint-glass path with its own random "
                             "stream (no explicit uniforms)")
        return record_paths_fused(geom, materials, env, ray_o, ray_d, key, spp=spp,
                                  max_bounce=max_bounce, sun_enabled=sun_enabled, s0=s0)
    n = ray_o.shape[0]
    mb1 = max_bounce + 1
    n_lights = 0 if lights is None else lights.v0.shape[0]
    with torch.no_grad():
        midx = geom.mat.to(torch.int64)
        mtype_pf = materials.mtype[midx]
        ior_pf = materials.ior[midx]

        def surf_of(origin, direction, t, tri):
            i = torch.clamp(tri, min=0).to(torch.int64)
            return origin + direction * t[:, None], geom.n[i], mtype_pf[i], ior_pf[i]

        primary = ch.trace(geom, ray_o, ray_d)
        primary_tri = torch.where(primary.hit, primary.tri, -1).to(torch.int32)
        sun_dir = sun_direction(env.sun_angles_deg).expand(n, 3).contiguous()
        u_rec = torch.empty((spp, mb1, n, 2), dtype=torch.float32, device=dev)
        tri_rec = torch.empty((spp, mb1, n), dtype=torch.int32, device=dev)
        sun_rec = torch.full((spp, mb1, n), -1, dtype=torch.int32, device=dev)
        if nee:
            lu_rec = torch.empty((spp, mb1, n, 3), dtype=torch.float32, device=dev)
            vis_rec = torch.empty((spp, mb1, n), dtype=torch.bool, device=dev)
            t_rec = torch.empty((spp, mb1, n), dtype=torch.float32, device=dev)

        for s in range(spp):
            if uniforms is None:
                u = rng.uniforms(key, (mb1, n, 5 if nee else 2), s0 + s)
                us, uls = u[..., :2], (u[..., 2:] if nee else None)
            else:
                us, uls = uniforms[s], (light_uniforms[s] if nee else None)
            u_rec[s] = us
            if nee:
                lu_rec[s] = uls
            p, nrm, mt, ior = surf_of(ray_o, ray_d, primary.t, primary_tri)
            in_dir, live = ray_d, primary.hit
            for j in range(mb1):
                live = live & (mt != EMISSIVE)
                if nee:  # the shadow ray of pathtracer's nee_contribution, every lane
                    ul = uls[j]
                    li = torch.clamp((ul[:, 0] * n_lights).to(torch.int64), 0, n_lights - 1)
                    x = sample_point_in_triangle(lights.v0[li], lights.v1[li], lights.v2[li],
                                                 ul[:, 1], ul[:, 2])
                    delta = x - p
                    dist = torch.sqrt(torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-8))
                    sh = ch.trace(geom, p, delta / dist[:, None])
                    vis_rec[s, j] = sh.t >= dist * (1.0 - 1e-3)
                # directions only: sample_bounce's direction never reads color or roughness
                zero3 = torch.zeros_like(p)
                bdir, _ = sample_bounce(mt, zero3, zero3[:, 0], in_dir, nrm, us[j, :, 0],
                                        us[j, :, 1], ior=ior, glass_mode=glass_mode)
                h = ch.trace(geom, p, bdir)
                tri = torch.where(h.hit, h.tri, -1).to(torch.int32)
                tri_rec[s, j] = tri
                if nee:
                    t_rec[s, j] = h.t
                if sun_enabled:
                    sh = ch.trace(geom, p, sun_dir)
                    sun_rec[s, j] = torch.where(sh.hit, sh.tri, -1).to(torch.int32)
                live = live & h.hit
                np_, nn, nmt, nior = surf_of(p, bdir, h.t, tri)
                p = select(live, np_, p)
                nrm = select(live, nn, nrm)
                mt = torch.where(live, nmt, mt)
                ior = torch.where(live, nior, ior)
                in_dir = select(live, bdir, in_dir)
    return PathRecords(
        u=u_rec, tri=tri_rec, sun_tri=sun_rec, primary_tri=primary_tri,
        light_u=lu_rec if nee else None, light_vis=vis_rec if nee else None,
        t=t_rec if nee else None, primary_t=primary.t if nee else None,
    )


def replay_radiance(records: PathRecords, geom: GeometryPack, materials: MaterialParams,
                    env: EnvParams, ray_d: torch.Tensor, *, sun_enabled: bool,
                    ibl_bilinear: bool = True, glass_mode: str = "tint", nee: bool = False,
                    lights: Optional[LightPack] = None,
                    ray_o: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable radiance ``[N, 3]`` from recorded paths: gathers and
    elementwise math, no intersection test.  The scan estimator bounce for
    bounce (``models/pathtracer.radiance_for_rays``), its hits read from
    the records.

    One per-face table ``[T, 9]`` (normal and material type detached;
    color, roughness, ior) serves every gather.  Each sample's replay runs
    under ``torch.utils.checkpoint``, so the backward pass recomputes the
    sample instead of keeping every bounce's intermediates.  A path
    escapes at most once, so each sample emits an escape record
    ``(throughput, direction, sun occluder, glass)``, and after the sample
    loop batched IBL lookups and sun-occluder gathers of ``ENV_LANES``
    escapes at a time (under ``torch.utils.checkpoint`` too) settle them:
    the IBL texel gradient is one scatter-add per batch, not one per
    sample and bounce.  Every differentiable gather is
    ``ops/gathers.gather_rows``.  With NEE the light power is read from
    ``materials.roughness[lights.mat]``, so emissive-power gradients
    flow."""
    if nee and (lights is None or ray_o is None or records.light_u is None):
        raise ValueError("nee replay needs a LightPack, ray_o, and NEE records "
                         "(record_paths(..., nee=True, lights=...))")
    n_rays = ray_d.shape[0]
    spp, mb1 = records.u.shape[0], records.u.shape[1]
    n_lights = 0 if lights is None else lights.v0.shape[0]
    midx = geom.mat.to(torch.int64)
    face_tab = torch.cat([
        geom.n.detach(),  # 0:3 shading normal
        materials.mtype.detach().to(torch.float32)[midx][:, None],  # 3 material type
        gather_rows(materials.color, midx),  # 4:7
        gather_rows(materials.roughness, midx)[:, None],  # 7 (emissive power for type 0)
        materials.ior.detach()[midx][:, None],  # 8
    ], dim=1)
    if nee:  # d/d(emissive power) flows
        lpow_tab = gather_rows(materials.roughness, lights.mat.to(torch.int64))

    def surf_of(tri):
        rows = gather_rows(face_tab, torch.clamp(tri, min=0))
        return (rows[:, 0:3], torch.round(rows[:, 3]).to(torch.int32), rows[:, 4:7], rows[:, 7],
                rows[:, 8])

    def env_radiance(d):
        return sample_ibl(env.ibl, d, bilinear=ibl_bilinear) * env.ibl_power

    primary_live = records.primary_tri >= 0
    zero3 = torch.zeros_like(ray_d)
    primary_miss_rad = select(primary_live, zero3, env_radiance(ray_d))
    prim = surf_of(records.primary_tri)
    if nee:
        p0 = ray_o + ray_d * torch.where(primary_live, records.primary_t, 0.0)[:, None]
    else:
        p0 = zero3  # positions are read by NEE only

    def one_sample(us, tris, suns, uls, viss, ts):
        live, thr, rad, in_dir, p = (primary_live, torch.ones_like(ray_d), primary_miss_rad,
                                     ray_d, p0)
        n, mt, col, rough, ior = prim
        emit_ok = torch.ones_like(live)
        esc_thr = zero3
        esc_dir = torch.zeros_like(ray_d)
        esc_dir[:, 2] = 1.0  # keeps the IBL lookup NaN-free; made on the device for graphs
        esc_sun = torch.full((n_rays,), -1, dtype=torch.int32, device=ray_d.device)
        esc_glass = torch.zeros_like(live)
        for j in range(mb1):
            emis = live & (mt == EMISSIVE)
            rad = rad + select(emis & emit_ok, thr * rough[:, None], zero3)
            live = live & ~emis
            if nee:  # direct light at this vertex, visibility from the record
                ul = uls[j]
                li = torch.clamp((ul[:, 0] * n_lights).to(torch.int64), 0, n_lights - 1)
                x = sample_point_in_triangle(lights.v0[li], lights.v1[li], lights.v2[li],
                                             ul[:, 1], ul[:, 2])
                delta = (x - p).detach()
                dist2 = torch.clamp(torch.sum(delta * delta, dim=-1), min=1e-8)
                ldir = delta / torch.sqrt(dist2)[:, None]
                cos_s = torch.sum(ldir * n, dim=-1)
                cos_l = torch.abs(torch.sum(ldir * lights.n[li], dim=-1))
                brdf = select(mt == GLOSSY, eval_ggx(col, rough, -in_dir, ldir, n),
                              eval_lambert(col))
                weight = (n_lights * lights.area[li]) * cos_l / dist2
                sampled = live & (mt != EMISSIVE) & (mt != GLASS)
                ok = sampled & viss[j] & (cos_s > 0.0) & (cos_l > 1e-6)
                lpow = gather_rows(lpow_tab, li)
                contrib = thr * brdf * (torch.clamp(cos_s, min=0.0) * weight * lpow)[:, None]
                rad = rad + select(ok, contrib, zero3)
                emit_ok = torch.where(live, ~sampled, emit_ok)
            bdir, factor = sample_bounce(mt, col, rough, in_dir, n, us[j, :, 0], us[j, :, 1],
                                         ior=ior, glass_mode=glass_mode)
            thr = select(live, thr * factor, thr)
            hit = tris[j] >= 0
            miss = live & ~hit
            esc_thr = select(miss, thr, esc_thr)
            esc_dir = select(miss, bdir, esc_dir)
            esc_sun = torch.where(miss, suns[j], esc_sun)
            esc_glass = torch.where(miss, mt == GLASS, esc_glass)
            live = live & hit
            nn, nmt, ncol, nrough, nior = surf_of(tris[j])
            if nee:
                p = select(live, p + bdir * ts[j][:, None], p)
            n = select(live, nn, n)
            mt = torch.where(live, nmt, mt)
            col = select(live, ncol, col)
            rough = torch.where(live, nrough, rough)
            ior = torch.where(live, nior, ior)
            in_dir = select(live, bdir, in_dir)
        final_emis = live & (mt == EMISSIVE) & emit_ok
        rad = rad + select(final_emis, thr * rough[:, None], zero3)
        return rad, esc_thr, esc_dir, esc_sun, esc_glass

    grad = torch.is_grad_enabled()
    acc = zero3
    escapes = []
    for s in range(spp):
        xs = (records.u[s], records.tri[s], records.sun_tri[s],
              *((records.light_u[s], records.light_vis[s], records.t[s]) if nee else (None,) * 3))
        out = (checkpoint(one_sample, *xs, use_reentrant=False, preserve_rng_state=False) if grad
               else one_sample(*xs))
        acc = acc + out[0]
        escapes.append(out[1:])

    def escape_radiance(*recs):
        """Sum over a group of samples of each escape's throughput times
        its environment light: one IBL lookup and one sun-occluder
        gather for the group."""
        thr, esc_dir, esc_sun, esc_glass = (torch.cat(recs[i::4]) for i in range(4))
        light = env_radiance(esc_dir)
        if sun_enabled:
            s_hit = esc_sun >= 0
            _, s_mt, s_col, _, _ = surf_of(esc_sun)
            unocc = (~s_hit) & ~esc_glass
            glass_occ = s_hit & (s_mt == GLASS)
            light = light + (unocc[:, None].to(torch.float32) * env.sun_power
                             + glass_occ[:, None].to(torch.float32) * s_col * env.sun_power)
        return (thr * light).reshape(-1, n_rays, 3).sum(dim=0)

    # the environment after the sample loop, ENV_LANES escapes at a time, each group under
    # checkpoint: its lookup's intermediates live only while the group is computed
    per = max(1, ENV_LANES // max(n_rays, 1))
    esc_rad = zero3
    for g0 in range(0, spp, per):
        recs = [x for rec in escapes[g0:g0 + per] for x in rec]
        esc_rad = esc_rad + (checkpoint(escape_radiance, *recs, use_reentrant=False,
                                        preserve_rng_state=False) if grad
                             else escape_radiance(*recs))
    # primary_miss_rad is inside every sample's carry, as in the scan estimator
    return (acc + esc_rad) / spp


def _chunk_divisor(spp: int, target: int) -> int:
    """Largest divisor of ``spp`` that is <= ``target`` (>= 1)."""
    c = max(1, min(spp, target))
    while spp % c:
        c -= 1
    return c


def record_budget_bytes(device) -> int:
    """Record memory one spp chunk may take: a quarter of the card's
    memory (``torch.cuda.mem_get_info``), 3 GB on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 3 << 30
    return _card_budget(dev.index if dev.index is not None else torch.cuda.current_device())


@functools.cache
def _card_budget(index: int) -> int:
    return torch.cuda.mem_get_info(index)[1] // 4


def radiance_for_rays_replay(
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
    glass_mode: str = "tint",
    fused: Optional[bool] = None,
    spp_chunk: Optional[int] = None,
    nee: bool = False,
    lights: Optional[LightPack] = None,
    light_uniforms: Optional[torch.Tensor] = None,
    key: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Differentiable counterpart of ``radiance_for_rays(..., fused=False)``:
    the same estimator and, without explicit uniforms, the same Philox
    stream (two key words drawn from ``gen``, seed 0 when None, or given
    as ``key``), but the backward pass never traces.  ``nee=True`` (with
    ``lights``) records shadow-ray visibility and replays the NEE
    estimator.

    ``spp_chunk`` bounds the live record memory: samples are recorded and
    replayed ``spp_chunk`` at a time under ``torch.utils.checkpoint``, and
    the backward pass records each chunk again (same key, same sample
    offsets).  By default the samples are chunked only when one pass's
    records (16 bytes per ray, sample and bounce; 36 with NEE) would pass
    :func:`record_budget_bytes`; explicit streams are cut along with the
    samples."""
    dev = ray_o.device
    n_rays = ray_o.shape[0]
    if key is not None and gen is not None:
        raise ValueError("give one random source: gen or key")
    if uniforms is None and key is None:
        key = rng.key_from_generator(gen, dev)
    if spp_chunk is None:
        per_sample = n_rays * (max_bounce + 1) * (36 if nee else 16)
        spp_chunk = max(1, record_budget_bytes(dev) // per_sample)
    spp_chunk = _chunk_divisor(spp, spp_chunk)

    def run(s0, ns):
        u = None if uniforms is None else uniforms[s0:s0 + ns]
        lu = None if light_uniforms is None else light_uniforms[s0:s0 + ns]
        records = record_paths(
            geom, materials, env, ray_o, ray_d, key, spp=ns, max_bounce=max_bounce,
            sun_enabled=sun_enabled, uniforms=u, glass_mode=glass_mode, fused=fused, nee=nee,
            lights=lights, light_uniforms=lu, s0=s0)
        return replay_radiance(records, geom, materials, env, ray_d, sun_enabled=sun_enabled,
                               ibl_bilinear=ibl_bilinear, glass_mode=glass_mode, nee=nee,
                               lights=lights, ray_o=ray_o)

    if spp_chunk >= spp:
        return run(0, spp)
    chunk_sum = lambda s0: run(s0, spp_chunk) * spp_chunk
    acc = torch.zeros_like(ray_d)
    for s0 in range(0, spp, spp_chunk):
        if torch.is_grad_enabled():
            acc = acc + checkpoint(chunk_sum, s0, use_reentrant=False, preserve_rng_state=False)
        else:
            acc = acc + chunk_sum(s0)
    return acc / spp


def render_radiance_replay(geom: GeometryPack, materials: MaterialParams, env: EnvParams,
                           camera: CameraParams, gen: Optional[torch.Generator] = None, *,
                           height: int, width: int, **kwargs) -> torch.Tensor:
    """Differentiable radiance image ``[height, width, 3]`` by path replay;
    keyword arguments as :func:`radiance_for_rays_replay`."""
    ray_o, ray_d = camera_rays(camera.position, camera.rotation_deg, camera.fov_deg,
                               height, width)
    rad = radiance_for_rays_replay(geom, materials, env, ray_o, ray_d, gen, **kwargs)
    return rad.reshape(height, width, 3)
