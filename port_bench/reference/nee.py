"""Next-event estimation written out plainly: what
``render_scene(scene, seed, overrides={"nee": True})`` renders.

``reference/render.py``'s estimator with one light sample at each vertex,
as the port's ``models/pathtracer.py`` (``nee_contribution`` :269-297 with
``mis`` off, the emission weight :316-321) and its fused engine
(``csrc/shading.cuh`` ``light_point`` / ``light_weight`` :92-140,
``csrc/fused_queue.cu`` ``shade_lane`` / ``resolve_lane``) compute it:

* the light table is the emissive faces (material type 0) in the
  triangle order of the scene (``scene/scene.py:224-234`` with
  ``build_light_pack`` :67-98): each face's vertices, unit normal and area
  from ``cross(v1 - v0, v2 - v0)`` in float32 on the host, and its power,
  the emissive material's roughness slot;
* random numbers: lane ``r`` at bounce ``b`` of sample ``s`` draws five
  elements from flat index ``(b N + r) 5`` of the Philox stream ``(key,
  s)`` (``models/pathtracer.py:35-41``): the bounce's two, then the
  light's three: ``u3`` picks light ``min(int(u3 L), L - 1)`` of ``L``,
  ``u4, u5`` a point uniform on it (``ops/geometry.sample_point_in_triangle``);
* a vertex that is live, not emissive and not glass samples the light: with
  ``ldir`` the unit direction to the point, ``dist2 = max(|x - p|^2,
  1e-8)``, ``cos_s = ldir . n`` and ``cos_l = |ldir . n_light|`` (lights are
  double-sided), where ``cos_s > 0`` and ``cos_l > 1e-6`` one shadow ray
  from ``p`` along ``ldir`` is traced, and if its closest hit is no nearer
  than ``dist (1 - 1e-3)`` (a miss reads ``MAX_DIST``; any triangle
  occludes, glass too) the vertex adds ``thr * brdf * cos_s * L * area *
  cos_l / dist2 * power``, ``brdf`` the vertex's GGX or Lambert toward
  ``ldir`` with ``thr`` before the bounce;
* binary suppression: emission that a vertex reaches adds only where the
  previous live vertex did not sample the light (a glass vertex does not,
  the camera counts as not sampling);
* lanes in pixel or Morton order as ``reference/render.fused_lane_order``
  says the program takes them; everything else as ``reference/render``.

Departures, each with no effect on the answer: the shadow rays are traced
after the light sample rather than with the bounce rays in one trace (the
kernel's slots ``n + i``); a lane that does not want the light traces
nothing rather than a ray read as a miss; the contribution is added where
the point is visible rather than multiplied by a visibility of 0 or 1.

``first_light`` plants the upstream ``sampleLight`` quirk (SURVEY.md 2.6):
every light sample takes light 0.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from port_bench.reference import philox, shading
from port_bench.reference.optimize_lanes import no_tf32
from port_bench.reference import render as bsdf
from port_bench.reference.render import LANES_PER_PASS, Primary, miss_radiance, params_of
from port_bench.reference.shading import EMISSIVE, GLASS, GLOSSY
from port_bench.reference.trace import closest_hit

N_U = 5  # uniforms a lane draws per bounce with NEE


class Lights(NamedTuple):
    """The emissive faces, one row each, in the scene's triangle order."""

    v0: torch.Tensor  # [L, 3]
    v1: torch.Tensor
    v2: torch.Tensor
    n: torch.Tensor  # [L, 3] unit normal
    area: torch.Tensor  # [L]
    power: torch.Tensor  # [L]


def light_table(scene) -> Optional[Lights]:
    """The scene's light table, or None where no face is emissive."""
    emissive = scene.mtype[scene.mat] == EMISSIVE
    idx = torch.nonzero(emissive).squeeze(1)
    if idx.numel() == 0:
        return None
    v0, v1, v2 = (x[idx].cpu().numpy() for x in (scene.v0, scene.v1, scene.v2))
    nrm = np.cross(v1 - v0, v2 - v0)
    area = 0.5 * np.linalg.norm(nrm, axis=-1)
    unit = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    dev = scene.v0.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return Lights(v0=t(v0), v1=t(v1), v2=t(v2), n=t(unit), area=t(area),
                  power=scene.rough[scene.mat[idx]].float())


def draws(key: torch.Tensor, sample: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """Elements ``first .. first + 4`` of each lane's sample stream: ``[..., 5]``
    float32 in [0, 1), each from its own Philox block (five elements span two)."""
    flat = first[..., None] + torch.arange(N_U, device=first.device)
    block = flat >> 2
    ctr = torch.stack([block, sample[..., None].expand_as(block), torch.zeros_like(block),
                       torch.zeros_like(block)], dim=-1)
    words = philox.philox4x32_10(ctr, key.to(torch.int64).expand(block.shape + (2,)))
    top = torch.gather(words, -1, (flat & 3)[..., None]).squeeze(-1) >> 8
    return top.to(torch.float32) * (1.0 / (1 << 24))


def radiance(scene, key: torch.Tensor, primary: Primary, pixels: torch.Tensor,
             lanes: torch.Tensor, samples: range, *, lights: Lights, dtype=torch.float32,
             counts: Optional[Dict[str, int]] = None, first_light: bool = False) -> torch.Tensor:
    """Sum over ``samples`` of the NEE radiance of ``pixels`` (``[P]``, lane
    ``lanes[pixels]``): ``[P, 3]`` float32.  ``counts`` receives the
    segments traced (bounce, NEE shadow and sun rays), the lanes shaded,
    the sun rays and the NEE shadow rays (``nee``)."""
    params = params_of(scene)
    color, rough = params["color"], params["rough"]
    ibl = params["ibl"].to(dtype)
    n_all = primary.o.shape[0]
    dev = primary.o.device
    p_count = pixels.shape[0]
    per_pass = max(1, LANES_PER_PASS // max(p_count, 1))
    sun_d = shading.sun_direction(scene.sun_angles).to(dtype)
    cast = (lambda x: x.to(dtype)) if dtype != torch.float32 else (lambda x: x)
    n_lights = lights.v0.shape[0]
    lv0, lv1, lv2, ln = (cast(x) for x in (lights.v0, lights.v1, lights.v2, lights.n))
    l_scale = cast(n_lights * lights.area)  # the pdf's inverse over the light's area
    l_power = cast(lights.power)
    acc = torch.zeros((p_count, 3), dtype=torch.float32, device=dev)
    s_list = list(samples)
    for g0 in range(0, len(s_list), per_pass):
        group = torch.as_tensor(s_list[g0:g0 + per_pass], dtype=torch.int64, device=dev)
        g = group.shape[0]
        pix = pixels.repeat(g)
        smp = group.repeat_interleave(p_count)
        lane = lanes[pixels].repeat(g)
        hit0 = primary.hit.hit[pix]
        tri0 = primary.hit.tri[pix]
        live = hit0
        emit_ok = torch.ones_like(live)
        p = cast(primary.p[pix])
        n = cast(scene.normal[tri0])
        mid = scene.mat[tri0]
        mtype, col, rgh = scene.mtype[mid], cast(color[mid]), cast(rough[mid])
        in_d = cast(primary.d[pix])
        thr = torch.ones_like(p)
        rad = torch.zeros_like(p)
        esc_thr = torch.zeros_like(p)
        esc_dir = torch.zeros_like(p)
        esc_dir[:, 2] = 1.0
        zero3 = torch.zeros_like(p)
        for b in range(scene.max_bounce + 1):
            u = cast(draws(key, smp, (b * n_all + lane) * N_U))
            emis = live & (mtype == EMISSIVE)
            rad = rad + torch.where((emis & emit_ok)[:, None], thr * rgh[:, None], zero3)
            live = live & ~emis
            # one light point, and its shadow ray where the vertex wants it
            li = torch.clamp((u[:, 2].float() * n_lights).to(torch.int64), 0, n_lights - 1)
            if first_light:
                li = torch.zeros_like(li)
            su = torch.sqrt(u[:, 3])
            x = lv0[li] + (lv1[li] - lv0[li]) * (1.0 - su)[:, None] + (lv2[li] - lv0[li]) * (
                u[:, 4] * su)[:, None]
            delta = x - p
            dist2 = torch.clamp(shading.dot(delta, delta), min=1e-8)
            dist = torch.sqrt(dist2)
            ldir = delta / dist[:, None]
            cos_s = shading.dot(ldir, n)
            cos_l = torch.abs(shading.dot(ldir, ln[li]))
            sampled = live & (mtype != GLASS)
            want = sampled & (cos_s > 0.0) & (cos_l > 1e-6)
            brdf = torch.where((mtype == GLOSSY)[:, None],
                               shading.eval_ggx(col, rgh, -in_d, ldir, n),
                               shading.eval_lambert(col))
            weight = l_scale[li] * cos_l / dist2
            contrib = thr * brdf * (torch.clamp(cos_s, min=0.0) * weight * l_power[li])[:, None]
            emit_ok = torch.where(live, ~sampled, emit_ok)
            widx = torch.nonzero(want).squeeze(1)
            sh = closest_hit(scene, p[widx].float(), ldir[widx].float(), dtype)
            seen = widx[sh.t >= dist[widx].float() * (1.0 - 1e-3)]
            rad = rad.index_add(0, seen, contrib[seen])
            if counts is not None:
                counts["segments"] += int(widx.numel())
                counts["nee"] += int(widx.numel())
            # the bounce
            bdir, factor = shading.sample_bounce(mtype, col, rgh, in_d, n, u[:, 0], u[:, 1])
            thr = torch.where(live[:, None], thr * factor, thr)
            idx = torch.nonzero(live).squeeze(1)
            h = closest_hit(scene, p[idx].float(), bdir[idx].float(), dtype)
            t = torch.full((live.shape[0],), 1000.0, device=dev).index_copy(0, idx, h.t)
            tri = torch.zeros_like(lane).index_copy(0, idx, h.tri)
            hit = torch.zeros_like(live).index_copy(0, idx, h.hit)
            miss = live & ~hit
            esc_thr = torch.where(miss[:, None], thr, esc_thr)
            esc_dir = torch.where(miss[:, None], bdir, esc_dir)
            if counts is not None:
                counts["segments"] += int(idx.numel())
                counts["lanes"] += int(idx.numel())
            if scene.sun_enabled:
                sidx = torch.nonzero(miss).squeeze(1)
                sun_rays = sun_d.float().expand(sidx.numel(), 3)
                s_hit = closest_hit(scene, p[sidx].float(), sun_rays, dtype)
                s_mid = scene.mat[s_hit.tri]
                unocc = (~s_hit.hit) & (mtype[sidx] != GLASS)
                glass_occ = s_hit.hit & (scene.mtype[s_mid] == GLASS)
                sun_pow = cast(params["sun_power"])
                light = (unocc[:, None].to(p.dtype) * sun_pow
                         + glass_occ[:, None].to(p.dtype) * cast(color[s_mid]) * sun_pow)
                rad = rad.index_add(0, sidx, thr[sidx] * light)
                if counts is not None:
                    counts["segments"] += int(sidx.numel())
                    counts["sun"] += int(sidx.numel())
            live = live & hit
            mid_new = scene.mat[tri]
            p = torch.where(live[:, None], p + bdir * cast(t)[:, None], p)
            n = torch.where(live[:, None], cast(scene.normal[tri]), n)
            mtype = torch.where(live, scene.mtype[mid_new], mtype)
            col = torch.where(live[:, None], cast(color[mid_new]), col)
            rgh = torch.where(live, cast(rough[mid_new]), rgh)
            in_d = torch.where(live[:, None], bdir, in_d)
        final = live & (mtype == EMISSIVE) & emit_ok
        rad = rad + torch.where(final[:, None], thr * rgh[:, None], zero3)
        env = shading.sample_ibl(ibl, esc_dir) * cast(params["ibl_power"])
        per_sample = (rad + esc_thr * env).float().reshape(g, p_count, 3)
        for j in range(g):
            acc = acc + per_sample[j]
    return acc


@torch.no_grad()
def render_pixels(scene, seed: int, pixels: torch.Tensor, *, morton: bool, dtype=torch.float32,
                  counts: Optional[Dict[str, int]] = None, primary: Optional[Primary] = None,
                  first_light: bool = False):
    """The clamped image at ``pixels`` of ``render_scene(scene, seed,
    overrides={"nee": True})``: ``[P, 3]`` float32, its matrix products in
    float32, not TF32.  A scene with no emissive face renders without NEE,
    as ``render_scene`` does."""
    lights = light_table(scene)
    with no_tf32():
        if lights is None:
            return bsdf.render_pixels(scene, seed, pixels, morton=morton, dtype=dtype,
                                      counts=counts, primary=primary)
        primary = Primary(scene, dtype) if primary is None else primary
        key = philox.key_from_seed(seed, pixels.device)
        acc = radiance(scene, key, primary, pixels, primary.lanes(morton), range(scene.spp),
                       lights=lights, dtype=dtype, counts=counts, first_light=first_light)
        miss = miss_radiance(scene, primary, pixels, dtype=dtype)
    return torch.clamp(acc / scene.spp + miss, 0.0, 1.0)
