"""The path tracer written out plainly: what ``render_scene`` renders.

The estimator of the port's ``models/pathtracer.py`` (module docstring,
``radiance_for_rays`` :156-410) and of its fused engine's plain version
(``ops/fused.py`` ``sample_fused_plain`` :179-310, ``render_fused_plain``
:313-341), without next-event estimation:

* the primary hit is traced once per pixel and reused by every sample; a
  pixel whose primary ray misses shows ``ibl_power * ibl(d)``;
* per sample and bounce: emission on an emissive vertex ends the path;
  otherwise the bounce is sampled (``shading.sample_bounce``) and traced;
  an escaping path traces one sun shadow ray from its last vertex (full
  sun unless occluded or leaving glass, the occluder's colour through
  glass) and adds ``throughput * ibl_power * ibl(dir)``; a path still on a
  non-emissive vertex after ``max_bounce + 1`` bounces adds nothing;
* random numbers: sample ``s`` of lane ``r`` draws elements
  ``(b N + r) 2 + k`` of the Philox stream ``(key, s)`` at bounce ``b``
  (``ops/rng.py:11-20``, ``ops/fused.py:31-40``), where ``N`` is the
  image's pixel count and a lane is a pixel's place in the batch: the
  pixel itself, or on a multi-block scene that the fused engine renders,
  its place in the Morton order of the primary hits
  (``ops/fused.py:115-149``);
* the image is the mean over samples, clamped to [0, 1].

Any subset of pixels can be rendered on its own, in passes of lanes that
fit in memory, and in a lower precision (``dtype``) for the control.  The
forward and the gradient reference share :func:`radiance`.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from port_bench.reference import philox, shading
from port_bench.reference.shading import EMISSIVE, GLASS
from port_bench.reference.trace import closest_hit

LANES_PER_PASS = 1 << 21
TRI_TILE = 256  # triangles per block of the port's features (ops/closest_hit.py:35)


def _expand_bits_10(v):
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_lanes(points: torch.Tensor) -> torch.Tensor:
    """Each point's place in the stable sort of its 30-bit Morton code over
    the points' bounding box (the fused engine's lane order)."""
    lo, hi = torch.amin(points, dim=0), torch.amax(points, dim=0)
    q = torch.clamp((points - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 0.9999999)
    g = (q * 1024.0).to(torch.int64)
    code = ((_expand_bits_10(g[:, 0]) << 2) | (_expand_bits_10(g[:, 1]) << 1)
            | _expand_bits_10(g[:, 2]))
    order = torch.argsort(code, stable=True)
    places = torch.arange(order.numel(), device=order.device)
    return torch.empty_like(order).index_copy_(0, order, places)


class Primary:
    """Camera rays and their closest hits for the whole image."""

    def __init__(self, scene, dtype=torch.float32):
        res = scene.resolution
        self.o, self.d = shading.camera_rays(scene.cam_pos, scene.cam_rot, scene.fov, res, res)
        self.hit = closest_hit(scene, self.o, self.d, dtype)
        self.p = self.o + self.d * self.hit.t[:, None]

    def lanes(self, morton: bool) -> torch.Tensor:
        n = self.o.shape[0]
        if not morton:
            return torch.arange(n, device=self.o.device)
        return morton_lanes(torch.where(self.hit.hit[:, None], self.p, self.o))


def fused_lane_order(scene, device) -> bool:
    """Whether ``render_scene`` on ``device`` takes its lanes in Morton
    order: the fused engine (on the card, with the features of a pack
    loaded without a tree) on a scene of more than one triangle block."""
    return torch.device(device).type == "cuda" and scene.num_tris > TRI_TILE


def params_of(scene) -> Dict[str, torch.Tensor]:
    """The scene's differentiable values: material colours and roughness
    (emissive power for type 0), sun and IBL powers, the IBL texels."""
    return dict(color=scene.color, rough=scene.rough, sun_power=scene.sun_power,
                ibl_power=scene.ibl_power, ibl=scene.ibl)


def radiance(scene, key: torch.Tensor, primary: Primary, pixels: torch.Tensor,
             lanes: torch.Tensor, samples: range, *, params=None, dtype=torch.float32,
             counts: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """Sum over ``samples`` of the radiance of ``pixels`` (``[P]``, lane
    ``lanes[pixels]``): ``[P, 3]`` float32.  ``params`` (:func:`params_of`'s
    keys; tensors that may need a gradient) stands for the scene's values;
    ``counts`` receives the bounce segments traced, the lanes shaded and
    the sun rays traced."""
    params = params_of(scene) if params is None else params
    color, rough = params["color"], params["rough"]
    ibl = params["ibl"].to(dtype)
    n_all = primary.o.shape[0]
    dev = primary.o.device
    p_count = pixels.shape[0]
    per_pass = max(1, LANES_PER_PASS // max(p_count, 1))
    sun_d = shading.sun_direction(scene.sun_angles).to(dtype)
    cast = (lambda x: x.to(dtype)) if dtype != torch.float32 else (lambda x: x)
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
            u = cast(philox.uniforms_at(key, smp, (b * n_all + lane) * 2, 2))
            emis = live & (mtype == EMISSIVE)
            rad = rad + torch.where(emis[:, None], thr * rgh[:, None], zero3)
            live = live & ~emis
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
                sh = closest_hit(scene, p[sidx].float(), sun_rays, dtype)
                s_mid = scene.mat[sh.tri]
                unocc = (~sh.hit) & (mtype[sidx] != GLASS)
                glass_occ = sh.hit & (scene.mtype[s_mid] == GLASS)
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
        final = live & (mtype == EMISSIVE)
        rad = rad + torch.where(final[:, None], thr * rgh[:, None], zero3)
        env = shading.sample_ibl(ibl, esc_dir) * cast(params["ibl_power"])
        per_sample = (rad + esc_thr * env).float().reshape(g, p_count, 3)
        for j in range(g):
            acc = acc + per_sample[j]
    return acc


def miss_radiance(scene, primary: Primary, pixels: torch.Tensor, *, params=None,
                  dtype=torch.float32):
    """``ibl_power * ibl(d)`` of the pixels whose primary ray misses, 0 elsewhere."""
    params = params_of(scene) if params is None else params
    d = primary.d[pixels].to(dtype)
    env = shading.sample_ibl(params["ibl"].to(dtype), d) * params["ibl_power"].to(dtype)
    return torch.where(primary.hit.hit[pixels][:, None], torch.zeros_like(env), env).float()


@torch.no_grad()
def render_pixels(scene, seed: int, pixels: torch.Tensor, *, morton: bool, dtype=torch.float32,
                  counts: Optional[Dict[str, int]] = None, primary: Optional[Primary] = None):
    """The clamped image at ``pixels`` of ``render_scene(scene, seed)``:
    ``[P, 3]`` float32."""
    dev = pixels.device
    primary = Primary(scene, dtype) if primary is None else primary
    key = philox.key_from_seed(seed, dev)
    acc = radiance(scene, key, primary, pixels, primary.lanes(morton), range(scene.spp),
                   dtype=dtype, counts=counts)
    miss = miss_radiance(scene, primary, pixels, dtype=dtype)
    return torch.clamp(acc / scene.spp + miss, 0.0, 1.0)
