"""The fused sample engine: whole Monte-Carlo samples per ray in one
kernel launch.

Counterpart of the JAX package's ``ops/fused.py`` (``_make_kernel`` /
``sample_fused``), which runs the bounce loop of one sample for a tile of
rays in VMEM.  On the card two hand-written kernels do the same: per
bounce the emissive terminal, optional next-event estimation (NEE),
Lambert, GGX or tint-glass sampling, the bounce trace, the escape record
and the in-loop sun shadow with its glass tint, every trace an exact f32
closest hit (``t > MIN_HIT_DIST``, the answer of ``trace_plain``):

* ``csrc/fused_sample.cu``, one-block scenes: one thread per ray with all
  of its state in registers, the block's packed features resident in
  shared memory.  :func:`render_fused_resident` runs a whole render in one
  launch (every sample, the IBL of each escape and the sum over samples);
  :func:`sample_fused_blocks` runs one sample (and record mode);
* ``csrc/fused_queue.cu``, scenes of more blocks: one cooperative launch
  per sample, the rays' state in device memory between the traces, each
  trace the block-queue rounds of ``ops/pairs`` over the whole batch.
  :func:`render_fused_queue` runs a whole render as one launch per sample,
  each looking up the IBL of its escapes and adding the sample into the
  running sum in the kernel; :func:`sample_fused_queue` runs one sample
  (and record mode).

:func:`sample_fused` picks between the per-sample kernels by
``ops/closest_hit.resident``; :func:`sample_fused_plain` and
:func:`render_fused_plain` compute the same functions in plain torch.

A one-sample launch writes ``(rad, esc_thr, esc_dir)``: a path escapes at
most once, and its radiance is ``rad + esc_thr * ibl(esc_dir)``, which the
caller adds; the render launches of both kernels add it in the kernel.

Random numbers: an explicit ``uniforms [mb + 1, N, n_u]`` (``n_u`` = 2,
or 5 with NEE: ``u1, u2`` for the bounce, ``u3, u4, u5`` for the light
pick and the area sample), or the in-kernel Philox stream of
``ops/rng.py`` under ``key`` for sample ``sample``, in which lane ``r``
draws flat index ``(b N + r) n_u + k`` at bounce ``b``: exactly the
explicit layout, so ``uniforms(key, (mb + 1, N, n_u), sample)`` fed in
explicitly gives the same paths, and a whole-render launch draws for its
sample ``s`` what a one-sample launch for ``s`` draws.  A lane's index is
its position in the batch given, which on multi-block scenes is the
Morton-permuted order of ``models/pathtracer``.

Attribute table (:func:`build_tri_attrs`): ``[Tp, 8]`` float32, row
major, one row per triangle ``[nx, ny, nz, material type, r, g, b,
roughness (emissive power for type 0)]``, so the winner of a trace is
one 32-byte row gather.  Padding rows are zero.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ensem3a_openclraytracer_tpu_torch.ops import launches
from ensem3a_openclraytracer_tpu_torch.ops.bsdf import (
    EMISSIVE,
    GLASS,
    GLOSSY,
    eval_ggx,
    eval_lambert,
    sample_bounce,
)
from ensem3a_openclraytracer_tpu_torch.ops.closest_hit import (
    TriFeatures,
    _check,
    _expand_bits_10,
    check_features,
    check_packed,
    resident,
    trace_plain,
)
from ensem3a_openclraytracer_tpu_torch.ops.envmap import sample_ibl, sun_direction
from ensem3a_openclraytracer_tpu_torch.ops.geometry import (
    MAX_DIST,
    dot,
    sample_point_in_triangle,
    select,
)
from ensem3a_openclraytracer_tpu_torch.ops.intersect import Hit
from ensem3a_openclraytracer_tpu_torch.ops.pairs import K as PAIRS_K
from ensem3a_openclraytracer_tpu_torch.ops.pairs import trace_pairs_plain
from ensem3a_openclraytracer_tpu_torch.ops.rng import _check_key, uniforms_plain

N_ATTR = 8

# Launches of the CUDA kernels, by kernel source: ``sample_fused`` counts
# ``csrc/fused_sample.cu`` (a whole render through
# :func:`render_fused_resident`, or one sample through
# :func:`sample_fused_blocks`), ``sample_fused_queue`` counts
# ``csrc/fused_queue.cu`` (one a sample, through :func:`sample_fused_queue`
# or :func:`render_fused_queue`).  Only a launch on the card counts.
LAUNCHES = launches.counter({"sample_fused": ("fused_render_kernel", "fused_sample_kernel"),
                             "sample_fused_queue": ("fused_queue_kernel",)})

# The slots of ``csrc/fused_queue.cu``'s int64 ``stats``, in order: the
# first five as ``csrc/fused_sample.cu``'s (pairs tested, block stagings,
# trace rounds, slab tests in ``ops/pairs``' order, then grid syncs); the
# segments traced (the rays listed for each trace: bounce rays with their
# NEE shadow rays, then sun rays); the sum over CUDA blocks of thread 0's
# clock cycles inside the grid syncs, and from the kernel's entry to its
# exit; CUDA block 0's cycles by phase, each phase up to the grid sync that
# ends it (shade with the launch's set-up, bounce-trace rounds, resolve,
# sun-trace rounds, finish); the rounds that split their work items into
# more than one triangle slice and the work items run, one per slice
# (``ops/pairs.slices``); the rounds whose select gave each ray a group of
# more than one lane (``ops/pairs.select_lanes``); the NEE shadow rays
# listed (the lanes that want the light, counted where the kernel lists
# them; among the segments); the lanes whose sky a render launch looked up
# (:func:`render_fused_queue`; a one-sample launch looks up none); last the
# segments of each bounce, whose number follows ``max_bounce``.  Cycles are
# one SM's clock: only their ratios are read.  The plain version counts the
# same, with no syncs, no cycles, neither of the two slice counts and no
# grouped rounds.
QUEUE_STATS = ("pairs", "stagings", "rounds", "slabs", "syncs", "segments", "sync_cycles",
               "kernel_cycles", "shade_cycles", "bounce_trace_cycles", "resolve_cycles",
               "sun_trace_cycles", "finish_cycles", "split_rounds", "items",
               "coop_select_rounds", "nee_rays", "escape_lookups")
SEGMENTS = QUEUE_STATS.index("segments")
NEE_RAYS = QUEUE_STATS.index("nee_rays")
ESCAPE_LOOKUPS = QUEUE_STATS.index("escape_lookups")


def queue_stats_fields(max_bounce: int) -> tuple:
    """The names of ``csrc/fused_queue.cu``'s stats slots at ``max_bounce``
    (:data:`QUEUE_STATS`, then ``lanes.<bounce>``)."""
    return QUEUE_STATS + tuple(f"lanes.{b}" for b in range(max_bounce + 1))


def queue_stats_len(max_bounce: int) -> int:
    """The length of ``csrc/fused_queue.cu``'s stats at ``max_bounce``."""
    return len(QUEUE_STATS) + max_bounce + 1


_RENDER_STATS: dict = {}


def render_stats(device, max_bounce: int, make: bool = True) -> Optional[torch.Tensor]:
    """The one stats buffer (:data:`QUEUE_STATS`) per device and
    ``max_bounce`` that every multi-block render of ``models/pathtracer``
    gives its sample launches: a render zeroes it, so a captured render
    holds one zeroing node and writes it at a fixed address.  It is made on
    first use, which the eager warm-up before a capture is; with
    ``make=False`` None where it is not made yet.  No call reads it on the
    host (``utils/profiling.record_counters`` keeps device clones)."""
    key = (torch.device(device), int(max_bounce))
    buf = _RENDER_STATS.get(key)
    if buf is None and make:
        buf = _RENDER_STATS[key] = torch.zeros(queue_stats_len(max_bounce), dtype=torch.int64,
                                               device=key[0])
    return buf


def build_tri_attrs(face_n, face_mat, mtype, color, roughness, tp: int) -> torch.Tensor:
    """``[Tp, 8]`` attribute table (module docstring): each face's normal
    joined with its material record, zero-padded to ``tp`` rows."""
    midx = face_mat.to(torch.int64)
    rows = torch.cat([face_n.to(torch.float32), mtype[midx].to(torch.float32)[:, None],
                      color[midx].to(torch.float32), roughness[midx].to(torch.float32)[:, None]],
                     dim=1)
    return torch.nn.functional.pad(rows, (0, 0, 0, tp - rows.shape[0])).contiguous()


def morton_order_points(p: torch.Tensor) -> torch.Tensor:
    """Stable argsort of ``[N, 3]`` points by 30-bit Morton code: rays
    that start near one another then share a CUDA block, so its culling
    bites.  Primary hits are cached, so one sort serves a whole render."""
    lo = torch.amin(p, dim=0)
    hi = torch.amax(p, dim=0)
    q = torch.clamp((p - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 0.9999999)
    g = (q * 1024.0).to(torch.int64)
    code = ((_expand_bits_10(g[:, 0]) << 2) | (_expand_bits_10(g[:, 1]) << 1)
            | _expand_bits_10(g[:, 2]))
    return torch.argsort(code, stable=True)


def fused_args(geom, materials, env, ray_o, ray_d, hit, surf, permute: Optional[bool] = None):
    """The engine's per-sample arguments for a primary-ray batch, prepared
    once per render: ``(args, order)``.  ``hit`` and ``surf`` are the
    batch's primary hits and surfaces (``models/pathtracer``'s ``Hit`` and
    ``_Surface``); ``args`` is ``(feats, tri_attrs, p, n, mtype, color,
    rough, live, in_dir, sun_dir, sun_power)``, each contiguous, for
    ``sample_fused(*args, key, sample, ...)``.  ``permute`` (by default
    where the scene is not ``resident``) sorts the rays by the Morton
    order of their primary hit, so a CUDA block's rays start near one
    another and its culling bites; ``order`` is that permutation (None when
    the rays keep their order), and lane indices of the in-kernel stream
    are positions in it."""
    if permute is None:
        permute = not resident(geom.feats)
    order = morton_order_points(select(hit.hit, surf.p, ray_o)) if permute else None
    pick = (lambda x: x.contiguous()) if order is None else (lambda x: x[order].contiguous())
    attrs = build_tri_attrs(geom.n, geom.mat, materials.mtype, materials.color,
                            materials.roughness, geom.feats.edges.shape[-1])
    args = (geom.feats, attrs, pick(surf.p), pick(surf.n), pick(surf.mtype.to(torch.int32)),
            pick(surf.color), pick(surf.rough), pick(hit.hit), pick(ray_d),
            sun_direction(env.sun_angles_deg).contiguous(), env.sun_power.reshape(1).contiguous())
    return args, order


def _check_args(max_bounce, uniforms, key, nee, lights, record, n_rays, ns=None):
    """``n_u``; raises on a bad combination.  ``uniforms`` is one sample's
    ``[mb + 1, N, n_u]``, or ``[ns, mb + 1, N, n_u]`` with ``ns``."""
    if nee and lights is None:
        raise ValueError("nee=True requires lights")
    if record and nee:
        raise ValueError("record mode is BSDF-only (replay has no NEE)")
    if max_bounce < 0:
        raise ValueError(f"max_bounce {max_bounce} < 0")
    if ns is not None and ns < 1:
        raise ValueError(f"ns {ns} < 1")
    n_u = 5 if nee else 2
    if uniforms is None:
        if key is None:
            raise ValueError("give uniforms [max_bounce + 1, N, n_u] or a Philox key")
        _check_key(key)
    elif tuple(uniforms.shape) != _u_shape(max_bounce, n_rays, n_u, ns):
        raise ValueError(f"uniforms: want shape {_u_shape(max_bounce, n_rays, n_u, ns)}, "
                         f"got {tuple(uniforms.shape)}")
    return n_u


def _u_shape(max_bounce, n_rays, n_u, ns=None):
    one = (max_bounce + 1, n_rays, n_u)
    return one if ns is None else (ns, *one)


def sample_fused_plain(feats: TriFeatures, tri_attrs, primary_p, primary_n, primary_mtype,
                       primary_color, primary_rough, primary_live, in_dir, sun_dir, sun_power,
                       key: Optional[torch.Tensor] = None, sample: int = 0, *, max_bounce: int,
                       sun_enabled: bool, uniforms: Optional[torch.Tensor] = None,
                       nee: bool = False, lights=None, record: bool = False,
                       stats: Optional[torch.Tensor] = None, traces: Optional[list] = None,
                       escaped: Optional[list] = None):
    """:func:`sample_fused` in plain torch on the inputs' device, built
    from the scan estimator's ops; with ``uniforms=None`` it draws the
    kernel's stream with ``uniforms_plain``.

    Each trace loop of the kernels, the bounce ray together with the NEE
    shadow ray and then the sun ray, is one closest hit of the rays the
    kernels trace (live lanes, NEE lanes that want the light, escaping
    lanes; every lane in record mode), the others reading a miss:
    ``trace_pairs_plain`` on scenes of more than one block, so ``stats``
    (int64 ``[queue_stats_len(max_bounce)]``, optional) receives what
    ``csrc/fused_queue.cu`` counts there (:data:`QUEUE_STATS`): pairs
    tested, block stagings, rounds, slab tests, the segments traced and
    each bounce's, the NEE shadow rays among them; the plain version makes
    no grid syncs and counts no cycles, no slices and no grouped selects.
    On one block it traces with ``trace_plain`` (``stats`` untouched).
    Both equal ``trace_plain`` bit for bit.
    ``traces`` (a list, optional) receives each trace loop's ``(o, d,
    hit)``; ``escaped`` (a list, optional) the lanes that escaped, ``[N]``
    bool."""
    n_rays = primary_p.shape[0]
    n_u = _check_args(max_bounce, uniforms, key, nee, lights, record, n_rays)
    if uniforms is None:
        uniforms = uniforms_plain(key, (max_bounce + 1, n_rays, n_u), sample)
    dev = primary_p.device
    f32 = lambda x: x.to(torch.float32)
    p, n, color, in_d = f32(primary_p), f32(primary_n), f32(primary_color), f32(in_dir)
    mtype = primary_mtype.to(torch.int64)
    rough = f32(primary_rough)
    live = primary_live.to(torch.bool)
    sun_d = f32(sun_dir).reshape(1, 3).expand(n_rays, 3)
    sun_pow = f32(sun_power).reshape(())
    thr = torch.ones_like(p)
    rad = torch.zeros_like(p)
    esc_thr = torch.zeros_like(p)
    esc_dir = torch.zeros_like(p)
    esc_dir[:, 2] = 1.0  # the caller's IBL lookup stays NaN-free
    emit_ok = torch.ones_like(live)
    esc = torch.zeros_like(live)
    zero3 = torch.zeros_like(p)
    mb1 = max_bounce + 1
    if record:
        u_rec = torch.zeros((mb1, n_rays, 2), dtype=torch.float32, device=dev)
        tri_rec = torch.full((mb1, n_rays), -1, dtype=torch.int32, device=dev)
        sun_rec = torch.full((mb1, n_rays), -1, dtype=torch.int32, device=dev)
    multi = not resident(feats)
    if stats is not None and multi and tuple(stats.shape) != (queue_stats_len(max_bounce),):
        raise ValueError(f"stats: want shape ({queue_stats_len(max_bounce)},) on "
                         f"{feats.block_bounds.shape[0]} blocks, got {tuple(stats.shape)}")
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    lanes = [0] * mb1  # segments traced per bounce
    nee_rays = 0  # NEE shadow rays traced

    def trace_loop(o, d, act):
        idx = torch.nonzero(act).squeeze(1)
        lanes[b] += idx.numel()
        oa, da = o[idx].contiguous(), d[idx].contiguous()
        h = trace_pairs_plain(feats, oa, da, stats=counts) if multi else trace_plain(feats, oa, da)
        if traces is not None:
            traces.append((oa, da, h))
        m = o.shape[0]
        t = torch.full((m,), MAX_DIST, dtype=torch.float32, device=dev).index_copy_(0, idx, h.t)
        tri = torch.zeros((m,), dtype=torch.int64, device=dev).index_copy_(0, idx, h.tri)
        hit = torch.zeros((m,), dtype=torch.bool, device=dev).index_copy_(0, idx, h.hit)
        return Hit(t=t, tri=tri, hit=hit)

    def attrs_of(h):
        a = tri_attrs[h.tri]
        return a[:, 0:3], a[:, 3].round().to(torch.int64), a[:, 4:7], a[:, 7]

    for b in range(mb1):
        u = f32(uniforms[b])
        emis = live & (mtype == EMISSIVE)
        rad = rad + select((emis & emit_ok) if nee else emis, thr * rough[:, None], zero3)
        live = live & ~emis
        if nee:  # one area-sampled light point; its shadow ray shares the bounce trace
            n_lights = lights.v0.shape[0]
            li = torch.clamp((u[:, 2] * n_lights).to(torch.int64), 0, n_lights - 1)
            xl = sample_point_in_triangle(lights.v0[li], lights.v1[li], lights.v2[li],
                                          u[:, 3], u[:, 4])
            delta = xl - p
            dist2 = torch.clamp(dot(delta, delta), min=1e-8)
            dist = torch.sqrt(dist2)
            ldir = delta / dist[:, None]
            cos_s = dot(ldir, n)
            cos_l = torch.abs(dot(ldir, lights.n[li]))
            brdf = select(mtype == GLOSSY, eval_ggx(color, rough, -in_d, ldir, n),
                          eval_lambert(color))
            sampled = live & (mtype != GLASS)
            want = sampled & (cos_s > 0.0) & (cos_l > 1e-6)
            weight = (float(n_lights) * lights.area[li]) * cos_l / dist2
            contrib = thr * brdf * (torch.clamp(cos_s, min=0.0) * weight * lights.power[li])[:, None]
            emit_ok = (live & ~sampled) | (~live & emit_ok)

        bdir, factor = sample_bounce(mtype, color, rough, in_d, n, u[:, 0], u[:, 1])
        thr = select(live, thr * factor, thr)
        act = live | record  # record mode traces dead lanes too
        if nee:
            both = trace_loop(torch.cat([p, p]), torch.cat([bdir, ldir]), torch.cat([act, want]))
            h = Hit(t=both.t[:n_rays], tri=both.tri[:n_rays], hit=both.hit[:n_rays])
            visible = both.t[n_rays:] >= dist * (1.0 - 1e-3)
            nee_rays += int(want.sum())
            rad = rad + select(want & visible, contrib, zero3)
        else:
            h = trace_loop(p, bdir, act)
        miss = live & ~h.hit
        esc = esc | miss
        esc_thr = select(miss, thr, esc_thr)
        esc_dir = select(miss, bdir, esc_dir)
        if sun_enabled:  # the sun shadow ray of an escaping path, tinted by glass
            sh = trace_loop(p, sun_d, miss | record)
            _, s_mtype, s_color, _ = attrs_of(sh)
            unocc = (~sh.hit) & (mtype != GLASS)
            glass_occ = sh.hit & (s_mtype == GLASS)
            sun_light = (unocc.to(torch.float32)[:, None] * sun_pow
                         + glass_occ.to(torch.float32)[:, None] * s_color * sun_pow)
            rad = rad + select(miss, thr * sun_light, zero3)
        if record:
            u_rec[b] = u[:, :2]
            tri_rec[b] = torch.where(h.hit, h.tri, -1).to(torch.int32)
            if sun_enabled:
                sun_rec[b] = torch.where(sh.hit, sh.tri, -1).to(torch.int32)
        live = live & h.hit
        a_n, a_mt, a_col, a_ro = attrs_of(h)
        p = select(live, p + bdir * h.t[:, None], p)
        n = select(live, a_n, n)
        mtype = select(live, a_mt, mtype)
        color = select(live, a_col, color)
        rough = select(live, a_ro, rough)
        in_d = select(live, bdir, in_d)

    final_emis = live & (mtype == EMISSIVE)
    if nee:
        final_emis = final_emis & emit_ok
    rad = rad + select(final_emis, thr * rough[:, None], zero3)
    if stats is not None and multi:
        stats[:4] += counts.to(stats.device)
        stats[SEGMENTS] += sum(lanes)
        stats[NEE_RAYS] += nee_rays
        stats[len(QUEUE_STATS):] += torch.tensor(lanes, dtype=torch.int64, device=stats.device)
    if escaped is not None:
        escaped.append(esc)
    if record:
        return rad, esc_thr, esc_dir, u_rec, tri_rec, sun_rec
    return rad, esc_thr, esc_dir


def render_fused_plain(feats: TriFeatures, tri_attrs, primary_p, primary_n, primary_mtype,
                       primary_color, primary_rough, primary_live, in_dir, sun_dir, sun_power,
                       key: Optional[torch.Tensor] = None, s0: int = 0, ns: int = 1, *,
                       ibl: torch.Tensor, ibl_power: torch.Tensor, ibl_bilinear: bool = True,
                       max_bounce: int, sun_enabled: bool,
                       uniforms: Optional[torch.Tensor] = None, nee: bool = False, lights=None,
                       stats: Optional[torch.Tensor] = None,
                       traces: Optional[list] = None) -> torch.Tensor:
    """Samples ``s0 .. s0 + ns - 1`` of every ray, summed: ``[N, 3]``, the
    sum of ``rad + esc_thr * (sample_ibl(ibl, esc_dir) * ibl_power)`` over
    :func:`sample_fused_plain`'s samples, added in the order the estimator
    adds them (``acc + rad + ...`` from zero).  ``uniforms``, when given,
    is ``[ns, mb + 1, N, n_u]``, else sample ``s`` draws the Philox stream
    of ``key`` for ``s``.  ``stats`` and ``traces`` go to every sample; on
    a multi-block scene ``stats`` also counts the escaped lanes, whose sky
    is looked up, under ``escape_lookups`` (:data:`QUEUE_STATS`), as
    :func:`render_fused_queue`'s kernel does.
    The estimator renders from ``s0 = 0``; an offset renders a later run of
    samples of the same stream, as a render split into sample chunks (the
    replay estimator's) draws them."""
    n_rays = primary_p.shape[0]
    _check_args(max_bounce, uniforms, key, nee, lights, False, n_rays, ns)
    args = (feats, tri_attrs, primary_p, primary_n, primary_mtype, primary_color, primary_rough,
            primary_live, in_dir, sun_dir, sun_power)
    acc = torch.zeros((n_rays, 3), dtype=torch.float32, device=primary_p.device)
    escaped = []
    for j in range(ns):
        rad, esc_thr, esc_dir = sample_fused_plain(
            *args, key, s0 + j, max_bounce=max_bounce, sun_enabled=sun_enabled,
            uniforms=None if uniforms is None else uniforms[j], nee=nee, lights=lights,
            stats=stats, traces=traces, escaped=escaped)
        acc = acc + rad + esc_thr * (sample_ibl(ibl, esc_dir, bilinear=ibl_bilinear) * ibl_power)
    if stats is not None and not resident(feats):
        for esc in escaped:
            stats[ESCAPE_LOOKUPS] += esc.sum().to(stats.device)
    return acc


def sample_fused(feats: TriFeatures, *args, **kw):
    """One Monte-Carlo sample for ``N`` rays from their cached primary
    vertices: ``sample_fused(feats, tri_attrs, p, n, mtype, color, rough,
    live, in_dir, sun_dir, sun_power, key=None, sample=0, *, max_bounce,
    sun_enabled, uniforms=None, nee=False, lights=None, record=False,
    stats=None)`` with ``p, n [N, 3]``, ``mtype [N]`` int32, ``color [N,
    3]``, ``rough [N]``, ``live [N]`` bool, ``in_dir [N, 3]``.  Returns
    ``(rad, esc_thr, esc_dir)``, each ``[N, 3]``; the sample's radiance is
    ``rad + esc_thr * ibl(esc_dir)``.  ``record=True`` (BSDF only) adds
    ``(u [mb+1, N, 2], tri [mb+1, N], sun_tri [mb+1, N])`` int32, -1 for a
    miss (``sun_tri`` all -1 without sun).

    Random numbers come from ``uniforms`` or, when it is None, from the
    Philox stream of ``key`` (``[2]`` int32 on the rays' device) for
    ``sample`` (module docstring).  With ``nee``, ``lights`` is a
    ``LightPack`` whose columns the kernels read in place (its ``power`` is
    the snapshot used, as the TPU kernel's).  ``stats`` (int64, optional:
    ``[5]`` on one block, ``[queue_stats_len(max_bounce)]`` on more)
    receives the (ray, triangle) pairs tested, the triangle-block stagings,
    the trace rounds, the ray-box slab tests (the first four in
    ``ops/pairs``' order) and the grid syncs, added to what it holds; on
    more blocks also the rest of :data:`QUEUE_STATS` and the segments of
    each bounce.

    One-block scenes (``ops/closest_hit.resident``) go to
    :func:`sample_fused_blocks`, others to :func:`sample_fused_queue`;
    each takes :func:`sample_fused_plain` for rays on the CPU.
    :func:`render_fused_resident` runs every sample of a one-block render
    in one launch."""
    run = sample_fused_blocks if resident(feats) else sample_fused_queue
    return run(feats, *args, **kw)


class _Launch:
    """The checked arguments of one kernel launch, shared by the three
    wrappers: ``head`` (counts and the primary vertex), ``feat`` (the packed
    features: ``packed, bounds, tp, tile, nb``) and ``mid`` (the attribute
    table, the lights and the random stream) of the C entry points'
    argument lists; ``tail()`` adds one sample's outputs."""

    def __init__(self, feats, tri_attrs, primary_p, primary_n, primary_mtype, primary_color,
                 primary_rough, primary_live, in_dir, sun_dir, sun_power, key, sample, *,
                 max_bounce, sun_enabled, uniforms, nee, lights, record, stats, ns=None,
                 stats_slots=5):
        dev = primary_p.device
        if dev.type != "cuda":
            raise ValueError(f"the fused kernels run on cuda or cpu, not {dev}")
        n = primary_p.shape[0]
        n_u = _check_args(max_bounce, uniforms, key, nee, lights, record, n, ns)
        self.tp, self.tile, self.nb = check_features(feats, dev)
        check_packed(feats, self.tp, dev)
        f32, i32 = torch.float32, torch.int32
        sun_dir, sun_power = sun_dir.reshape(3), sun_power.reshape(1)
        for x, name, shape, dt in (
            (primary_p, "primary_p", (n, 3), f32), (primary_n, "primary_n", (n, 3), f32),
            (primary_mtype, "primary_mtype", (n,), i32),
            (primary_color, "primary_color", (n, 3), f32),
            (primary_rough, "primary_rough", (n,), f32),
            (primary_live, "primary_live", (n,), torch.bool), (in_dir, "in_dir", (n, 3), f32),
            (tri_attrs, "tri_attrs", (self.tp, N_ATTR), f32), (sun_dir, "sun_dir", (3,), f32),
            (sun_power, "sun_power", (1,), f32),
        ):
            _check(x, name, shape, dt, dev)
        light_cols, n_lights = (None,) * 6, 0
        if nee:  # the pack's columns, read in place
            n_lights = lights.v0.shape[0]
            light_cols = (lights.v0, lights.v1, lights.v2, lights.n, lights.power, lights.area)
            for x, name, shape in zip(light_cols, ("v0", "v1", "v2", "n", "power", "area"),
                                      ((n_lights, 3),) * 4 + ((n_lights,),) * 2):
                _check(x, f"lights.{name}", shape, f32, dev)
        if uniforms is not None:
            _check(uniforms, "uniforms", _u_shape(max_bounce, n, n_u, ns), f32, dev)
        if key is not None:
            _check(key, "key", (2,), i32, dev)
        if stats is not None:
            _check(stats, "stats", (stats_slots,), torch.int64, dev)
        ptr = lambda x: None if x is None else x.data_ptr()
        self.n, self.dev, self.mb1, self.sun, self.stats = n, dev, max_bounce + 1, sun_enabled, stats
        self.head = (n, max_bounce, int(sun_enabled), int(nee), int(record),
                     *(x.data_ptr() for x in (primary_p, primary_n, primary_mtype, primary_color,
                                              primary_rough, primary_live, in_dir, sun_dir,
                                              sun_power)))
        self.feat = (feats.packed.data_ptr(), feats.block_bounds.data_ptr(), self.tp, self.tile,
                     self.nb)
        self.mid = (tri_attrs.data_ptr(), *(ptr(x) for x in light_cols), n_lights,
                    ptr(uniforms), ptr(key), int(sample))

    @property
    def stream(self) -> int:
        """The stream current when the kernel launches (under graph capture,
        the capture's)."""
        return torch.cuda.current_stream(self.dev).cuda_stream

    def tail(self, record):
        """One sample's outputs ``(rad, esc_thr, esc_dir[, u, tri, sun_tri])``
        and the last arguments of a one-sample entry point."""
        n, mb1, dev, f32, i32 = self.n, self.mb1, self.dev, torch.float32, torch.int32
        rad = torch.empty((n, 3), dtype=f32, device=dev)
        esc_thr = torch.empty_like(rad)
        esc_dir = torch.empty_like(rad)
        out = (rad, esc_thr, esc_dir)
        rec = (None, None, None)
        if record:  # without sun the kernels write no sun record
            rec = (torch.empty((mb1, n, 2), dtype=f32, device=dev),
                   torch.empty((mb1, n), dtype=i32, device=dev),
                   torch.empty((mb1, n), dtype=i32, device=dev) if self.sun
                   else torch.full((mb1, n), -1, dtype=i32, device=dev))
            out += rec
        ptr = lambda x: None if x is None else x.data_ptr()
        args = (rad.data_ptr(), esc_thr.data_ptr(), esc_dir.data_ptr(), ptr(rec[0]), ptr(rec[1]),
                ptr(rec[2]) if self.sun else None, ptr(self.stats), self.stream)
        return out, args


_ARGTYPES_HEAD = (
    [ctypes.c_int] * 5  # n, max_bounce, sun_enabled, nee, record
    + [ctypes.c_void_p] * 7  # p, n, mtype, color, rough, live, in_dir
    + [ctypes.c_void_p] * 2  # sun_dir [3], sun_power [1]
)
_ARGTYPES_FEAT = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3  # packed, bounds; tp, tile, nb
_ARGTYPES_MID = (
    [ctypes.c_void_p]  # attrs
    + [ctypes.c_void_p] * 6 + [ctypes.c_int]  # light v0, v1, v2, n, power, area; count
    + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]  # uniforms, key, sample (or s0)
)
_ARGTYPES_TAIL = (
    [ctypes.c_void_p] * 6  # rad, esc_thr, esc_dir, u_rec, tri_rec, sun_rec
    + [ctypes.c_void_p] * 2  # stats, stream
)
_ARGTYPES_SKY = ([ctypes.c_void_p] + [ctypes.c_int] * 3  # ibl, h, w, bilinear
                 + [ctypes.c_void_p])  # ibl_power
_PLAN_KEYS = ("chunks", "per_chunk", "grid", "blocks_per_sm", "sms", "registers", "threads",
              "smem_bytes", "local_bytes", "items")


@functools.cache
def _sample_lib():
    """``csrc/fused_sample.cu``'s library with its C entry points typed,
    built on first use."""
    from ensem3a_openclraytracer_tpu_torch import _build

    lib = _build.load("fused_sample")
    lib.fused_sample_launch.argtypes = (_ARGTYPES_HEAD + _ARGTYPES_FEAT + _ARGTYPES_MID
                                        + _ARGTYPES_TAIL)
    lib.fused_sample_launch.restype = ctypes.c_int
    lib.fused_render_launch.argtypes = (
        _ARGTYPES_HEAD[:4] + _ARGTYPES_HEAD[5:]  # no record
        + _ARGTYPES_FEAT + _ARGTYPES_MID
        + [ctypes.c_int]  # ns
        + _ARGTYPES_SKY
        + [ctypes.c_int] * 3  # chunks, per, grid
        + [ctypes.c_void_p] * 5)  # partial, ctrl, out, stats, stream
    lib.fused_render_launch.restype = ctypes.c_int
    lib.fused_render_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.fused_render_plan.restype = ctypes.c_int
    return lib


@functools.cache
def _queue_lib():
    """``csrc/fused_queue.cu``'s library with its C entry points typed,
    built on first use."""
    from ensem3a_openclraytracer_tpu_torch import _build

    lib = _build.load("fused_queue")
    lib.fused_queue_launch.argtypes = (_ARGTYPES_HEAD + _ARGTYPES_FEAT + _ARGTYPES_MID
                                       + [ctypes.c_void_p] * 2  # scratch, acc
                                       + _ARGTYPES_SKY + _ARGTYPES_TAIL)
    lib.fused_queue_launch.restype = ctypes.c_int
    lib.fused_queue_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.fused_queue_scratch_bytes.restype = ctypes.c_longlong
    lib.fused_queue_grid.argtypes = [ctypes.c_void_p]
    lib.fused_queue_grid.restype = ctypes.c_int
    return lib


def queue_grid() -> dict:
    """:func:`sample_fused_queue`'s grid on the current card: CUDA blocks
    per SM (the occupancy API's count), SMs, registers per thread, threads
    per CUDA block, dynamic shared memory per CUDA block, local memory
    (spills and stack) per thread."""
    out = (ctypes.c_int * 6)()
    err = _queue_lib().fused_queue_grid(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"fused_queue kernel: no cooperative grid (CUDA error {err})")
    return dict(zip(("blocks_per_sm", "sms", "registers", "threads", "smem_bytes", "local_bytes"),
                    out))


def render_plan(n_rays: int, ns: int) -> dict:
    """:func:`render_fused_resident`'s launch on the current card for
    ``n_rays`` rays and ``ns`` samples: sample chunks and samples per chunk,
    the grid (one resident wave), the occupancy API's CUDA blocks per SM,
    SMs, registers per thread, threads per CUDA block, static shared memory,
    local memory (spills and stack) per thread, and the work items (tiles of
    128 lanes times chunks).  Asked of the card once per (card, rays,
    samples)."""
    return dict(zip(_PLAN_KEYS, _plan(torch.cuda.current_device(), int(n_rays), int(ns))))


@functools.lru_cache(maxsize=64)
def _plan(device: int, n_rays: int, ns: int) -> tuple:
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    err = _sample_lib().fused_render_plan(n_rays, ns, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"fused_sample render kernel: no launch plan (CUDA error {err})")
    return tuple(out)


def _one_block(feats: TriFeatures, what: str) -> None:
    if not resident(feats):
        raise ValueError(f"{what} takes one triangle block, not {feats.block_bounds.shape[0]}: "
                         f"sample_fused sends other scenes to sample_fused_queue")


def sample_fused_blocks(feats: TriFeatures, tri_attrs, primary_p, primary_n, primary_mtype,
                        primary_color, primary_rough, primary_live, in_dir, sun_dir, sun_power,
                        key: Optional[torch.Tensor] = None, sample: int = 0, *, max_bounce: int,
                        sun_enabled: bool, uniforms: Optional[torch.Tensor] = None,
                        nee: bool = False, lights=None, record: bool = False,
                        stats: Optional[torch.Tensor] = None):
    """:func:`sample_fused` on a one-block scene through
    ``csrc/fused_sample.cu`` (one thread per ray, its state in registers,
    the block's packed features resident in shared memory) for rays on the
    card; rays on the CPU take :func:`sample_fused_plain`.  Raises on more
    than one block.  ``stats`` receives no rounds and no grid syncs."""
    _one_block(feats, "sample_fused_blocks")
    kw = dict(max_bounce=max_bounce, sun_enabled=sun_enabled, uniforms=uniforms, nee=nee,
              lights=lights, record=record)
    args = (feats, tri_attrs, primary_p, primary_n, primary_mtype, primary_color, primary_rough,
            primary_live, in_dir, sun_dir, sun_power, key, sample)
    if primary_p.device.type == "cpu":
        return sample_fused_plain(*args, stats=stats, **kw)
    run = _Launch(*args, stats=stats, **kw)
    out, tail = run.tail(record)
    if run.n:
        err = _sample_lib().fused_sample_launch(*run.head, *run.feat, *run.mid, *tail)
        if err != 0:
            raise RuntimeError(f"fused_sample kernel launch failed: CUDA error {err}")
        LAUNCHES["sample_fused"] += 1
    return out


def sample_fused_queue(feats: TriFeatures, tri_attrs, primary_p, primary_n, primary_mtype,
                       primary_color, primary_rough, primary_live, in_dir, sun_dir, sun_power,
                       key: Optional[torch.Tensor] = None, sample: int = 0, *, max_bounce: int,
                       sun_enabled: bool, uniforms: Optional[torch.Tensor] = None,
                       nee: bool = False, lights=None, record: bool = False,
                       stats: Optional[torch.Tensor] = None):
    """:func:`sample_fused` through ``csrc/fused_queue.cu`` for rays on the
    card: one cooperative launch per sample, every trace through block
    queues (``ops/pairs``' rounds, on every ray of the batch at once), no
    host sync, no limit on the blocks.  Needs ``feats.packed``.
    ``stats`` (int64 ``[queue_stats_len(max_bounce)]``, optional) receives
    :data:`QUEUE_STATS` and the segments of each bounce.  Rays on the CPU
    take :func:`sample_fused_plain`, whose counts on a multi-block scene
    are the kernel's (no syncs, no cycles, no slices, no grouped selects).
    :func:`render_fused_queue` adds samples up in the same kernel."""
    kw = dict(max_bounce=max_bounce, sun_enabled=sun_enabled, uniforms=uniforms, nee=nee,
              lights=lights, record=record)
    args = (feats, tri_attrs, primary_p, primary_n, primary_mtype, primary_color, primary_rough,
            primary_live, in_dir, sun_dir, sun_power, key, sample)
    if primary_p.device.type == "cpu":
        return sample_fused_plain(*args, stats=stats, **kw)
    run = _Launch(*args, stats=stats, stats_slots=queue_stats_len(max_bounce), **kw)
    out, tail = run.tail(record)
    if run.n:
        _queue_launch(run, nee, [run.mid], None, (None, 0, 0, 0, None), tail)
    return out


def _queue_launch(run: _Launch, nee: bool, mids: list, acc, sky: tuple, tail: tuple) -> None:
    """One launch of ``csrc/fused_queue.cu`` for each of ``mids`` (a
    sample's ``_Launch.mid``), in order, on one scratch: into the running
    sum ``acc`` with the ``sky`` arguments, or (``acc`` None) to ``tail``'s
    outputs."""
    slots = run.n * (2 if nee else 1)  # a lane's NEE shadow ray shares the bounce trace
    if slots * PAIRS_K >= 2 ** 31:
        raise ValueError(f"{slots} rays x {PAIRS_K} picks overflow the kernel's int32 queue")
    lib = _queue_lib()
    scratch = torch.empty((lib.fused_queue_scratch_bytes(run.n, run.nb, int(nee)),),
                          dtype=torch.uint8, device=run.dev)
    acc_ptr = None if acc is None else acc.data_ptr()
    for mid in mids:
        err = lib.fused_queue_launch(*run.head, *run.feat, *mid, scratch.data_ptr(), acc_ptr,
                                     *sky, *tail)
        if err != 0:
            raise RuntimeError(f"fused_queue kernel launch failed: CUDA error {err}")
        LAUNCHES["sample_fused_queue"] += 1


def _sky(ibl: torch.Tensor, ibl_power: torch.Tensor, ibl_bilinear: bool, dev) -> tuple:
    """The checked IBL arguments of a render launch: ``(ibl, h, w,
    bilinear, ibl_power)`` for an ``[h, w, 3]`` f32 image and a power of
    one value."""
    ibl_power = ibl_power.reshape(1)
    _check(ibl_power, "ibl_power", (1,), torch.float32, dev)
    if ibl.dim() != 3 or ibl.shape[-1] != 3:
        raise ValueError(f"ibl: want [H, W, 3], got {tuple(ibl.shape)}")
    _check(ibl, "ibl", tuple(ibl.shape), torch.float32, dev)
    return ibl.data_ptr(), ibl.shape[0], ibl.shape[1], int(ibl_bilinear), ibl_power.data_ptr()


def render_fused_queue(feats: TriFeatures, tri_attrs, primary_p, primary_n, primary_mtype,
                       primary_color, primary_rough, primary_live, in_dir, sun_dir, sun_power,
                       key: Optional[torch.Tensor] = None, s0: int = 0, ns: int = 1, *,
                       ibl: torch.Tensor, ibl_power: torch.Tensor, ibl_bilinear: bool = True,
                       max_bounce: int, sun_enabled: bool,
                       uniforms: Optional[torch.Tensor] = None, nee: bool = False,
                       lights=None, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`render_fused_plain` through ``csrc/fused_queue.cu`` for rays
    on the card: ``[N, 3]`` zeroed once, then one launch per sample ``s0 +
    j`` (drawing what :func:`sample_fused_queue` draws for it) that looks up
    the IBL of each escape and adds ``rad + esc_thr * ibl(esc_dir) *
    ibl_power`` into the sum in place, in the host's order, so nothing runs
    between the launches.  ``stats`` (int64 ``[queue_stats_len(max_bounce)]``,
    optional) receives every launch's :data:`QUEUE_STATS`, the lanes whose
    sky was looked up among them.  Rays on the CPU take
    :func:`render_fused_plain`.  ``s0`` is as :func:`render_fused_plain`'s."""
    kw = dict(max_bounce=max_bounce, sun_enabled=sun_enabled, uniforms=uniforms, nee=nee,
              lights=lights)
    args = (feats, tri_attrs, primary_p, primary_n, primary_mtype, primary_color, primary_rough,
            primary_live, in_dir, sun_dir, sun_power, key, s0)
    if primary_p.device.type == "cpu":
        return render_fused_plain(*args, ns, ibl=ibl, ibl_power=ibl_power,
                                  ibl_bilinear=ibl_bilinear, stats=stats, **kw)
    run = _Launch(*args, record=False, stats=stats, ns=ns,
                  stats_slots=queue_stats_len(max_bounce), **kw)
    sky = _sky(ibl, ibl_power, ibl_bilinear, run.dev)
    out = torch.zeros((run.n, 3), dtype=torch.float32, device=run.dev)
    if run.n:
        ptr = lambda x: None if x is None else x.data_ptr()
        mids = [run.mid[:-3] + (ptr(None if uniforms is None else uniforms[j]), run.mid[-2],
                                s0 + j) for j in range(ns)]
        _queue_launch(run, nee, mids, out, sky, (None,) * 6 + (ptr(stats), run.stream))
    return out


def render_fused_resident(feats: TriFeatures, tri_attrs, primary_p, primary_n, primary_mtype,
                          primary_color, primary_rough, primary_live, in_dir, sun_dir, sun_power,
                          key: Optional[torch.Tensor] = None, s0: int = 0, ns: int = 1, *,
                          ibl: torch.Tensor, ibl_power: torch.Tensor, ibl_bilinear: bool = True,
                          max_bounce: int, sun_enabled: bool,
                          uniforms: Optional[torch.Tensor] = None, nee: bool = False,
                          lights=None, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`render_fused_plain` on a one-block scene in one launch of
    ``csrc/fused_sample.cu`` for rays on the card: ``[N, 3]``, the sum over
    samples ``s0 .. s0 + ns - 1`` of ``rad + esc_thr * ibl(esc_dir) *
    ibl_power``, each sample drawing what :func:`sample_fused_blocks` draws
    for it.  The launch is persistent (:func:`render_plan`); a chunk of
    samples sums into a scratch ``[chunks, N, 3]`` that the kernel adds up
    in chunk order.  Rays on the CPU take :func:`render_fused_plain`.
    Raises on more than one block.  ``stats`` (int64 ``[5]``) receives
    pairs tested, stagings (one per CUDA block) and slab tests.  ``s0`` is
    as :func:`render_fused_plain`'s."""
    _one_block(feats, "render_fused_resident")
    kw = dict(max_bounce=max_bounce, sun_enabled=sun_enabled, uniforms=uniforms, nee=nee,
              lights=lights)
    args = (feats, tri_attrs, primary_p, primary_n, primary_mtype, primary_color, primary_rough,
            primary_live, in_dir, sun_dir, sun_power, key, s0)
    if primary_p.device.type == "cpu":
        return render_fused_plain(*args, ns, ibl=ibl, ibl_power=ibl_power,
                                  ibl_bilinear=ibl_bilinear, stats=stats, **kw)
    run = _Launch(*args, record=False, stats=stats, ns=ns, **kw)
    sky = _sky(ibl, ibl_power, ibl_bilinear, run.dev)
    out = torch.empty((run.n, 3), dtype=torch.float32, device=run.dev)
    if run.n:
        plan = render_plan(run.n, ns)
        chunks = plan["chunks"]
        partial = (torch.empty((chunks, run.n, 3), dtype=torch.float32, device=run.dev)
                   if chunks > 1 else None)
        ctrl = torch.zeros(1 + (run.n + 127) // 128, dtype=torch.int32, device=run.dev)
        head = run.head[:4] + run.head[5:]  # no record
        err = _sample_lib().fused_render_launch(
            *head, *run.feat, *run.mid, int(ns), *sky, chunks, plan["per_chunk"], plan["grid"],
            None if partial is None else partial.data_ptr(), ctrl.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(), run.stream)
        if err != 0:
            raise RuntimeError(f"fused_sample render kernel launch failed: CUDA error {err}")
        LAUNCHES["sample_fused"] += 1
    return out
