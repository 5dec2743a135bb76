"""Prototype: grouped-pair closest hit, head to head with ``trace_pairs``.

Counterpart of the JAX package's ``experiments/proto_grouped.py``.  Rays
are sorted by ``coherent_order`` and cut into tiles of ``rt`` rays.  A
schedule built by tensor ops (:func:`build_schedule`, the XLA work outside
the TPU kernel) lists, per tile, every triangle block that the margined
slab test of some ray of the tile passes, front to back, as a flat
``(tile, block)`` pair list.  The CUDA kernel ``csrc/grouped_pairs.cu``
cuts each tile into sub-tiles of :func:`sub_tile` rays, one CUDA block
each, which walk their tile's segment of that list: a sub-tile stops once
every ray's best ``t`` is nearer than the next pair's entry distance, and
a ray tests a pair's block only if its own margined entry into the block
is no farther than its best ``t``.  :func:`grouped_pairs_plain` is its
plain version.

The answer is exact f32 with the lexicographic ``(t, tri)`` tie rule, so
it equals ``ops/closest_hit.trace_plain`` bit for bit on the CPU.

    python -m ensem3a_openclraytracer_tpu_torch.experiments.proto_grouped [--cpu]

runs :func:`main`: outdoor_1300 (61 triangle blocks), 65,536 rays leaving
random surface points in random directions (2,048 with ``--cpu``),
checked against ``trace_plain`` and, on the card, timed against
``ops/closest_hit.trace`` (the render path's closest hit).
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import NamedTuple

import torch

from ensem3a_openclraytracer_tpu_torch._device import DeviceLike
from ensem3a_openclraytracer_tpu_torch.experiments.common import MAX_RT, run_main
from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
from ensem3a_openclraytracer_tpu_torch.ops import launches
from ensem3a_openclraytracer_tpu_torch.ops.geometry import MAX_DIST

RT = 1024  # rays per tile of the schedule
SUB = 256  # rays per sub-tile: one CUDA block of SUB threads (csrc/grouped_pairs.cu's SUB)

# Launches of the CUDA kernel; only a launch on the card counts.
LAUNCHES = launches.counter({"grouped_pairs": ("grouped_pairs_kernel",)})


class Schedule(NamedTuple):
    """The visit schedule of one ray batch.  ``o, d [G*rt, 3]``: the rays in
    ``order`` (``coherent_order``), padded with zeros to whole tiles; ``n``
    real rays.  The flat pair list has ``G * B`` slots: pair ``s`` has tile
    ``tile_ids[s]``, block ``blk[s]``, ``first[s]`` (1 on a tile's first
    pair) and ``lod[s]``, the least entry distance of the tile's rays into
    the block.  Tile ``g`` owns slots ``offsets[g]:offsets[g+1]`` (at least
    one, ``lod = inf`` when no ray of the tile enters any block), in
    ascending ``lod``; slots from ``offsets[G]`` on are dead (parked on the
    last tile, block 0, ``lod = inf``).  ``pairs`` = ``offsets[G]``."""

    order: torch.Tensor
    o: torch.Tensor
    d: torch.Tensor
    n: int
    rt: int
    tile_ids: torch.Tensor
    blk: torch.Tensor
    first: torch.Tensor
    lod: torch.Tensor
    offsets: torch.Tensor
    pairs: torch.Tensor


def build_schedule(feats: ch.TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor,
                   rt: int = RT) -> Schedule:
    """The prototype's XLA schedule (``proto_grouped.py:94-146``) in tensor
    ops, on the rays' device, with the port's margined slab entry
    (``ch.block_entries``) in place of the prototype's unmargined one."""
    n = ray_o.shape[0]
    dev = ray_o.device
    nb = feats.block_bounds.shape[0]
    order = ch.coherent_order(ray_o, ray_d) if n else torch.zeros(0, dtype=torch.int64, device=dev)
    pad = (-n) % rt
    g = (n + pad) // rt
    o = torch.nn.functional.pad(ray_o.to(torch.float32)[order], (0, 0, 0, pad))
    d = torch.nn.functional.pad(ray_d.to(torch.float32)[order], (0, 0, 0, pad))
    entry = ch.block_entries(feats.block_bounds, o, d)  # [G*rt, B]
    entry[n:] = float("inf")  # padding rays enter nothing
    entry_t = entry.view(g, rt, nb).amin(dim=1)  # [G, B]
    perm = torch.argsort(entry_t, dim=1, stable=True)  # front to back; misses (inf) last
    counts = torch.clamp(torch.isfinite(entry_t).sum(dim=1), min=1)  # >= 1, as the prototype
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int32)
    s_total = g * nb
    sidx = torch.arange(s_total, dtype=torch.int32, device=dev)
    gid = torch.clamp(torch.searchsorted(offsets, sidx, right=True) - 1, 0, max(g - 1, 0))
    live = sidx < offsets[g]
    blk = perm[gid, torch.clamp(sidx - offsets[gid], 0, max(nb - 1, 0))]
    lod = torch.where(live, entry_t[gid, blk], torch.full((s_total,), float("inf"), device=dev))
    first = torch.cat([live[:1], gid[1:] != gid[:-1]]) & live
    return Schedule(
        order=order, o=o.contiguous(), d=d.contiguous(), n=n, rt=rt,
        tile_ids=torch.where(live, gid, g - 1).to(torch.int32),
        blk=torch.where(live, blk, 0).to(torch.int32), first=first.to(torch.int32),
        lod=lod.contiguous(), offsets=offsets, pairs=offsets[g].to(torch.int64),
    )


def sub_tile(rt: int) -> int:
    """Rays per sub-tile, as ``grouped_pairs_launch`` picks them for tiles
    of ``rt`` rays: the largest power of two that divides ``rt``, at most
    :data:`SUB`."""
    return min(SUB, rt & -rt)


def grouped_pairs_plain(feats: ch.TriFeatures, sched: Schedule,
                        stats: torch.Tensor | None = None, sub: int | None = None):
    """The kernel's plain version: ``(t, tri)`` of the schedule's rays, in
    its (sorted) order, ``[n]`` f32 and int32.  Each tile of ``rt`` rays is
    cut into sub-tiles of ``sub`` rays (default :func:`sub_tile`), and each
    sub-tile walks its tile's whole list.  Step ``j`` takes the ``j``-th
    pair of every sub-tile that still runs; a sub-tile runs while one of
    its rays has a best ``t`` not below the pair's ``lod`` (``lod`` only
    grows along a list, so a sub-tile that stops is done).  Each ray of a
    running sub-tile whose own margined entry into the pair's block
    (``ch.block_entries``) is ``<=`` its best ``t`` tests the block with
    ``ch.tri_t`` and keeps the lexicographic least ``(t, tri)``; a block
    that its ray enters beyond its best ``t`` holds no nearer hit, so the
    cull changes no result.  ``stats`` (int64 ``[2]``) receives the (ray,
    triangle) pairs tested and the block stagings, one per step of each
    running sub-tile."""
    n, rt = sched.n, sched.rt
    sub = sub_tile(rt) if sub is None else sub
    if sub <= 0 or rt % sub:
        raise ValueError(f"sub-tiles of {sub} rays do not divide tiles of {rt}")
    dev = sched.o.device
    g = sched.offsets.numel() - 1
    per = rt // sub
    h = g * per  # sub-tiles
    tp, nb = feats.edges.shape[-1], feats.block_bounds.shape[0]
    tile = min(ch.TRI_TILE, tp)
    entry = ch.block_entries(feats.block_bounds, sched.o, sched.d).view(h, sub, nb)
    r6, q4, d = ch.ray_features(sched.o.view(h, sub, 3), sched.d.view(h, sub, 3))
    live = (torch.arange(g * rt, device=dev) < n).view(h, sub)
    best_t = torch.full((h, sub), MAX_DIST, dtype=torch.float32, device=dev)
    best_i = torch.zeros((h, sub), dtype=torch.int64, device=dev)
    start = sched.offsets[:-1].long().repeat_interleave(per)
    counts = (sched.offsets[1:] - sched.offsets[:-1]).long().repeat_interleave(per)
    cols = torch.arange(tile, device=dev)
    pairs = stagings = 0
    for j in range(int(counts.max()) if sched.lod.numel() else 0):
        s = start + torch.clamp(counts - 1, max=j)
        lod = sched.lod[s]
        run = live & (j < counts)[:, None] & ~(best_t < lod[:, None])  # [H, sub]
        act = torch.nonzero(run.any(dim=1)).squeeze(1)
        if act.numel() == 0:
            break
        blk = sched.blk[s[act]].long()
        bt, bi = best_t[act], best_i[act]
        e = torch.gather(entry[act], 2, blk[:, None, None].expand(-1, sub, 1))[..., 0]
        ra = live[act] & (e <= bt)  # [A, sub]: the rays that test the block
        idx = blk[:, None] * tile + cols  # [A, tile]
        t = ch.tri_t(r6[act], q4[act], d[act], feats.edges[:, :, idx], feats.plane[:, idx],
                     feats.normal_d[:, idx])  # [A, sub, tile]
        tmin, arg = torch.min(t, dim=2)
        tri = torch.gather(idx, 1, arg)
        better = ra & ((tmin < bt) | ((tmin == bt) & (tri < bi)))
        best_t[act] = torch.where(better, tmin, bt)
        best_i[act] = torch.where(better, tri, bi)
        pairs += int(ra.sum()) * tile
        stagings += act.numel()
    if stats is not None:
        stats += torch.tensor([pairs, stagings], dtype=torch.int64, device=stats.device)
    res = ch._finish(best_t.view(-1)[:n], best_i.view(-1)[:n])
    return res.t, res.tri.to(torch.int32)


_KERNEL_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]  # ray_o, ray_d, n, rt
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3  # packed, bounds; tp, tile, nb
    + [ctypes.c_void_p] * 3 + [ctypes.c_int]  # offsets, blk, lod; tiles
    + [ctypes.c_void_p] * 4  # out_t, out_tri, stats, stream
)


@functools.cache
def _launcher():
    """The kernel's C entry point, built and typed on first use."""
    from ensem3a_openclraytracer_tpu_torch import _build

    fn = _build.load("grouped_pairs").grouped_pairs_launch
    fn.argtypes = _KERNEL_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch_plan(rt: int, tiles: int) -> dict:
    """The kernel's launch for ``tiles`` tiles of ``rt`` rays, as the card
    reports it: CUDA blocks, threads each, dynamic shared memory bytes each
    and CUDA blocks resident per SM."""
    from ensem3a_openclraytracer_tpu_torch import _build

    fn = _build.load("grouped_pairs").grouped_pairs_plan
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(rt, tiles, out)
    if err != 0:
        raise RuntimeError(f"grouped_pairs_plan failed: CUDA error {err}")
    return dict(zip(("grid", "threads", "smem_bytes", "blocks_per_sm"), out))


def grouped_pairs(feats: ch.TriFeatures, sched: Schedule, stats: torch.Tensor | None = None):
    """``(t, tri)`` of the schedule's rays (sorted order, ``[n]`` f32 and
    int32) through the CUDA kernel ``csrc/grouped_pairs.cu`` (sub-tiles of
    :func:`sub_tile` rays; needs ``feats.packed``) for a schedule on the
    card; a schedule on the CPU takes :func:`grouped_pairs_plain`.
    ``stats`` (int64 ``[2]``, optional) receives the (ray, triangle) pairs
    tested and the block stagings."""
    dev = sched.o.device
    if dev.type == "cpu":
        return grouped_pairs_plain(feats, sched, stats)
    if dev.type != "cuda":
        raise ValueError(f"grouped_pairs runs on cuda or cpu, not {dev}")
    n, rt = sched.n, sched.rt
    g = sched.offsets.numel() - 1
    if rt % 32 or not 32 <= rt <= MAX_RT:
        raise ValueError(f"the kernel takes tiles of 32 to {MAX_RT} rays in steps of 32, not {rt}")
    tp, tile, nb = ch.check_features(feats, dev)
    packed = ch.check_packed(feats, tp, dev)
    s_total = g * nb
    ch._check(sched.o, "o", (g * rt, 3), torch.float32, dev)
    ch._check(sched.d, "d", (g * rt, 3), torch.float32, dev)
    ch._check(sched.offsets, "offsets", (g + 1,), torch.int32, dev)
    ch._check(sched.blk, "blk", (s_total,), torch.int32, dev)
    ch._check(sched.lod, "lod", (s_total,), torch.float32, dev)
    if stats is not None:
        ch._check(stats, "stats", (2,), torch.int64, dev)
    out_t = torch.empty((n,), dtype=torch.float32, device=dev)
    out_tri = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out_t, out_tri
    if nb == 0:
        return out_t.fill_(MAX_DIST), out_tri.zero_()
    err = _launcher()(
        sched.o.data_ptr(), sched.d.data_ptr(), n, rt,
        packed.data_ptr(), feats.block_bounds.data_ptr(), tp, tile, nb,
        sched.offsets.data_ptr(), sched.blk.data_ptr(), sched.lod.data_ptr(), g,
        out_t.data_ptr(), out_tri.data_ptr(), None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"grouped_pairs kernel launch failed: CUDA error {err}")
    LAUNCHES["grouped_pairs"] += 1
    return out_t, out_tri


def unsort(sched: Schedule, t_s: torch.Tensor, tri_s: torch.Tensor):
    """``(t, tri int64, hit)`` of sorted results, back in the caller's order."""
    t = torch.empty_like(t_s)
    t[sched.order] = t_s
    tri = torch.empty_like(tri_s, dtype=torch.int64)
    tri[sched.order] = tri_s.to(torch.int64)
    return t, tri, t < ch.MISS_T


def trace_grouped(feats: ch.TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor,
                  stats: torch.Tensor | None = None, rt: int = RT, engine: str = "kernel"):
    """Closest hit ``(t, tri, hit, pairs)`` as the prototype returns it
    (``pairs``: the scheduled (tile, block) pairs, a 0-d tensor): the
    schedule, then the kernel on the card (or, on the CPU or with
    ``engine="plain"``, its plain version), then the results put back in
    the caller's order."""
    if engine not in ("kernel", "plain"):
        raise ValueError(f"unknown engine {engine!r}")
    sched = build_schedule(feats, ray_o.detach(), ray_d.detach(), rt)
    run = grouped_pairs_plain if engine == "plain" else grouped_pairs
    t, tri, hit = unsort(sched, *run(feats, sched, stats))
    return t, tri, hit, sched.pairs


def main(device: DeviceLike = None, n: int = 65536, n_cubes: int = 1300) -> dict:
    """The prototype's ``main`` (``common.run_main``) for :func:`trace_grouped`;
    also prints the scheduled (tile, block) pairs."""
    out, pairs = run_main("grouped", trace_grouped, device, n, n_cubes)
    out["pairs"] = int(pairs)
    print("pairs:", out["pairs"])
    return out


if __name__ == "__main__":
    cpu = "--cpu" in sys.argv
    main(device="cpu" if cpu else None, n=2048 if cpu else 65536)
