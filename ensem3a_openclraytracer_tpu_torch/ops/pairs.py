"""Closest hit of multi-block scenes by block queues: one persistent CUDA
launch per trace.

Counterpart of the JAX package's ``ops/pairs.py`` (``trace_pairs`` and
``trace_pairs_streamed``, whose Pallas kernels ``_tile_loop_kernel`` and
``_tile_stream_kernel`` carry 2-64 and more triangle blocks).  The answer is
that of ``ops/closest_hit.trace_plain``: exact f32, the lowest triangle
index among equal ``t``, ``t >= MAX_DIST * 0.999`` a miss.

The search runs in rounds.  Each live ray takes the next ``k`` blocks of
its front-to-back walk: the ``k`` least keys ``(entry bits << 32) | block``
above its cursor (the last key it queued) among the blocks whose margined
box it enters no farther than its best ``t`` (``closest_hit.block_entries``).
The (ray, block) pairs are grouped by block, each block is tested against
the rays queued on it (``closest_hit.tri_t``), and each ray keeps the least
``(t, tri)``.  A queued ray is tested only against the sub-tiles of
:data:`SUB` triangles of its block whose margined box
(``TriFeatures.sub_bounds``) it enters no farther than the best ``t`` its
select read that round; the others cannot hold a nearer hit.  A ray that had
more than ``k`` such blocks stays live.  On the card all rounds run in one
cooperative launch of ``csrc/pairs.cu`` (:func:`trace_pairs`);
:func:`trace_pairs_plain` runs the same rounds in tensor ops and equals
``trace_plain`` bit for bit.

A round of the kernel whose work items (a block and up to ``CHUNK`` of
its queued rays) are too few to fill the grid splits each item's triangles
into :func:`slices` ranges, each tested by its own CUDA block and folded by
the same exact minimum, so the answer and the counts do not change.  A
round whose rays are too few to fill the grid selects each ray's blocks
with a group of :func:`select_lanes` lanes, which split its slab tests and
queue its picks together; the picks, and so the answer and the counts, are
those of one thread a ray.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
from ensem3a_openclraytracer_tpu_torch.ops import launches
from ensem3a_openclraytracer_tpu_torch.ops.geometry import MAX_DIST
from ensem3a_openclraytracer_tpu_torch.ops.intersect import Hit

# Blocks each live ray takes per round, the one value the kernels are built
# for (csrc/pairs.cu, csrc/fused_queue.cu; trace_pairs_plain takes any k).  A
# round slab-tests every block (30 FP32 operations each) and tests up to K x
# 256 triangles (45 each), so the slab tests stay under a fifth of the pair
# tests up to ~600 blocks.
K = 8
CHUNK = 256  # queued rays per work item of the kernel (a block staging)
SUB = ch.SUB_TILE  # triangles per sub-tile of the test phase's cull (csrc/pairs.cuh bq::SUB)
SUBS = ch.TRI_TILE // SUB  # sub-tiles a block
S_MAX = 32  # most triangle slices of one work item (csrc/pairs.cuh bq::S_MAX)
G_MAX = 32  # most select lanes a ray: a warp (csrc/pairs.cuh bq::G_MAX)
AGG_BLOCKS = 1280  # most blocks of a scene whose select groups lanes (bq::AGG_BLOCKS)
# Most blocks whose bounds the select keeps in shared memory for a whole round;
# above, each batch of rays stages them in chunks of this many (bq::SEL_BLOCKS,
# which both libraries export: pairs_sel_blocks, fused_queue_sel_blocks).
SEL_BLOCKS = 1600
PAIR_CHUNK = 2048  # (ray, block) pairs per step of the plain version (bounds its memory)
# (float bits of MAX_DIST) << 32 | triangle 0: "no hit yet"
NO_HIT_KEY = int(torch.tensor(MAX_DIST, dtype=torch.float32).view(torch.int32)) << 32
_NO_KEY = torch.iinfo(torch.int64).max

# Launches of the CUDA kernel; only a launch on the card counts.
LAUNCHES = launches.counter({"pairs": ("pairs_kernel",)})


def key_t(key: torch.Tensor) -> torch.Tensor:
    """The ``t`` of ``(float bits of t) << 32 | tri`` keys."""
    return (key >> 32).to(torch.int32).view(torch.float32)


def _finish(best: torch.Tensor) -> Hit:
    return ch._finish(key_t(best), best & 0xFFFFFFFF)


def slices(items: int, grid: int) -> int:
    """The triangle slices of a round of ``items`` work items on a grid of
    ``grid`` CUDA blocks: the largest power of two up to :data:`S_MAX`
    with ``items * S <= grid``; 1 when the items alone fill the grid, or
    when there are none (``csrc/pairs.cuh`` ``bq::slices``)."""
    s = 1
    while items > 0 and 2 * s <= S_MAX and items <= grid // (2 * s):
        s *= 2
    return s


def select_lanes(n_live: int, nb: int, grid_threads: int) -> int:
    """The lanes G of each live ray's group in a select of ``n_live`` rays
    on ``nb`` triangle blocks over ``grid_threads`` threads: the largest
    power of two with ``G <= G_MAX``, ``G <= nb`` and ``n_live * G <=
    grid_threads``; 1 when none is larger, when no ray is live, or when
    ``nb > AGG_BLOCKS`` (``csrc/pairs.cuh`` ``bq::select_lanes``)."""
    g = 1
    while (n_live > 0 and nb <= AGG_BLOCKS and 2 * g <= G_MAX and 2 * g <= nb
           and n_live <= grid_threads // (2 * g)):
        g *= 2
    return g


def _test_pairs(feats: ch.TriFeatures, r6, q4, d, rid: torch.Tensor, blk: torch.Tensor,
                tile: int, lo: int = 0, hi: int | None = None,
                keep: torch.Tensor | None = None) -> torch.Tensor:
    """Per (ray, block) pair, the key of the ray's least ``(t, tri)`` among
    the block's triangles ``[lo, hi)`` (all of them by default) that lie in
    the sub-tiles ``keep [P, SUBS]`` marks (every one by default),
    ``NO_HIT_KEY`` where it hits nothing there short of ``MAX_DIST``."""
    hi = tile if hi is None else hi
    local = torch.arange(lo, hi, device=blk.device)
    idx = blk[:, None] * tile + local  # [P, hi - lo]
    t = ch.tri_t(r6[rid][:, None], q4[rid][:, None], d[rid][:, None], feats.edges[:, :, idx],
                 feats.plane[:, idx], feats.normal_d[:, idx])[:, 0]  # [P, tile]
    if keep is not None:
        t = torch.where(keep[:, local // SUB], t, torch.full_like(t, MAX_DIST))
    tmin, arg = torch.min(t, dim=1)
    tri = torch.gather(idx, 1, arg[:, None])[:, 0]
    key = (tmin.view(torch.int32).to(torch.int64) << 32) | tri
    return torch.where(tmin < MAX_DIST, key, torch.full_like(key, NO_HIT_KEY))


def sub_tile_cull(feats: ch.TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor,
                  rid: torch.Tensor, blk: torch.Tensor, sel_t: torch.Tensor):
    """The test phase's cull of (ray, block) pairs ``(rid, blk)``: ``(keep,
    real)``, each ``[P, SUBS]`` bool.  ``real`` marks the block's sub-tiles
    that hold a triangle (a padding-only one has an inverted box); ``keep``
    those whose margined box the ray enters no farther than ``sel_t[rid]``,
    the best ``t`` its select read this round (``csrc/pairs.cuh``'s
    ``sel_t``)."""
    boxes = feats.sub_bounds.view(-1, SUBS, 8)[blk]  # [P, SUBS, 8]
    entry = ch.block_entries(boxes, ray_o[rid], ray_d[rid])
    return entry <= sel_t[rid][:, None], boxes[..., 0] <= boxes[..., 3]


def trace_pairs_plain(feats: ch.TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor,
                      k: int = K, stats: torch.Tensor | None = None,
                      queues: List[Tuple[torch.Tensor, torch.Tensor]] | None = None) -> Hit:
    """The kernel's plain version: the same rounds in tensor ops, with a
    host sync per round.  ``stats`` (int64 ``[4]`` or ``[6]``, optional)
    receives what the kernel counts: (ray, triangle) pairs tested, block
    stagings (work items of up to ``CHUNK`` queued rays), rounds and slab
    tests, then with six slots the (ray, sub-tile) entries of the queued
    pairs whose sub-tile holds a triangle and those of them kept by the
    cull (``csrc/fused_queue.cu``'s ``subtiles_offered`` and
    ``subtiles_tested``).  A kept entry tests its sub-tile's triangles
    within the tile, ``SUB`` of them on every full tile.  ``queues`` (a
    list, optional) receives each round's ``(rays, blocks)`` pairs."""
    if k < 1:
        raise ValueError(f"k must be at least 1, not {k}")
    if stats is not None and stats.shape not in ((4,), (6,)):
        raise ValueError(f"stats: want 4 or 6 slots, got {tuple(stats.shape)}")
    o = ray_o.detach().to(torch.float32).contiguous()
    d = ray_d.detach().to(torch.float32).contiguous()
    n, nb = o.shape[0], feats.block_bounds.shape[0]
    dev = o.device
    best = torch.full((n,), NO_HIT_KEY, dtype=torch.int64, device=dev)
    if n == 0 or nb == 0:
        return _finish(best)
    tile = feats.edges.shape[-1] // nb
    sub_w = torch.clamp(tile - SUB * torch.arange(SUBS, device=dev), 0, SUB)  # within the tile
    r6, q4, dd = ch.ray_features(o, d)
    entry = ch.block_entries(feats.block_bounds, o, d)  # [N, B]
    keys = ((entry.view(torch.int32).to(torch.int64) << 32)
            | torch.arange(nb, device=dev))  # (entry bits << 32) | block
    cursor = torch.full((n,), -1, dtype=torch.int64, device=dev)  # keys are >= 0
    live = torch.arange(n, device=dev)
    counts = [0] * 6
    while live.numel():
        counts[2] += 1
        counts[3] += live.numel() * nb
        sel_t = key_t(best)  # what each live ray's select reads this round
        qual = (entry[live] <= sel_t[live][:, None]) & (keys[live] > cursor[live, None])
        nq = qual.sum(dim=1)
        pick = torch.topk(torch.where(qual, keys[live], _NO_KEY), min(k, nb), dim=1,
                          largest=False).values  # sorted ascending
        took = pick != _NO_KEY
        last = torch.gather(pick, 1, torch.clamp(torch.clamp(nq, max=k) - 1, min=0)[:, None])[:, 0]
        cursor[live] = torch.where(nq > 0, last, cursor[live])
        rid = live[:, None].expand_as(pick)[took]
        blk = pick[took] & 0xFFFFFFFF
        if queues is not None:
            queues.append((rid, blk))
        for c in range(0, rid.numel(), PAIR_CHUNK):
            r, b = rid[c:c + PAIR_CHUNK], blk[c:c + PAIR_CHUNK]
            keep, real = sub_tile_cull(feats, o, d, r, b, sel_t)
            best.scatter_reduce_(0, r, _test_pairs(feats, r6, q4, dd, r, b, tile, keep=keep),
                                 "amin")
            counts[0] += int((keep * sub_w).sum())
            counts[4] += int(real.sum())
            counts[5] += int(keep.sum())
        per_block = torch.bincount(blk, minlength=nb)
        counts[1] += int(((per_block + CHUNK - 1) // CHUNK).sum())
        live = live[nq > k]
    if stats is not None:
        stats += torch.tensor(counts[:stats.shape[0]], dtype=torch.int64, device=stats.device)
    return _finish(best)


_KERNEL_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]  # ray_o, ray_d, n
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3  # packed, bounds, sub_bounds; tp, tile, nb
    + [ctypes.c_void_p] * 6  # scratch, out_t, out_tri, out_hit, stats, stream
)


@functools.cache
def _lib():
    """The kernel's library with its C entry points typed, built on first
    use."""
    from ensem3a_openclraytracer_tpu_torch import _build

    lib = _build.load("pairs")
    lib.pairs_launch.argtypes = _KERNEL_ARGTYPES
    lib.pairs_launch.restype = ctypes.c_int
    lib.pairs_scratch_bytes.argtypes = [ctypes.c_int] * 2
    lib.pairs_scratch_bytes.restype = ctypes.c_longlong
    lib.pairs_grid.argtypes = [ctypes.c_void_p]
    lib.pairs_grid.restype = ctypes.c_int
    lib.pairs_slices.argtypes = [ctypes.c_int] * 2
    lib.pairs_slices.restype = ctypes.c_int
    lib.pairs_select_lanes.argtypes = [ctypes.c_int] * 3
    lib.pairs_select_lanes.restype = ctypes.c_int
    return lib


def kernel_grid() -> dict:
    """The launch's grid on the current card: CUDA blocks per SM (the
    occupancy API's count), SMs, registers per thread, threads per CUDA
    block and dynamic shared memory per CUDA block."""
    out = (ctypes.c_int * 5)()
    err = _lib().pairs_grid(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"pairs kernel: no cooperative grid (CUDA error {err})")
    return dict(zip(("blocks_per_sm", "sms", "registers", "threads", "smem_bytes"), out))


def trace_pairs(feats: ch.TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor,
                stats: torch.Tensor | None = None) -> Hit:
    """Closest hit ``(t, tri, hit)`` through the CUDA kernel
    ``csrc/pairs.cu`` for rays on the card: one cooperative launch for a
    non-empty batch, nothing read back.  Rays on the CPU take
    :func:`trace_pairs_plain`.  ``stats`` (int64 ``[4]`` on the card,
    optional) receives the (ray, triangle) pairs tested, the block
    stagings, the rounds and the slab tests, added to what it holds."""
    if ray_o.device.type == "cpu":
        return trace_pairs_plain(feats, ray_o, ray_d, k=K, stats=stats)
    if ray_o.device.type != "cuda":
        raise ValueError(f"trace_pairs runs on cuda or cpu, not {ray_o.device}")
    dev = ray_o.device
    n = ray_o.shape[0]
    tp, tile, nb = ch.check_features(feats, dev)
    ch.check_packed(feats, tp, dev)
    ch.check_sub_bounds(feats, nb, dev)
    ch._check(ray_o, "ray_o", (n, 3), torch.float32, dev)
    ch._check(ray_d, "ray_d", (n, 3), torch.float32, dev)
    if stats is not None:
        ch._check(stats, "stats", (4,), torch.int64, dev)
    if n * K >= 2 ** 31:
        raise ValueError(f"{n} rays x {K} picks overflow the kernel's int32 queue")
    if n == 0 or nb == 0:
        return Hit(t=torch.full((n,), MAX_DIST, dtype=torch.float32, device=dev),
                   tri=torch.zeros((n,), dtype=torch.int64, device=dev),
                   hit=torch.zeros((n,), dtype=torch.bool, device=dev))
    out_t = torch.empty((n,), dtype=torch.float32, device=dev)
    out_tri = torch.empty((n,), dtype=torch.int64, device=dev)
    out_hit = torch.empty((n,), dtype=torch.bool, device=dev)
    lib = _lib()
    scratch = torch.empty((lib.pairs_scratch_bytes(n, nb),), dtype=torch.uint8, device=dev)
    err = lib.pairs_launch(
        ray_o.data_ptr(), ray_d.data_ptr(), n, feats.packed.data_ptr(),
        feats.block_bounds.data_ptr(), feats.sub_bounds.data_ptr(), tp, tile, nb,
        scratch.data_ptr(),
        out_t.data_ptr(), out_tri.data_ptr(), out_hit.data_ptr(),
        None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pairs kernel launch failed: CUDA error {err}")
    LAUNCHES["pairs"] += 1
    return Hit(t=out_t, tri=out_tri, hit=out_hit)
