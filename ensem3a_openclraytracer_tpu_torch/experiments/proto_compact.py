"""Prototype: closest hit by rounds of per-ray pair compaction.

Counterpart of the JAX package's ``experiments/proto_compact.py`` (and of
the scripts ``experiments/bench_pieces2.py`` and
``experiments/profile_compact2.py``, which launch the same kernel; see
:func:`profile`).  Each ray slab-tests every triangle block (margined, as
``ops/closest_hit.block_entries``) and sorts the blocks it enters front to
back (:func:`precompute`).  Then rounds run until no ray is live: each
round takes the next ``k`` blocks of every live ray whose entry is not
beyond the ray's best ``t``, groups the (ray, block) pairs by block into
queues padded to tiles of ``rt`` slots (:func:`build_round_queues`), tests
every queue tile against its block (the CUDA kernel
``csrc/pair_compact.cu``, or :func:`pair_compact_plain`), and keeps each
ray's least ``(t, tri)`` (:func:`combine`).  A ray stays live while its
next block's entry is not beyond its best ``t``.

The answer is exact f32 with the lexicographic ``(t, tri)`` tie rule, so
it equals ``ops/closest_hit.trace_plain`` bit for bit on the CPU.

    python -m ensem3a_openclraytracer_tpu_torch.experiments.proto_compact [--cpu] [--profile]

runs :func:`main` (outdoor_1300, 65,536 rays; 2,048 with ``--cpu``) or, on
the card, :func:`profile`.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import List, NamedTuple

import torch

from ensem3a_openclraytracer_tpu_torch._device import DeviceLike, resolve_device
from ensem3a_openclraytracer_tpu_torch.experiments.common import (
    MAX_RT,
    bounce_rays,
    cuda_median_ms,
    run_main,
)
from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
from ensem3a_openclraytracer_tpu_torch.ops.geometry import MAX_DIST

RT = 1024  # slots per queue tile: one CUDA block of RT threads
K = 4  # blocks visited per ray per round
# The key of "no hit": (float bits of MAX_DIST) << 32 | triangle 0.
NO_HIT_KEY = int(torch.tensor(MAX_DIST, dtype=torch.float32).view(torch.int32)) << 32
TILE_CHUNK = 64  # queue tiles per step of the plain version (bounds its memory)

# Launches of the CUDA kernel (one per round); only a launch on the card counts.
LAUNCHES = {"pair_compact": 0}


class Visit(NamedTuple):
    """Per ray, the blocks it enters front to back: ``entry_sorted [N, B]``
    (``inf`` past the last), ``perm [N, B]`` the block indices, ``counts
    [N]`` how many it enters."""

    entry_sorted: torch.Tensor
    perm: torch.Tensor
    counts: torch.Tensor


class Queues(NamedTuple):
    """One round's work: ``queue_rid [tiles * rt]`` int64, the ray of each
    slot (``n`` on a padding slot), grouped by block, each block's run
    padded to whole tiles; ``tile_blk [tiles]`` int32 each tile's block;
    ``tile_live [tiles]`` int32, 1 where the tile holds a real pair."""

    queue_rid: torch.Tensor
    tile_blk: torch.Tensor
    tile_live: torch.Tensor


def precompute(feats: ch.TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor) -> Visit:
    """The per-ray slab test and sort (``proto_compact.py:118-134``)."""
    entry = ch.block_entries(feats.block_bounds, ray_o, ray_d)  # [N, B]
    entry_sorted, perm = torch.sort(entry, dim=1, stable=True)
    return Visit(entry_sorted, perm, torch.isfinite(entry).sum(dim=1))


def queue_tiles(n: int, nb: int, k: int, rt: int) -> int:
    """Queue tiles a round may need: ``n * k`` pairs, each block's run
    padded to whole tiles (the prototype's ``q_slots = N*K + B*RT``)."""
    return -(-n * k // rt) + nb


def key_t(key: torch.Tensor) -> torch.Tensor:
    """The ``t`` of ``(float bits of t) << 32 | tri`` keys."""
    return (key >> 32).to(torch.int32).view(torch.float32)


def build_round_queues(visit: Visit, ptr: torch.Tensor, best_t: torch.Tensor, k: int,
                       rt: int, tiles: int) -> Queues:
    """One round's queues (``proto_compact.py:167-206``): the next ``k``
    blocks of every ray, dropped past its count or where the entry is
    beyond its best ``t``; a stable sort of the pairs by block; per-block
    counts padded to ``rt``; the scatter of ray ids into their slots; each
    tile's block and live flag."""
    n, nb = visit.perm.shape
    dev = ptr.device
    q_slots = tiles * rt
    idx = ptr[:, None] + torch.arange(k, device=dev)  # [N, k]
    jj = torch.clamp(idx, max=nb - 1)
    pb = torch.gather(visit.perm, 1, jj)
    pe = torch.gather(visit.entry_sorted, 1, jj)
    valid = (idx < visit.counts[:, None]) & (pe <= best_t[:, None])
    pb_flat = torch.where(valid, pb, nb).reshape(-1)  # [N*k]; nb = no pair
    pb_sorted, pos = torch.sort(pb_flat, stable=True)
    rid_sorted = pos // k
    cnt = torch.bincount(pb_flat, minlength=nb + 1)[:nb]
    padded = (cnt + (rt - 1)) // rt * rt
    zero = cnt.new_zeros(1)
    pad_start = torch.cat([zero, torch.cumsum(padded, 0)])
    raw_start = torch.cat([zero, torch.cumsum(cnt, 0)])
    pbc = torch.clamp(pb_sorted, max=nb - 1)
    within = torch.arange(n * k, device=dev) - raw_start[pbc]
    qpos = torch.where(pb_sorted < nb, pad_start[pbc] + within, q_slots)  # q_slots: dump slot
    queue_rid = torch.full((q_slots + 1,), n, dtype=torch.int64, device=dev)
    queue_rid[qpos] = rid_sorted
    tile_start = torch.arange(tiles, device=dev) * rt
    tile_blk = torch.clamp(torch.searchsorted(pad_start, tile_start, right=True) - 1, 0, nb - 1)
    tile_live = tile_start < pad_start[tile_blk] + cnt[tile_blk]
    return Queues(queue_rid[:q_slots], tile_blk.to(torch.int32), tile_live.to(torch.int32))


def pair_compact_plain(feats: ch.TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor,
                       q: Queues, stats: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's plain version: per queue slot, the key ``(float bits of
    t) << 32 | tri`` of the least ``(t, tri)`` of its ray against its
    tile's block (``ch.tri_t``), ``NO_HIT_KEY`` on a padding slot or a dead
    tile.  ``stats`` (int64 ``[2]``) receives the (ray, triangle) pairs
    tested and the block stagings."""
    n = ray_o.shape[0]
    tiles = q.tile_blk.numel()
    rt = q.queue_rid.numel() // max(tiles, 1)
    dev = ray_o.device
    tile = min(ch.TRI_TILE, feats.edges.shape[-1])
    r6, q4, d = ch.ray_features(torch.cat([ray_o, ray_o.new_zeros(1, 3)]),
                                torch.cat([ray_d, ray_d.new_zeros(1, 3)]))  # row n: padding
    keys = torch.full((tiles, rt), NO_HIT_KEY, dtype=torch.int64, device=dev)
    rid = q.queue_rid.view(tiles, rt)
    live = torch.nonzero(q.tile_live).squeeze(1)
    cols = torch.arange(tile, device=dev)
    for c in range(0, live.numel(), TILE_CHUNK):
        act = live[c:c + TILE_CHUNK]
        idx = q.tile_blk[act].long()[:, None] * tile + cols  # [A, tile]
        r = rid[act]
        t = ch.tri_t(r6[r], q4[r], d[r], feats.edges[:, :, idx], feats.plane[:, idx],
                     feats.normal_d[:, idx])  # [A, rt, tile]
        tmin, arg = torch.min(t, dim=2)
        tri = torch.where(tmin < MAX_DIST, torch.gather(idx, 1, arg), 0)
        tmin = torch.where(r < n, torch.clamp(tmin, max=MAX_DIST), MAX_DIST)
        keys[act] = (tmin.view(torch.int32).to(torch.int64) << 32) | torch.where(r < n, tri, 0)
    if stats is not None:
        pairs = int((rid[live] < n).sum()) * tile
        stats += torch.tensor([pairs, live.numel()], dtype=torch.int64, device=stats.device)
    return keys.view(-1)


_KERNEL_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]  # ray_o, ray_d, n
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3  # edges, plane, normal_d, bounds; tp, tile, nb
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2  # queue_rid, tile_blk, tile_live; tiles, rt
    + [ctypes.c_void_p] * 3  # out_key, stats, stream
)


@functools.cache
def _launcher():
    """The kernel's C entry point, built and typed on first use."""
    from ensem3a_openclraytracer_tpu_torch import _build

    fn = _build.load("pair_compact").pair_compact_launch
    fn.argtypes = _KERNEL_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def pair_compact(feats: ch.TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor, q: Queues,
                 stats: torch.Tensor | None = None, out: torch.Tensor | None = None):
    """Per-slot keys of one round (see :func:`pair_compact_plain`) through
    the CUDA kernel ``csrc/pair_compact.cu`` for rays on the card, into
    ``out`` (int64 ``[tiles * rt]``) when given; rays on the CPU take the
    plain version.  ``stats`` (int64 ``[2]``, optional) receives the
    (ray, triangle) pairs tested and the block stagings."""
    dev = ray_o.device
    if dev.type == "cpu":
        return pair_compact_plain(feats, ray_o, ray_d, q, stats)
    if dev.type != "cuda":
        raise ValueError(f"pair_compact runs on cuda or cpu, not {dev}")
    n = ray_o.shape[0]
    tiles = q.tile_blk.numel()
    rt = q.queue_rid.numel() // max(tiles, 1)
    if rt % 32 or not 32 <= rt <= MAX_RT:
        raise ValueError(f"the kernel takes tiles of 32 to {MAX_RT} slots in steps of 32, not {rt}")
    tp, tile, nb = ch.check_features(feats, dev)
    ch._check(ray_o, "ray_o", (n, 3), torch.float32, dev)
    ch._check(ray_d, "ray_d", (n, 3), torch.float32, dev)
    ch._check(q.queue_rid, "queue_rid", (tiles * rt,), torch.int64, dev)
    ch._check(q.tile_blk, "tile_blk", (tiles,), torch.int32, dev)
    ch._check(q.tile_live, "tile_live", (tiles,), torch.int32, dev)
    if stats is not None:
        ch._check(stats, "stats", (2,), torch.int64, dev)
    if out is None:
        out = torch.empty((tiles * rt,), dtype=torch.int64, device=dev)
    ch._check(out, "out", (tiles * rt,), torch.int64, dev)
    if tiles == 0:
        return out
    err = _launcher()(
        ray_o.data_ptr(), ray_d.data_ptr(), n,
        feats.edges.data_ptr(), feats.plane.data_ptr(), feats.normal_d.data_ptr(),
        feats.block_bounds.data_ptr(), tp, tile, nb,
        q.queue_rid.data_ptr(), q.tile_blk.data_ptr(), q.tile_live.data_ptr(), tiles, rt,
        out.data_ptr(), None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pair_compact kernel launch failed: CUDA error {err}")
    LAUNCHES["pair_compact"] += 1
    return out


def combine(best_key: torch.Tensor, keys: torch.Tensor, queue_rid: torch.Tensor) -> torch.Tensor:
    """Per ray, the least key of its slots and its best so far, in place:
    ``best_key [N + 1]`` (row ``N`` takes the padding slots).  The key
    orders ``(t, tri)`` lexicographically, since ``t >= 0``."""
    return best_key.scatter_reduce_(0, queue_rid, keys, "amin")


def trace_compact(feats: ch.TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor, k: int = K,
                  rt: int = RT, stats: torch.Tensor | None = None, engine: str = "kernel",
                  queues: List[Queues] | None = None):
    """Closest hit ``(t, tri, hit, rounds)`` by rounds of pair compaction.
    The rounds, one kernel launch each, loop in Python with one host sync
    per round (``bool(live.any())``; the prototype's ``while_loop``).  On
    the card the kernel runs unless ``engine="plain"``; on the CPU its
    plain version.  ``queues`` (a list, optional) receives each round's
    :class:`Queues`."""
    if engine not in ("kernel", "plain"):
        raise ValueError(f"unknown engine {engine!r}")
    run = pair_compact_plain if engine == "plain" else pair_compact
    o = ray_o.detach().to(torch.float32).contiguous()
    d = ray_d.detach().to(torch.float32).contiguous()
    n, nb = o.shape[0], feats.block_bounds.shape[0]
    dev = o.device
    best_key = torch.full((n + 1,), NO_HIT_KEY, dtype=torch.int64, device=dev)
    rounds = 0
    if n and nb:
        visit = precompute(feats, o, d)
        tiles = queue_tiles(n, nb, k, rt)
        out = torch.empty((tiles * rt,), dtype=torch.int64, device=dev)  # once per trace
        ptr = torch.zeros(n, dtype=torch.int64, device=dev)
        live = visit.counts > 0
        while bool(live.any()):
            best_t = key_t(best_key[:n])
            q = build_round_queues(visit, ptr, best_t, k, rt, tiles)
            if queues is not None:
                queues.append(q)
            kw = {} if run is pair_compact_plain else {"out": out}
            combine(best_key, run(feats, o, d, q, stats, **kw), q.queue_rid)
            rounds += 1
            ptr = torch.minimum(ptr + k, visit.counts)
            nxt = torch.gather(visit.entry_sorted, 1, torch.clamp(ptr, max=nb - 1)[:, None])[:, 0]
            live = (ptr < visit.counts) & (nxt <= key_t(best_key[:n]))
    t = key_t(best_key[:n])
    tri = best_key[:n] & 0xFFFFFFFF
    h = ch._finish(t, tri)
    return h.t, h.tri, h.hit, rounds


def profile(feats: ch.TriFeatures | None = None, ray_o: torch.Tensor | None = None,
            ray_d: torch.Tensor | None = None, k: int = K, rt: int = RT, runs: int = 5,
            device: DeviceLike = None, n: int = 65536) -> dict:
    """Per-piece times of the round loop on the card (``proto_compact.py
    :319-438``; what ``bench_pieces2.py`` and ``profile_compact2.py``
    measured with the same kernel), each the median of ``runs`` calls
    timed with CUDA events: the slab test and sort, one round's queue
    build, the pair kernel and the combine, all of the first round.  On
    outdoor_1300 and :func:`bounce_rays` unless ``feats`` and rays are
    given."""
    if feats is None:
        from ensem3a_openclraytracer_tpu_torch import testing as tt

        geom = tt.make_outdoor_scene(n_cubes=1300, device=resolve_device(device))[0]
        feats = geom.feats
        ray_o, ray_d = bounce_rays(geom, n)
    if ray_o.device.type != "cuda":
        raise ValueError("profile times the card: give it rays on cuda")
    n, nb = ray_o.shape[0], feats.block_bounds.shape[0]
    tiles = queue_tiles(n, nb, k, rt)
    out = dict(pre_ms=cuda_median_ms(lambda: precompute(feats, ray_o, ray_d), runs))
    visit = precompute(feats, ray_o, ray_d)
    ptr = torch.zeros(n, dtype=torch.int64, device=ray_o.device)
    best_t = torch.full((n,), MAX_DIST, device=ray_o.device)
    out["queue_ms"] = cuda_median_ms(
        lambda: build_round_queues(visit, ptr, best_t, k, rt, tiles), runs)
    q = build_round_queues(visit, ptr, best_t, k, rt, tiles)
    keys = torch.empty((tiles * rt,), dtype=torch.int64, device=ray_o.device)
    out["kernel_ms"] = cuda_median_ms(lambda: pair_compact(feats, ray_o, ray_d, q, out=keys), runs)
    best_key = torch.full((n + 1,), NO_HIT_KEY, dtype=torch.int64, device=ray_o.device)
    out["combine_ms"] = cuda_median_ms(lambda: combine(best_key.clone(), keys, q.queue_rid), runs)
    out.update(counts_mean=float(visit.counts.float().mean()), counts_max=int(visit.counts.max()),
               live_tiles=int(q.tile_live.sum()), tiles=tiles)
    print(f"pre (slab+sort): {out['pre_ms']:.3f} ms; counts: mean {out['counts_mean']:.2f} "
          f"max {out['counts_max']}; queue build: {out['queue_ms']:.3f} ms; live tiles: "
          f"{out['live_tiles']} of {tiles}; pair kernel: {out['kernel_ms']:.3f} ms; "
          f"combine: {out['combine_ms']:.3f} ms")
    return out


def main(device: DeviceLike = None, n: int = 65536, n_cubes: int = 1300) -> dict:
    """The prototype's ``main`` (``common.run_main``) for
    :func:`trace_compact`; also prints the rounds."""
    out, rounds = run_main("compact", trace_compact, device, n, n_cubes)
    out["rounds"] = rounds
    print("rounds:", rounds)
    return out


if __name__ == "__main__":
    cpu = "--cpu" in sys.argv
    if "--profile" in sys.argv:
        profile(device="cpu" if cpu else None)
    else:
        main(device="cpu" if cpu else None, n=2048 if cpu else 65536)
