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
every queue slot against its tile's block and lowers its ray's best key
(the CUDA kernel ``csrc/pair_compact.cu``, which cuts each tile into
sub-tiles of :func:`sub_tile` slots, or :func:`pair_compact_plain`, which
writes a key per slot and folds them with :func:`combine`).  A ray stays
live while its next block's entry is not beyond its best ``t``.

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
from typing import Callable, List, NamedTuple

import torch

from ensem3a_openclraytracer_tpu_torch._device import DeviceLike, resolve_device
from ensem3a_openclraytracer_tpu_torch.experiments.common import (
    MAX_RT,
    bounce_rays,
    cuda_median_ms,
    run_main,
)
from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
from ensem3a_openclraytracer_tpu_torch.ops import launches
from ensem3a_openclraytracer_tpu_torch.ops.geometry import MAX_DIST

RT = 1024  # slots per queue tile
SUB = 128  # slots per sub-tile, at most: one CUDA block each (csrc/pair_compact.cu's SUB)
K = 4  # blocks visited per ray per round
# The key of "no hit": (float bits of MAX_DIST) << 32 | triangle 0.
NO_HIT_KEY = int(torch.tensor(MAX_DIST, dtype=torch.float32).view(torch.int32)) << 32
TILE_CHUNK = 64  # queue tiles per step of the plain version (bounds its memory)

# Launches of the CUDA kernel (one per round); only a launch on the card counts.
LAUNCHES = launches.counter({"pair_compact": ("pair_compact_kernel",)})


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
    padded to whole tiles with its real slots first; ``tile_blk [tiles]``
    int32 each tile's block; ``tile_live [tiles]`` int32, 1 where the tile
    holds a real pair."""

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
    pb_flat = torch.where(valid, pb, nb).to(torch.int32).reshape(-1)  # [N*k]; nb = no pair
    pb_sorted, pos = torch.sort(pb_flat, stable=True)
    rid_sorted = pos // k
    # per-block counts without bincount, which reads the input's max back to the host on cuda
    cnt = torch.zeros(nb + 1, dtype=torch.int64, device=dev).index_add_(
        0, pb_flat, torch.ones_like(pb_flat, dtype=torch.int64))[:nb]
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


def sub_tile(rt: int) -> int:
    """Slots per sub-tile, as ``pair_compact_launch`` cuts tiles of ``rt``
    slots: the largest multiple of 32 that divides ``rt``, at most
    :data:`SUB` (so ``min(SUB, rt)`` for ``rt <= SUB`` or a multiple of
    it)."""
    return next((s for s in range(SUB, 31, -32) if rt % s == 0), 32)


def _runs(q: Queues, n: int, sub: int) -> torch.Tensor:
    """``[tiles, rt]`` bool: the slots that the kernel tests, the real slots
    of every sub-tile whose tile is live and whose first slot is real (the
    others leave at once)."""
    tiles = q.tile_blk.numel()
    rid = q.queue_rid.view(tiles, -1)
    real = (rid >= 0) & (rid < n)
    go = q.tile_live.bool()[:, None] & real[:, ::sub]  # [tiles, rt / sub]
    return go.repeat_interleave(sub, dim=1) & real


def slot_keys_plain(feats: ch.TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor, q: Queues,
                    stats: torch.Tensor | None = None) -> torch.Tensor:
    """One key per queue slot, ``[tiles * rt]`` int64: ``(float bits of t)
    << 32 | tri`` of the least ``(t, tri)`` of the slot's ray against its
    tile's block (``ch.tri_t``), ``NO_HIT_KEY`` on a slot that the kernel
    does not test (see :func:`_runs`) or that hits nothing.  ``stats``
    (int64 ``[2]``) receives, as the kernel counts them, the (ray,
    triangle) pairs tested and the block stagings, one per sub-tile of
    :func:`sub_tile` slots that runs."""
    n = ray_o.shape[0]
    tiles = q.tile_blk.numel()
    rt = q.queue_rid.numel() // max(tiles, 1)
    dev = ray_o.device
    tile = min(ch.TRI_TILE, feats.edges.shape[-1])
    r6, q4, d = ch.ray_features(torch.cat([ray_o, ray_o.new_zeros(1, 3)]),
                                torch.cat([ray_d, ray_d.new_zeros(1, 3)]))  # row n: padding
    keys = torch.full((tiles, rt), NO_HIT_KEY, dtype=torch.int64, device=dev)
    if tiles == 0:
        return keys.view(-1)
    sub = sub_tile(rt)
    runs = _runs(q, n, sub)
    rid = torch.where(runs, q.queue_rid.view(tiles, rt), n)
    live = torch.nonzero(runs.any(dim=1)).squeeze(1)
    cols = torch.arange(tile, device=dev)
    for c in range(0, live.numel(), TILE_CHUNK):
        act = live[c:c + TILE_CHUNK]
        idx = q.tile_blk[act].long()[:, None] * tile + cols  # [A, tile]
        r = rid[act]
        t = ch.tri_t(r6[r], q4[r], d[r], feats.edges[:, :, idx], feats.plane[:, idx],
                     feats.normal_d[:, idx])  # [A, rt, tile]
        tmin, arg = torch.min(t, dim=2)
        hit = (r < n) & (tmin < MAX_DIST)
        tri = torch.where(hit, torch.gather(idx, 1, arg), 0)
        tmin = torch.where(hit, tmin, MAX_DIST)
        keys[act] = (tmin.view(torch.int32).to(torch.int64) << 32) | tri
    if stats is not None:
        stagings = int(runs[:, ::sub].sum())
        stats += torch.tensor([int(runs.sum()) * tile, stagings], dtype=torch.int64,
                              device=stats.device)
    return keys.view(-1)


def combine(best_key: torch.Tensor, keys: torch.Tensor, queue_rid: torch.Tensor) -> torch.Tensor:
    """Per ray, the least key of its slots and its best so far, in place:
    ``best_key [N + 1]`` (row ``N`` takes the padding slots).  The key
    orders ``(t, tri)`` lexicographically, since ``t >= 0``."""
    return best_key.scatter_reduce_(0, queue_rid, keys, "amin")


def pair_compact_plain(feats: ch.TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor,
                       q: Queues, best_key: torch.Tensor,
                       stats: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's plain version: one round's keys per slot
    (:func:`slot_keys_plain`, which also counts into ``stats``), folded into
    ``best_key [N + 1]`` in place by :func:`combine`.  Returns
    ``best_key``."""
    return combine(best_key, slot_keys_plain(feats, ray_o, ray_d, q, stats), q.queue_rid)


_KERNEL_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]  # ray_o, ray_d, n
    + [ctypes.c_void_p] + [ctypes.c_int] * 3  # packed; tp, tile, nb
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2  # queue_rid, tile_blk, tile_live; tiles, rt
    + [ctypes.c_void_p] * 3  # best_key, stats, stream
)


@functools.cache
def _launcher():
    """The kernel's C entry point, built and typed on first use."""
    from ensem3a_openclraytracer_tpu_torch import _build

    fn = _build.load("pair_compact").pair_compact_launch
    fn.argtypes = _KERNEL_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch_plan(rt: int, tiles: int) -> dict:
    """The kernel's launch for ``tiles`` queue tiles of ``rt`` slots, as the
    card reports it: CUDA blocks, threads each, dynamic shared memory bytes
    each and CUDA blocks resident per SM."""
    from ensem3a_openclraytracer_tpu_torch import _build

    fn = _build.load("pair_compact").pair_compact_plan
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(rt, tiles, out)
    if err != 0:
        raise RuntimeError(f"pair_compact_plan failed: CUDA error {err}")
    return dict(zip(("grid", "threads", "smem_bytes", "blocks_per_sm"), out))


def pair_compact(feats: ch.TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor, q: Queues,
                 best_key: torch.Tensor, stats: torch.Tensor | None = None) -> torch.Tensor:
    """One round folded into ``best_key [N + 1]`` in place (see
    :func:`pair_compact_plain`) by the CUDA kernel ``csrc/pair_compact.cu``
    for rays on the card (needs ``feats.packed``); rays on the CPU take the
    plain version.  ``stats`` (int64 ``[2]``, optional) receives the (ray,
    triangle) pairs tested and the block stagings.  Returns ``best_key``."""
    dev = ray_o.device
    if dev.type == "cpu":
        return pair_compact_plain(feats, ray_o, ray_d, q, best_key, stats)
    if dev.type != "cuda":
        raise ValueError(f"pair_compact runs on cuda or cpu, not {dev}")
    n = ray_o.shape[0]
    tiles = q.tile_blk.numel()
    rt = q.queue_rid.numel() // max(tiles, 1)
    if rt % 32 or not 32 <= rt <= MAX_RT:
        raise ValueError(f"the kernel takes tiles of 32 to {MAX_RT} slots in steps of 32, not {rt}")
    tp, tile, nb = ch.check_features(feats, dev)
    packed = ch.check_packed(feats, tp, dev)
    ch._check(ray_o, "ray_o", (n, 3), torch.float32, dev)
    ch._check(ray_d, "ray_d", (n, 3), torch.float32, dev)
    ch._check(q.queue_rid, "queue_rid", (tiles * rt,), torch.int64, dev)
    ch._check(q.tile_blk, "tile_blk", (tiles,), torch.int32, dev)
    ch._check(q.tile_live, "tile_live", (tiles,), torch.int32, dev)
    ch._check(best_key, "best_key", (n + 1,), torch.int64, dev)
    if stats is not None:
        ch._check(stats, "stats", (2,), torch.int64, dev)
    if tiles == 0 or n == 0:
        return best_key
    err = _launcher()(
        ray_o.data_ptr(), ray_d.data_ptr(), n, packed.data_ptr(), tp, tile, nb,
        q.queue_rid.data_ptr(), q.tile_blk.data_ptr(), q.tile_live.data_ptr(), tiles, rt,
        best_key.data_ptr(), None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"pair_compact kernel launch failed: CUDA error {err}")
    LAUNCHES["pair_compact"] += 1
    return best_key


# One round: fold(feats, ray_o, ray_d, queues, best_key, stats) lowers best_key in place.
Fold = Callable[..., torch.Tensor]


def trace_rounds(feats: ch.TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor, fold: Fold,
                 k: int = K, rt: int = RT, stats: torch.Tensor | None = None,
                 queues: List[Queues] | None = None):
    """Closest hit ``(t, tri, hit, rounds)`` by rounds of pair compaction,
    each round folded into the rays' best keys by ``fold``
    (:func:`pair_compact`, :func:`pair_compact_plain` or another kernel
    with their signature).  The rounds loop in Python with one host sync
    per round (``bool(live.any())``; the prototype's ``while_loop``).
    ``queues`` (a list, optional) receives each round's :class:`Queues`."""
    o = ray_o.detach().to(torch.float32).contiguous()
    d = ray_d.detach().to(torch.float32).contiguous()
    n, nb = o.shape[0], feats.block_bounds.shape[0]
    dev = o.device
    best_key = torch.full((n + 1,), NO_HIT_KEY, dtype=torch.int64, device=dev)
    rounds = 0
    if n and nb:
        visit = precompute(feats, o, d)
        tiles = queue_tiles(n, nb, k, rt)
        ptr = torch.zeros(n, dtype=torch.int64, device=dev)
        live = visit.counts > 0
        while bool(live.any()):
            q = build_round_queues(visit, ptr, key_t(best_key[:n]), k, rt, tiles)
            if queues is not None:
                queues.append(q)
            fold(feats, o, d, q, best_key, stats)
            rounds += 1
            ptr = torch.minimum(ptr + k, visit.counts)
            nxt = torch.gather(visit.entry_sorted, 1, torch.clamp(ptr, max=nb - 1)[:, None])[:, 0]
            live = (ptr < visit.counts) & (nxt <= key_t(best_key[:n]))
    h = key_hit(best_key[:n])
    return h.t, h.tri, h.hit, rounds


def key_hit(best_key: torch.Tensor) -> ch.Hit:
    """The closest hit ``(t, tri, hit)`` of best keys."""
    return ch._finish(key_t(best_key), best_key & 0xFFFFFFFF)


def trace_compact(feats: ch.TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor, k: int = K,
                  rt: int = RT, stats: torch.Tensor | None = None, engine: str = "kernel",
                  queues: List[Queues] | None = None):
    """Closest hit ``(t, tri, hit, rounds)`` by :func:`trace_rounds`, one
    kernel launch per round on the card unless ``engine="plain"``; on the
    CPU the plain version."""
    if engine not in ("kernel", "plain"):
        raise ValueError(f"unknown engine {engine!r}")
    fold = pair_compact_plain if engine == "plain" else pair_compact
    return trace_rounds(feats, ray_o, ray_d, fold, k, rt, stats, queues)


def profile(feats: ch.TriFeatures | None = None, ray_o: torch.Tensor | None = None,
            ray_d: torch.Tensor | None = None, k: int = K, rt: int = RT, runs: int = 5,
            device: DeviceLike = None, n: int = 65536) -> dict:
    """Per-piece times of the round loop on the card (``proto_compact.py
    :319-438``; what ``bench_pieces2.py`` and ``profile_compact2.py``
    measured with the same kernel), each the median of ``runs`` calls
    timed with CUDA events: the slab test and sort, one round's queue
    build and the pair kernel with its fold, all of the first round.  On
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
    best_key = torch.full((n + 1,), NO_HIT_KEY, dtype=torch.int64, device=ray_o.device)
    out["kernel_ms"] = cuda_median_ms(lambda: pair_compact(feats, ray_o, ray_d, q, best_key), runs)
    out.update(counts_mean=float(visit.counts.float().mean()), counts_max=int(visit.counts.max()),
               live_tiles=int(q.tile_live.sum()), tiles=tiles)
    print(f"pre (slab+sort): {out['pre_ms']:.3f} ms; counts: mean {out['counts_mean']:.2f} "
          f"max {out['counts_max']}; queue build: {out['queue_ms']:.3f} ms; live tiles: "
          f"{out['live_tiles']} of {tiles}; pair kernel with its fold: {out['kernel_ms']:.3f} ms")
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
