"""Port parity, the two closest-hit prototypes: the port's
``experiments/proto_grouped.py`` and ``experiments/proto_compact.py``
against the JAX package's prototypes of the same names (run in interpret
mode), against ``trace_plain``, and their schedules' invariants.

The JAX prototypes differ from the port where the tests must not pin them:
- at an origin offset of 1e-4 their split-product ``t`` loses precision
  right at ``MIN_HIT_DIST`` and reports near-surface hits that the exact
  engines do not, so the comparison with them uses an offset of 1e-2;
- ``make_outdoor_scene`` puts each cube's bottom face on the ground quad:
  coplanar triangles tie in ``t`` (to an ulp or two, the planes being
  built from different vertices), and the prototypes break ties on a key
  truncated to 15 mantissa bits.  A ``tri`` fork counts only where the
  exact ``t`` of the prototype's triangle is more than ``TIE_ULPS`` from
  the port's ``t``;
- their ``t`` carries the split-bf16 error band of the JAX package's
  MXU kernels, 2^-16 x the scene's magnitude, above ``1e-4 max(1, t)``
  (see ``_assert_close_to_prototype``);
- their slab tests have no margin; the port's (``block_entries``) has.
The port's plain versions are exact f32 with the lexicographic ``(t,
tri)`` tie rule, so they equal ``trace_plain`` bit for bit."""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu import testing as jt
from ensem3a_openclraytracer_tpu_torch import convert
from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.experiments import common
from ensem3a_openclraytracer_tpu_torch.experiments import proto_compact as pc
from ensem3a_openclraytracer_tpu_torch.experiments import proto_grouped as pg
from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch

# Importing experiments/proto_compact.py sets JAX's compilation cache and
# prepends the repository to sys.path: both are put back.
_path = list(sys.path)
_cache = (jax.config.jax_compilation_cache_dir,
          jax.config.jax_persistent_cache_min_compile_time_secs)
from experiments import proto_compact as jpc  # noqa: E402
from experiments import proto_grouped as jpg  # noqa: E402

sys.path[:] = _path
jax.config.update("jax_compilation_cache_dir", _cache[0])
jax.config.update("jax_persistent_cache_min_compile_time_secs", _cache[1])

SCENES = {"outdoor40": 40, "outdoor100": 100}  # 2 and 5 triangle blocks
N_RAYS = 2048
TIE_ULPS = 2  # coplanar ties read 0, 1 or 2 ulps apart on these scenes


@functools.cache
def _scene(name):
    jg = jt.make_outdoor_scene(n_cubes=SCENES[name], use_bvh=False)[0]
    return jg, convert.geometry(jg, "cpu")


def _rays(g, offset, seed=0, n=N_RAYS):
    return common.bounce_rays(g, n, seed=seed, offset=offset)


def _tri_t(feats, o, d, tri):
    """The exact ``t`` of triangle ``tri[i]`` on ray ``i``."""
    r6, q4, dd = ch.ray_features(o[:, None], d[:, None])
    return ch.tri_t(r6, q4, dd, feats.edges[:, :, tri][..., None], feats.plane[:, tri][..., None],
                    feats.normal_d[:, tri][..., None])[:, 0, 0]


def _assert_close_to_prototype(feats, o, d, port, proto):
    """``hit`` agrees on >= 99.9 % of rays and ``tri`` on >= 99.5 % of the
    rays both hit, a ``tri`` that differs counting as agreeing where the
    exact ``t`` of the prototype's triangle lies within ``TIE_ULPS`` of
    the port's ``t`` (a coplanar tie); ``t`` agrees on those rays.  The
    prototypes' ``t`` comes from split-bf16 products with an absolute
    error of up to 2^-16 x the scene diagonal (the JAX package's
    ``build_tri_features`` sets ``block_bounds[:, 6]`` to 2^-14 x it), so
    the tolerance is the larger of that and ``1e-4 max(1, t)``.  On these
    scenes that is 1.73e-3; the largest |dt| read on the CPU at these
    seeds was 1.49e-3 (compact, 2 blocks), 7.7e-4 to 8.2e-4 otherwise."""
    t, tri, hit = port[:3]
    jt_, jtri, jhit = (torch.as_tensor(np.array(x)) for x in proto[:3])
    jtri = jtri.long()
    assert float((hit == jhit).float().mean()) >= 0.999
    band = float(feats.block_bounds[0, 6]) / 4  # 2^-16 x the scene diagonal
    tol = torch.clamp(1e-4 * torch.clamp(t, min=1.0), min=band)
    both = hit & jhit
    t_jtri = t.clone()
    i = torch.nonzero(both & (tri != jtri)).squeeze(1)
    t_jtri[i] = _tri_t(feats, o[i], d[i], jtri[i])
    ulps = (t_jtri.view(torch.int32) - t.view(torch.int32)).abs()
    same = both & (ulps <= TIE_ULPS)
    assert float(same.sum()) / max(int(both.sum()), 1) >= 0.995
    assert bool(((t - jt_).abs() <= tol)[same].all())
    assert hit.float().mean() > 0.3


@pytest.mark.parametrize("name", sorted(SCENES))
def test_grouped_matches_jax_prototype(name):
    jg, g = _scene(name)
    o, d = _rays(g, 1e-2, seed=1)
    port = pg.trace_grouped(g.feats, o, d)
    proto = jpg.trace_grouped(jpg.build_comb_blocks(jg.feats), jg.feats.block_bounds,
                              jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), interpret=True)
    _assert_close_to_prototype(g.feats, o, d, port, proto)
    # the same coherent order and tiles; the margin only adds (tile, block) pairs
    assert int(port[3]) >= int(proto[3]) > 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compact_matches_jax_prototype(name):
    jg, g = _scene(name)
    o, d = _rays(g, 1e-2, seed=2)
    port = pc.trace_compact(g.feats, o, d)
    proto = jpc.trace_compact(jpc.build_comb_blocks(jg.feats), jg.feats.block_bounds,
                              jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), interpret=True)
    _assert_close_to_prototype(g.feats, o, d, port, proto)


def _assert_exact(out, ref):
    t, tri, hit = out[:3]
    assert torch.equal(t, ref.t) and torch.equal(tri, ref.tri) and torch.equal(hit, ref.hit)


@pytest.mark.parametrize("offset", [1e-4, 1e-2])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_versions_equal_trace_plain(name, offset):
    g = _scene(name)[1]
    o, d = _rays(g, offset, seed=3)
    ref = ch.trace_plain(g.feats, o, d)
    _assert_exact(pg.trace_grouped(g.feats, o, d), ref)
    _assert_exact(pc.trace_compact(g.feats, o, d), ref)


@pytest.mark.parametrize("rt,k", [(128, 1), (1024, 4), (128, 8), (1024, 8)])
def test_results_do_not_depend_on_tile_or_k(rt, k):
    g = _scene("outdoor100")[1]
    o, d = _rays(g, 1e-4, seed=4)
    ref = ch.trace_plain(g.feats, o, d)
    _assert_exact(pg.trace_grouped(g.feats, o, d, rt=rt), ref)
    _assert_exact(pc.trace_compact(g.feats, o, d, k=k, rt=rt), ref)


def _pr3_counts(feats, s):
    """``(pairs tested, stagings)`` of the walk without the per-ray cull and
    without sub-tiles (one walker per tile, every ray whose best ``t`` is
    not below the pair's ``lod`` testing the pair's block), written out
    afresh tile by tile."""
    tile = min(ch.TRI_TILE, feats.edges.shape[-1])
    cols = torch.arange(tile)
    pairs = stagings = 0
    for g in range(s.offsets.numel() - 1):
        rows = slice(g * s.rt, (g + 1) * s.rt)
        r6, q4, d = ch.ray_features(s.o[rows], s.d[rows])
        live = torch.arange(g * s.rt, (g + 1) * s.rt) < s.n
        bt = torch.full((s.rt,), ch.MAX_DIST)
        bi = torch.zeros(s.rt, dtype=torch.int64)
        for slot in range(int(s.offsets[g]), int(s.offsets[g + 1])):
            run = live & ~(bt < s.lod[slot])
            if not bool(run.any()):
                break
            stagings += 1
            pairs += int(run.sum()) * tile
            idx = int(s.blk[slot]) * tile + cols
            t = ch.tri_t(r6, q4, d, feats.edges[:, :, idx], feats.plane[:, idx],
                         feats.normal_d[:, idx])
            tmin, arg = torch.min(t, dim=1)
            better = run & ((tmin < bt) | ((tmin == bt) & (idx[arg] < bi)))
            bt, bi = torch.where(better, tmin, bt), torch.where(better, idx[arg], bi)
    return pairs, stagings


def _needed_pairs(feats, o, d, t):
    """The pairs any closest hit culled by block needs: every triangle of
    each block that the ray enters no farther than its closest hit."""
    tile = min(ch.TRI_TILE, feats.edges.shape[-1])
    return int((ch.block_entries(feats.block_bounds, o, d) <= t[:, None]).sum()) * tile


@pytest.mark.parametrize("offset", [1e-4, 1e-2])
@pytest.mark.parametrize("sub", [32, 128, pg.RT])
def test_culled_sub_tiles_equal_trace_plain(sub, offset):
    """The plain version with the per-ray cull and sub-tiles of ``sub``
    rays gives ``trace_plain``'s hits bit for bit."""
    g = _scene("outdoor100")[1]
    o, d = _rays(g, offset, seed=9)
    s = pg.build_schedule(g.feats, o, d)
    t_s, tri_s = pg.grouped_pairs_plain(g.feats, s, sub=sub)
    _assert_exact(pg.unsort(s, t_s, tri_s), ch.trace_plain(g.feats, o, d))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_cull_counts_lie_between_needed_and_uncut(name):
    """Pairs tested: at least the pairs the closest hit needs, at most the
    walk without the cull, and the same for every sub-tile width (a ray
    whose sub-tile has stopped would fail its own cull too).  Stagings, one
    per step of each running sub-tile: the uncut walk's at ``sub = rt``,
    more with narrower sub-tiles, never more than ``rt / sub`` times that,
    and no sub-tile more than its tile's list."""
    g = _scene(name)[1]
    o, d = _rays(g, 1e-4, seed=10)
    s = pg.build_schedule(g.feats, o, d)
    ref = ch.trace_plain(g.feats, o, d)
    needed = _needed_pairs(g.feats, o, d, ref.t)
    uncut_pairs, uncut_stagings = _pr3_counts(g.feats, s)
    lengths = (s.offsets[1:] - s.offsets[:-1]).long()
    got = {}
    for sub in (32, 128, pg.RT):
        stats = torch.zeros(2, dtype=torch.int64)
        pg.grouped_pairs_plain(g.feats, s, stats=stats, sub=sub)
        got[sub] = [int(x) for x in stats]
    assert got[pg.RT][1] == uncut_stagings
    for sub, (pairs, stagings) in got.items():
        assert needed <= pairs == got[pg.RT][0] <= uncut_pairs
        assert uncut_stagings <= stagings <= (pg.RT // sub) * uncut_stagings
        assert stagings <= (pg.RT // sub) * int(lengths.sum())
    assert needed < uncut_pairs and got[pg.RT][0] < uncut_pairs  # the cull removes pairs here


def test_sub_tile_width():
    """``sub_tile``: the largest power of two dividing the tile, at most
    ``SUB``; the plain version refuses sub-tiles that do not divide it."""
    assert [pg.sub_tile(rt) for rt in (32, 96, 128, 384, 1024)] == [32, 32, 128, 128, pg.SUB]
    g = _scene("outdoor40")[1]
    o, d = _rays(g, 1e-4, seed=11, n=300)
    with pytest.raises(ValueError, match="divide"):
        pg.grouped_pairs_plain(g.feats, pg.build_schedule(g.feats, o, d, rt=128), sub=96)


def _entries_np(bounds, o, d):
    """The margined slab entry in numpy f32, written out afresh."""
    f32 = np.float32
    tiny = f32(1e-12)
    dd = np.where(np.abs(d) < tiny, np.where(d < 0, -tiny, tiny), d).astype(f32)
    inv = (f32(1) / dd).astype(f32)
    t1 = (bounds[None, :, 0:3] - o[:, None]) * inv[:, None]
    t2 = (bounds[None, :, 3:6] - o[:, None]) * inv[:, None]
    tmin = np.minimum(t1, t2).max(axis=-1)
    tmax = np.maximum(t1, t2).min(axis=-1)
    eps = bounds[None, :, 6]
    tmin = tmin - eps - f32(1e-6) * np.abs(tmin)
    tmax = tmax + eps + f32(1e-6) * np.abs(tmax)
    hit = (tmax >= tmin) & (tmax >= 0) & (bounds[None, :, 0] <= bounds[None, :, 3])
    return np.where(hit, np.maximum(tmin, 0), np.inf).astype(f32)


@pytest.mark.parametrize("rt", [128, 1024])
def test_schedule_lists_each_entered_block_once_front_to_back(rt):
    g = _scene("outdoor100")[1]
    o, d = _rays(g, 1e-4, seed=5, n=1500)
    s = pg.build_schedule(g.feats, o, d, rt=rt)
    n, nb = 1500, g.feats.block_bounds.shape[0]
    tiles = -(-n // rt)
    assert torch.equal(torch.sort(s.order).values, torch.arange(n))
    entry = _entries_np(g.feats.block_bounds.numpy(), o[s.order].numpy(), d[s.order].numpy())
    entry = np.concatenate([entry, np.full((tiles * rt - n, nb), np.inf, np.float32)])
    off, blk, lod = s.offsets.numpy(), s.blk.numpy(), s.lod.numpy()
    tile_ids, first = s.tile_ids.numpy(), s.first.numpy()
    assert off.shape == (tiles + 1,) and blk.shape == (tiles * nb,)
    for t in range(tiles):
        seg = slice(off[t], off[t + 1])
        least = entry[t * rt:(t + 1) * rt].min(axis=0)
        want = np.flatnonzero(np.isfinite(least))
        if want.size:
            assert sorted(blk[seg]) == list(want)  # each entered block, once
            np.testing.assert_allclose(lod[seg], least[blk[seg]], rtol=1e-6)
            assert np.all(np.diff(lod[seg]) >= 0)  # front to back
        else:
            assert off[t + 1] - off[t] == 1 and np.isinf(lod[seg]).all()
        assert np.all(tile_ids[seg] == t) and first[off[t]] == 1 and not first[seg][1:].any()
    dead = slice(off[tiles], None)
    assert np.isinf(lod[dead]).all() and not first[dead].any() and np.all(tile_ids[dead] == tiles - 1)
    assert int(s.pairs) == off[tiles]


@pytest.mark.parametrize("k", [1, 4])
def test_compact_rounds_queue_each_pair_once_and_end(k):
    g = _scene("outdoor100")[1]
    o, d = _rays(g, 1e-4, seed=6, n=1000)
    nb = g.feats.block_bounds.shape[0]
    queues = []
    out = pc.trace_compact(g.feats, o, d, k=k, rt=128, queues=queues)
    visit = pc.precompute(g.feats, o, d)
    rounds = out[3]
    assert rounds == len(queues) and 1 <= rounds <= -(-int(visit.counts.max()) // k)
    # round 0: every ray's first k entered blocks, each once, in a tile of that block
    q = queues[0]
    rid = q.queue_rid.view(-1, 128)
    blk = q.tile_blk.long()[:, None].expand_as(rid)
    real = rid < 1000
    assert torch.equal(q.tile_live.bool(), real.any(dim=1))
    got = sorted(zip(rid[real].tolist(), blk[real].tolist()))
    want = sorted((i, int(visit.perm[i, j])) for i in range(1000)
                  for j in range(min(k, int(visit.counts[i]))))
    assert got == want
    assert q.queue_rid.numel() == pc.queue_tiles(1000, nb, k, 128) * 128
    _assert_exact(out, ch.trace_plain(g.feats, o, d))


def _round_queues(name, n=1000, k=pc.K, rt=128, seed=12):
    """The scene's features, rays and the rounds' queues of one plain trace."""
    g = _scene(name)[1]
    o, d = _rays(g, 1e-4, seed=seed, n=n)
    queues = []
    out = pc.trace_compact(g.feats, o, d, k=k, rt=rt, queues=queues)
    return g.feats, o, d, queues, out


def _fold(feats, o, d, queues):
    best = torch.full((o.shape[0] + 1,), pc.NO_HIT_KEY, dtype=torch.int64)
    for q in queues:
        pc.pair_compact_plain(feats, o, d, q, best)
    return best


def _slot_keys_afresh(feats, o, d, q):
    """``(ray, key)`` of every real slot, one slot's block at a time: the key
    ``(float bits of t) << 32 | tri`` of the least ``(t, tri)``, written
    out afresh in numpy."""
    n, tiles = o.shape[0], q.tile_blk.numel()
    tile = min(ch.TRI_TILE, feats.edges.shape[-1])
    rid = q.queue_rid.numpy()
    slots = np.flatnonzero(rid < n)
    rays = rid[slots]
    idx = q.tile_blk.numpy()[slots // (rid.size // tiles)][:, None] * tile + np.arange(tile)
    r6, q4, dd = ch.ray_features(o[rays][:, None], d[rays][:, None])
    it = torch.as_tensor(idx)
    t = ch.tri_t(r6, q4, dd, feats.edges[:, :, it], feats.plane[:, it],
                 feats.normal_d[:, it])[:, 0].numpy()  # [slots, tile]
    keys = np.where(t < ch.MAX_DIST, (t.view(np.int32).astype(np.int64) << 32) | idx,
                    pc.NO_HIT_KEY)
    return rays, keys.min(axis=1)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_fold_equals_slot_keys_and_scatter_min(name):
    """``pair_compact_plain``'s fold, round by round, equals each real
    slot's key written out afresh and folded with ``np.minimum.at``."""
    feats, o, d, queues, out = _round_queues(name)
    best = torch.full((o.shape[0] + 1,), pc.NO_HIT_KEY, dtype=torch.int64)
    want = np.full(o.shape[0] + 1, pc.NO_HIT_KEY, dtype=np.int64)
    for q in queues:
        pc.pair_compact_plain(feats, o, d, q, best)
        np.minimum.at(want, *_slot_keys_afresh(feats, o, d, q))
        assert np.array_equal(best.numpy(), want)
    _assert_exact(out, pc.key_hit(best[:-1]))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_compact_rounds_fold_in_any_order(name):
    """The fold is a min: the rounds folded in reverse give the same keys."""
    feats, o, d, queues, out = _round_queues(name, k=1)
    assert len(queues) > 1
    assert torch.equal(_fold(feats, o, d, queues), _fold(feats, o, d, queues[::-1]))
    _assert_exact(out, pc.key_hit(_fold(feats, o, d, queues)[:-1]))


@pytest.mark.parametrize("rt,k", [(32, 1), (96, 4), (128, 8), (1024, 4)])
def test_real_slots_lead_each_block_run(rt, k):
    """In every round, each block's run of tiles holds its real slots
    first: every tile but the run's last is full, the last is real up to
    some slot and padding after it, and dead tiles hold padding only.  So
    a sub-tile whose first slot is padding holds no real slot, which is
    what lets the kernel's sub-tiles leave on their first slot."""
    n = 1000
    feats, o, d, queues, _ = _round_queues("outdoor100", n=n, k=k, rt=rt, seed=13)
    sub = pc.sub_tile(rt)
    for q in queues:
        real = (q.queue_rid < n).view(-1, rt)
        live = q.tile_live.bool()
        assert torch.equal(live, real.any(dim=1))
        assert bool((real[:, 1:] <= real[:, :-1]).all())  # a prefix of each tile
        blk = q.tile_blk[live]
        assert bool((blk[1:] >= blk[:-1]).all())  # runs in block order
        full = real[live].all(dim=1)
        last = torch.cat([blk[1:] != blk[:-1], torch.ones(1, dtype=torch.bool)])
        assert bool((full | last).all())  # only a run's last tile is partial
        by_sub = real.reshape(-1, sub)
        assert bool((by_sub[:, 0] | ~by_sub.any(dim=1)).all())


def test_compact_sub_tile_width():
    """``sub_tile``: the largest multiple of 32 dividing the tile, at most
    ``SUB`` (``min(SUB, rt)`` wherever that divides it)."""
    assert pc.SUB == 128
    assert [pc.sub_tile(rt) for rt in (32, 96, 128, 192, 224, 1024)] == [32, 96, 128, 96, 32, 128]


@pytest.mark.parametrize("rt", [96, 128, 1024])
def test_trace_compact_counts_real_slots(rt):
    """``trace_compact``'s stats: the real slots of every round times the
    block's triangles, and one staging per sub-tile that holds a real
    slot."""
    g = _scene("outdoor100")[1]
    n = 1000
    o, d = _rays(g, 1e-4, seed=14, n=n)
    stats = torch.zeros(2, dtype=torch.int64)
    queues = []
    pc.trace_compact(g.feats, o, d, rt=rt, stats=stats, queues=queues)
    real = [(q.queue_rid < n) for q in queues]
    tile = min(ch.TRI_TILE, g.feats.edges.shape[-1])
    assert int(stats[0]) == sum(int(r.sum()) for r in real) * tile
    sub = pc.sub_tile(rt)
    assert int(stats[1]) == sum(int(r.view(-1, sub).any(dim=1).sum()) for r in real)


def test_empty_batch_and_one_block_scene():
    g = tt.make_cornell_scene(device="cpu")[0]
    assert g.feats.block_bounds.shape[0] == 1
    o, d = _rays(g, 1e-4, seed=7, n=3000)
    ref = ch.trace_plain(g.feats, o, d)
    _assert_exact(pg.trace_grouped(g.feats, o, d), ref)
    _assert_exact(pc.trace_compact(g.feats, o, d), ref)
    e = torch.zeros(0, 3)
    t, tri, hit, pairs = pg.trace_grouped(g.feats, e, e)
    assert t.shape == tri.shape == hit.shape == (0,) and int(pairs) == 0
    t, tri, hit, rounds = pc.trace_compact(g.feats, e, e)
    assert t.shape == tri.shape == hit.shape == (0,) and rounds == 0


def test_cpu_wrappers_take_the_plain_versions():
    g = _scene("outdoor40")[1]
    o, d = _rays(g, 1e-4, seed=8, n=500)
    before = (pg.LAUNCHES["grouped_pairs"], pc.LAUNCHES["pair_compact"])
    stats = torch.zeros(2, dtype=torch.int64)
    s = pg.build_schedule(g.feats, o, d)
    assert all(torch.equal(a, b) for a, b in zip(pg.grouped_pairs(g.feats, s, stats),
                                                 pg.grouped_pairs_plain(g.feats, s)))
    assert 0 < int(stats[0]) <= 500 * g.feats.edges.shape[-1] and int(stats[1]) > 0
    stats.zero_()
    pc.trace_compact(g.feats, o, d, stats=stats)
    assert 0 < int(stats[0]) <= 500 * g.feats.edges.shape[-1] and int(stats[1]) > 0
    assert (pg.LAUNCHES["grouped_pairs"], pc.LAUNCHES["pair_compact"]) == before
    with pytest.raises(ValueError, match="engine"):
        pg.trace_grouped(g.feats, o, d, engine="fast")
    with pytest.raises(ValueError, match="engine"):
        pc.trace_compact(g.feats, o, d, engine="fast")
    with pytest.raises(ValueError, match="cuda"):
        pc.profile(g.feats, o, d)
    q = pc.build_round_queues(pc.precompute(g.feats, o, d), torch.zeros(500, dtype=torch.int64),
                              torch.full((500,), ch.MAX_DIST), 1, 128, 8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pc.pair_compact(g.feats, o.to("meta"), d.to("meta"), q, torch.zeros(501, dtype=torch.int64))


@pytest.mark.parametrize("mod", [pg, pc], ids=["grouped", "compact"])
def test_main_runs_on_the_cpu(mod):
    out = mod.main(device="cpu", n=2048)
    assert out["hit_mismatch"] == 0 and out["tri_same"] == 1.0 and out["t_rel_max"] == 0.0
