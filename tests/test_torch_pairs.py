"""Port parity, the block-queue closest hit (``ops/pairs.py``): its plain
version against ``trace_plain`` (bit for bit) and against the JAX
package's multi-block engines ``ops/pairs.trace_pairs`` and
``trace_pairs_streamed`` (interpret mode, under the bands that
``tests/test_pairs.py`` holds them to), the invariants of its rounds, and
its test phase's cull to the sub-tiles a queued ray enters (bounce, shadow
and grazing rays on 2, 61 and 62 blocks, the benchmark's closed box among
them), and a floor of more blocks than the kernel's select keeps resident.  The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu import testing as jt
from ensem3a_openclraytracer_tpu.ops.pairs import trace_pairs as j_trace_pairs
from ensem3a_openclraytracer_tpu.ops.pairs import trace_pairs_streamed as j_trace_pairs_streamed
from ensem3a_openclraytracer_tpu_torch import convert
from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.experiments import common
from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
from ensem3a_openclraytracer_tpu_torch.ops import pairs as pp
from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays

SCENES = {"outdoor40": 40, "outdoor100": 100}  # 2 and 5 triangle blocks


@functools.cache
def _scene(name):
    jg = jt.make_outdoor_scene(n_cubes=SCENES[name], use_bvh=False)[0]
    return jg, convert.geometry(jg, "cpu")


def _assert_exact(h, ref):
    assert torch.equal(h.t, ref.t) and torch.equal(h.tri, ref.tri) and torch.equal(h.hit, ref.hit)


@pytest.mark.parametrize("offset", [1e-4, 1e-2])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_equals_trace_plain_on_bounce_rays(name, offset):
    g = _scene(name)[1]
    o, d = common.bounce_rays(g, 2048, seed=1, offset=offset)
    h = pp.trace_pairs_plain(g.feats, o, d)
    _assert_exact(h, ch.trace_plain(g.feats, o, d))
    assert h.hit.float().mean() > 0.3


def test_plain_equals_trace_plain_on_camera_rays_with_sky():
    g, _, _, c = tt.make_outdoor_scene(n_cubes=100, device="cpu")
    o, d = camera_rays(c.position, c.rotation_deg, c.fov_deg, 40, 40)
    ref = ch.trace_plain(g.feats, o, d)
    assert bool((~ref.hit).any()) and bool(ref.hit.any())  # sky misses and hits
    _assert_exact(pp.trace_pairs_plain(g.feats, o, d), ref)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_results_do_not_depend_on_k(k):
    g = _scene("outdoor100")[1]
    o, d = common.bounce_rays(g, 1500, seed=2)
    _assert_exact(pp.trace_pairs_plain(g.feats, o, d, k=k), ch.trace_plain(g.feats, o, d))


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_results_do_not_depend_on_the_ray_count(n):
    """A batch (empty, one ray, or not a multiple of the kernel's work
    item of ``CHUNK`` rays) gives each ray what a larger batch gives it."""
    g = _scene("outdoor100")[1]
    o, d = common.bounce_rays(g, 1300, seed=3)
    whole = pp.trace_pairs_plain(g.feats, o, d)
    part = pp.trace_pairs_plain(g.feats, o[300:300 + n], d[300:300 + n])
    assert part.t.shape == part.tri.shape == part.hit.shape == (n,)
    assert torch.equal(part.t, whole.t[300:300 + n]) and torch.equal(part.tri, whole.tri[300:300 + n])
    assert part.tri.dtype == torch.int64 and part.hit.dtype == torch.bool


@pytest.mark.parametrize("k", [1, 4])
def test_rounds_queue_each_pair_once_and_every_needed_pair(k):
    g = _scene("outdoor100")[1]
    feats = g.feats
    n, nb, tile = 1000, feats.block_bounds.shape[0], ch.TRI_TILE
    o, d = common.bounce_rays(g, n, seed=4)
    queues = []
    stats = torch.zeros(6, dtype=torch.int64)
    h = pp.trace_pairs_plain(feats, o, d, k=k, stats=stats, queues=queues)
    entry = ch.block_entries(feats.block_bounds, o, d)
    rid = torch.cat([q[0] for q in queues])
    blk = torch.cat([q[1] for q in queues])
    pair = rid * nb + blk
    assert torch.unique(pair).numel() == pair.numel()  # each (ray, block) pair at most once
    needed = torch.nonzero((entry <= h.t[:, None]).reshape(-1)).squeeze(1)
    assert bool(torch.isin(needed, pair).all())  # every needed pair is tested
    assert bool((torch.isfinite(entry.reshape(-1))[pair]).all())  # only entered blocks
    most = int(torch.isfinite(entry).sum(dim=1).max())
    rounds = len(queues)
    assert 1 <= rounds <= max(1, math.ceil(most / k))
    for r, (qr, _) in enumerate(queues):  # at most k picks per ray per round
        assert int(torch.bincount(qr, minlength=n).max()) <= k
    stagings = sum(int(((torch.bincount(b, minlength=nb) + pp.CHUNK - 1) // pp.CHUNK).sum())
                   for _, b in queues)
    slabs = sum(torch.unique(qr).numel() for qr, _ in queues)
    assert stats[1] == stagings and stats[2] == rounds
    assert int(stats[3]) >= slabs * nb  # every live ray slab-tests every block each round
    # the cull: a kept (ray, sub-tile) entry tests its SUB triangles, no more than the uncut
    # pair would, and keeps no entry of a sub-tile that holds no triangle
    assert stats[0] == pp.SUB * stats[5] <= pair.numel() * tile
    assert 0 < stats[5] <= stats[4] <= pair.numel() * pp.SUBS
    _assert_exact(h, ch.trace_plain(feats, o, d))


@pytest.mark.parametrize("items, grid, want", [
    (0, 528, 1), (1, 528, 32), (16, 528, 32), (17, 528, 16), (33, 528, 16), (34, 528, 8),
    (66, 528, 8), (67, 528, 4),
    (132, 528, 4), (133, 528, 2), (264, 528, 2), (265, 528, 1), (528, 528, 1), (529, 528, 1),
    (1, 1, 1), (1, 2, 2), (3, 7, 2), (2 ** 30, 528, 1)])
def test_slices_fill_the_grid_in_powers_of_two(items, grid, want):
    """The kernel's slice rule: the largest power of two up to ``S_MAX``
    whose slices of every item still fit in the grid; a round with no
    items, or with enough to fill the grid, keeps its items whole."""
    assert pp.slices(items, grid) == want
    assert want <= pp.S_MAX and (items == 0 or want == 1 or items * want <= grid)


GRID_THREADS = 528 * 128  # outdoor15k.render's 2b grid on an H100: 4 CUDA blocks an SM


@pytest.mark.parametrize("n_live, nb, grid_threads, want", [
    (0, 61, GRID_THREADS, 1), (1, 61, GRID_THREADS, 32), (716, 61, GRID_THREADS, 32),
    (1657, 61, GRID_THREADS, 32), (2112, 61, GRID_THREADS, 32), (2113, 61, GRID_THREADS, 16),
    (14427, 61, GRID_THREADS, 4), (33792, 61, GRID_THREADS, 2), (33793, 61, GRID_THREADS, 1),
    (65536, 61, GRID_THREADS, 1), (GRID_THREADS, 61, GRID_THREADS, 1),
    (2 ** 30, 61, GRID_THREADS, 1),
    (1, 4, GRID_THREADS, 4), (16384, 4, GRID_THREADS, 4), (16897, 4, GRID_THREADS, 2),
    (1, 586, GRID_THREADS, 32), (3000, 586, GRID_THREADS, 16), (65536, 586, GRID_THREADS, 1),
    (1, 1, GRID_THREADS, 1), (1, 2, GRID_THREADS, 2), (1, 3, GRID_THREADS, 2),
    (1, 64, 128, 32), (5, 64, 128, 16), (1, 61, 1, 1), (3, 61, 7, 2),
    (1, pp.AGG_BLOCKS, GRID_THREADS, 32), (4096, pp.AGG_BLOCKS, GRID_THREADS, 16),
    (1, pp.AGG_BLOCKS + 1, GRID_THREADS, 32), (4096, 1600, GRID_THREADS, 16),
    (1, 2344, GRID_THREADS, 32), (2112, 2344, GRID_THREADS, 32), (2113, 2344, GRID_THREADS, 16),
    (33792, 2344, GRID_THREADS, 2), (33793, 2344, GRID_THREADS, 1),
    (1, 16512, GRID_THREADS, 32)])
def test_select_lanes_fill_the_grid_in_powers_of_two(n_live, nb, grid_threads, want):
    """The kernel's select rule: the largest power of two up to ``G_MAX``
    and up to the block count whose groups of every live ray still fit in
    the grid's threads, at any block count (above ``AGG_BLOCKS`` too, as
    ``outdoor600k.render``'s 2,344 blocks); a round with no rays, or with
    enough to fill the grid, keeps one thread a ray."""
    g = pp.select_lanes(n_live, nb, grid_threads)
    assert g == want
    assert g & (g - 1) == 0 and g <= pp.G_MAX and g <= max(nb, 1)
    assert g == 1 or n_live * g <= grid_threads
    assert (n_live == 0 or 2 * g > min(pp.G_MAX, nb)
            or n_live * 2 * g > grid_threads)


@functools.cache
def _scene61_pairs():
    """The 61-block scene, a few hundred bounce rays, and every (ray, block)
    pair their rounds queue, with each pair's key over the whole tile."""
    g = tt.make_outdoor_scene(n_cubes=1300, device="cpu")[0]
    assert g.feats.block_bounds.shape[0] == 61
    o, d = common.bounce_rays(g, 300, seed=17)
    queues = []
    pp.trace_pairs_plain(g.feats, o, d, queues=queues)
    rid = torch.cat([q[0] for q in queues])
    blk = torch.cat([q[1] for q in queues])
    rays = ch.ray_features(o, d)
    whole = pp._test_pairs(g.feats, *rays, rid, blk, ch.TRI_TILE)
    return g, rays, rid, blk, whole


@pytest.mark.parametrize("s", [1, 2, 4, 8, 16, 32])
def test_slices_of_a_tile_fold_to_its_whole_key(s):
    """The least key over ``s`` triangle slices of each (ray, block) pair,
    as the kernel folds its slices with ``atomicMin``, equals the pair's
    key over the whole tile bit for bit."""
    g, rays, rid, blk, whole = _scene61_pairs()
    tile = ch.TRI_TILE
    width = tile // s
    parts = torch.stack([pp._test_pairs(g.feats, *rays, rid, blk, tile, lo, lo + width)
                         for lo in range(0, tile, width)])
    assert torch.equal(parts.amin(dim=0), whole)
    hits = whole != pp.NO_HIT_KEY
    assert 0.05 < float(hits.float().mean()) < 1.0
    if s > 1:  # the winner lies in one slice; the others miss it or find a farther hit
        assert bool(((parts == whole).sum(dim=0)[hits] >= 1).all())
        assert bool((parts > whole).any())


def _jax_bounce_rays(geom, n, seed):
    """``tests/test_pairs.py``'s rays: surface origins 5e-4 along a random
    direction (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = (np.asarray(x) for x in (geom.v0, geom.v1, geom.v2))
    ti = rng.integers(0, len(v0), n)
    r1, r2 = rng.random(n), rng.random(n)
    s = np.sqrt(r1)
    p = (v0[ti] * (1 - s)[:, None] + v1[ti] * (s * (1 - r2))[:, None]
         + v2[ti] * (s * r2)[:, None])
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (p + 5e-4 * d).astype(np.float32), d


def _assert_within_jax_bands(port, ref, scene_diag=115.0):
    """The bands of ``tests/test_pairs.py``'s ``_assert_hits_match`` for the
    JAX package's split-bf16 engines: hit forks under 1 %, median relative
    ``t`` gap under 1e-4, under 1 % of ``t`` outside ``5e-3 t + 2^-15 x
    scene extent``, and under 1 % of ``tri`` forks at a ``t`` outside it."""
    hg, hr = port.hit.numpy(), np.asarray(ref.hit)
    assert (hg != hr).mean() < 0.01
    both = hg & hr
    tg, tr = port.t.numpy()[both], np.asarray(ref.t)[both]
    err = np.abs(tg - tr)
    rel = err / np.maximum(np.abs(tr), 1e-9)
    assert np.percentile(rel, 50) < 1e-4, np.percentile(rel, 50)
    allow = 5e-3 * np.abs(tr) + 2.0 ** -15 * scene_diag
    assert (err > allow).mean() < 0.01, (err / allow).max()
    tri_diff = port.tri.numpy()[both] != np.asarray(ref.tri)[both]
    assert (tri_diff & (err > allow)).mean() < 0.01


@functools.cache
def _jax_scene64():
    jg = jt.make_outdoor_scene(n_cubes=64, use_bvh=False)[0]
    return jg, convert.geometry(jg, "cpu")


@pytest.mark.parametrize("engine", ["trace_pairs", "trace_pairs_streamed"])
def test_matches_jax_multi_block_engines(engine):
    jg, g = _jax_scene64()
    assert g.feats.block_bounds.shape[0] == 4
    o, d = _jax_bounce_rays(g, 700, seed=11)
    fn = j_trace_pairs if engine == "trace_pairs" else j_trace_pairs_streamed
    ref = fn(jg.feats, jnp.asarray(o), jnp.asarray(d), interpret=True)
    port = pp.trace_pairs_plain(g.feats, torch.as_tensor(o), torch.as_tensor(d))
    _assert_within_jax_bands(port, ref)
    assert port.hit.float().mean() > 0.3


def test_plain_equals_trace_plain_above_the_select_block_limit():
    """On a floor of 41 x 41 blocks, more than ``SEL_BLOCKS`` (above which the
    kernel's select stages the bounds in chunks) and ``AGG_BLOCKS``, rays
    falling at a slant across several blocks each: the hits are
    ``trace_plain``'s bit for bit, and a second trace counts the same."""
    feats = common.floor_features(41, 41, "cpu")
    nb = feats.block_bounds.shape[0]
    assert nb > pp.SEL_BLOCKS > pp.AGG_BLOCKS
    rng = np.random.default_rng(41)
    n = 200
    o = np.stack([rng.uniform(-20.5, 20.5, n), rng.uniform(-20.5, 20.5, n), np.full(n, 3.0)], -1)
    d = np.concatenate([rng.normal(scale=2.0, size=(n, 2)), -np.ones((n, 1))], -1)
    o = torch.as_tensor(o.astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(d.astype(np.float32)), dim=-1)
    stats, again = torch.zeros(6, dtype=torch.int64), torch.zeros(6, dtype=torch.int64)
    queues = []
    h = pp.trace_pairs_plain(feats, o, d, stats=stats, queues=queues)
    _assert_exact(h, ch.trace_plain(feats, o, d))
    assert float(h.hit.float().mean()) > 0.5
    _assert_exact(pp.trace_pairs_plain(feats, o, d, stats=again), h)
    assert torch.equal(stats, again)
    assert int(stats[2]) == len(queues) >= 1 and int(stats[3]) >= n * nb
    assert max(int(torch.bincount(qr).max()) for qr, _ in queues) > 1  # rays queue several blocks


def test_cpu_wrapper_and_dispatch_take_the_plain_version():
    g = _scene("outdoor40")[1]
    o, d = common.bounce_rays(g, 600, seed=5)
    before = pp.LAUNCHES["pairs"]
    stats = torch.zeros(4, dtype=torch.int64)
    h = pp.trace_pairs(g.feats, o, d, stats=stats)
    ref = ch.trace_plain(g.feats, o, d)
    _assert_exact(h, ref)
    _assert_exact(ch.trace(g, o, d), ref)
    assert pp.LAUNCHES["pairs"] == before
    assert int(stats[0]) > 0 and int(stats[1]) > 0 and int(stats[2]) >= 1
    assert int(stats[3]) >= 600 * g.feats.block_bounds.shape[0]
    with pytest.raises(ValueError, match="k must be"):
        pp.trace_pairs_plain(g.feats, o, d, k=0)
    assert not ch.resident(g.feats)  # the card would take trace_pairs


@pytest.mark.parametrize("name", ["outdoor40", "cornell"])
def test_packed_features_are_the_feature_rows_by_triangle(name):
    g = _scene(name)[1] if name in SCENES else tt.make_cornell_scene(device="cpu")[0]
    f = g.feats
    tp = f.edges.shape[-1]
    rows = torch.cat([f.edges.reshape(18, tp), f.plane, f.normal_d])  # csrc FEAT_ROWS order
    assert f.packed.shape == (tp, ch.PACKED_ROWS) and f.packed.is_contiguous()
    assert torch.equal(f.packed[:, :25], rows.t()) and not f.packed[:, 25:].any()


@functools.cache
def _cull_scene(name):
    """The cull's scenes: the 2-block outdoor40, the 61-block outdoor1300 and
    the benchmark's 62-block closed box (``common.closedbox``)."""
    if name == "closedbox":
        g = common.closedbox("cpu")[0]
        assert g.feats.block_bounds.shape[0] == 62
        return g
    if name == "outdoor1300":
        return _scene61_pairs()[0]
    return _scene(name)[1]


CULL_RAYS = {  # kind -> (o, d) of n rays on a geometry
    "bounce": lambda g, n, seed: common.bounce_rays(g, n, seed=seed),
    "shadow": lambda g, n, seed: common.shadow_rays(g, n, seed=seed),
    "grazing": lambda g, n, seed: tt.grazing_rays(g, n, seed=seed),
}


@pytest.mark.parametrize("rays", sorted(CULL_RAYS))
@pytest.mark.parametrize("name", ["closedbox", "outdoor1300", "outdoor40"])
def test_cull_keeps_every_hit_and_counts_what_it_tests(name, rays):
    """The test phase tests a queued ray only against the sub-tiles of its
    block whose box it enters no farther than the best ``t`` its select
    read: the hits stay ``trace_plain``'s bit for bit, a kept entry counts
    its ``SUB`` triangles, the pairs tested stay under the uncut count
    (every triangle of every queued block), the entries kept under those
    offered, and the plain fused sample's counts are these."""
    g = _cull_scene(name)
    o, d = CULL_RAYS[rays](g, 1024, len(name) + len(rays))
    queues = []
    stats = torch.zeros(6, dtype=torch.int64)
    h = pp.trace_pairs_plain(g.feats, o, d, stats=stats, queues=queues)
    _assert_exact(h, ch.trace_plain(g.feats, o, d))
    assert h.hit.any()
    queued = sum(q[0].numel() for q in queues)
    pairs, offered, tested = int(stats[0]), int(stats[4]), int(stats[5])
    assert pairs == pp.SUB * tested <= queued * ch.TRI_TILE
    assert 0 < tested <= offered <= queued * pp.SUBS
    if rays == "bounce" and name != "outdoor40":  # the cull bites on the large scenes
        assert pairs < 0.5 * queued * ch.TRI_TILE
    four = torch.zeros(4, dtype=torch.int64)
    pp.trace_pairs_plain(g.feats, o, d, stats=four)  # four slots: pairs.cu's
    assert torch.equal(four, stats[:4])


def test_cull_tests_every_sub_tile_a_ray_enters():
    """Three full blocks whose every sub-tile holds a triangle spanning the
    scene's whole box: rays from inside enter every sub-tile, so the cull
    keeps every entry and the pairs tested are the uncut count."""
    rng = np.random.default_rng(6)
    t = 3 * ch.TRI_TILE
    v = [rng.uniform(-1.0, 1.0, (t, 3)).astype(np.float32) for _ in range(3)]
    big = np.arange(0, t, pp.SUB)  # the first triangle of each sub-tile spans the box
    v[0][big], v[1][big], v[2][big] = [-2.0, -2.0, -2.0], [2.0, 2.0, 2.0], [2.0, -2.0, 2.0]
    feats = ch.build_tri_features(*v, "cpu")
    o = torch.as_tensor(rng.uniform(-0.5, 0.5, (500, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(500, 3)).astype(np.float32)),
                                      dim=-1)
    queues = []
    stats = torch.zeros(6, dtype=torch.int64)
    h = pp.trace_pairs_plain(feats, o, d, stats=stats, queues=queues)
    _assert_exact(h, ch.trace_plain(feats, o, d))
    queued = sum(q[0].numel() for q in queues)
    assert queued >= 500
    assert int(stats[0]) == queued * ch.TRI_TILE
    assert int(stats[4]) == int(stats[5]) == queued * pp.SUBS
