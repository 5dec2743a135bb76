"""Card-only tests of the port's CUDA kernels against their plain versions
on the card: the resident closest-hit kernel (``trace_resident`` against
``trace_plain``) on one-block scenes, the one-block fused sample
kernel (``sample_fused`` against ``sample_fused_plain``, record mode, and
its whole-render launch ``render_fused_resident`` against
``render_fused_plain`` and against one launch per sample), the
multi-block render into a running sum (``render_fused_queue`` against
``render_fused_plain``, against one-sample launches with the IBL and the
sum on the host, and a profiled multi-block replay's kernel count), the Philox
kernel (``uniforms`` against ``uniforms_plain``) and the two prototype
closest-hit kernels
(``trace_grouped`` and ``trace_compact`` against their plain versions,
their counts too, two launches bit-equal, and the compaction kernel on
partial sub-tiles),
the block-queue closest hit (``trace_pairs`` against ``trace_plain`` and
its plain version's counts; on 61 and 586 blocks) and the multi-block fused
sample kernel (``sample_fused_queue`` against ``sample_fused_plain`` and
its counts, with NEE, in record mode, up to 586 blocks; with NEE also on
the benchmark's closed box of 62 blocks, ``closedbox_nee``, in one sample,
a whole render and a graphed render; both kernels' test-phase cull to the
sub-tiles a ray enters, counted as the plain versions count it; above
``SEL_BLOCKS``, a floor of 41 x 41 blocks and one sample of the benchmark's
``outdoor600k`` scene of 2,344 blocks), and the gradient
path: the replay of fused records against the forward render, the replay's
gradients on the card against the CPU, the gather backward's determinism,
and a stopped and resumed optimisation against an uninterrupted one; and
the product surface: progressive chunks against one-shot renders, the
CLI render's kernel launches, and ``--mesh 1,1`` joining ``nccl`` from
``torchrun``'s environment; and the tree: ``trace_bvh`` (kernel
``bvh_trace``) against ``trace_bvh_plain`` on the card and on the CPU
(its five counts too, two launches equal, and on rays through Cornell's
shared edges and rays grazing the outdoor ground), the card's plain walk
against the CPU's bit for bit on those rays, the
device LBVH build on the card against the host build, and a tree trace
under ``set_sync_debug_mode("error")``; and the compiled entry points
(``utils/graphs``): ``render_radiance_jit`` (Cornell, Cornell NEE,
outdoor_1300, a tree-only outdoor_1300), a progressive render resumed after
two chunks, three trainer steps and the texel step, each bit-equal to its
eager form on the first replay and on a new key, running the eager call's
kernels (a profiler trace counts a replay's), a render replay on new
camera, material, sun and light values bit-equal to eager on them, and a
capture that meets a host sync raises.  They skip without a card.  This
file imports no JAX, so on a machine without JAX run it without the
suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.experiments import common
from ensem3a_openclraytracer_tpu_torch.experiments import proto_compact as pc
from ensem3a_openclraytracer_tpu_torch.experiments import proto_grouped as pg
from ensem3a_openclraytracer_tpu_torch.models.pathtracer import _gather_surface
from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
from ensem3a_openclraytracer_tpu_torch.ops import fused as fu
from ensem3a_openclraytracer_tpu_torch.ops import launches
from ensem3a_openclraytracer_tpu_torch.ops import pairs as pp
from ensem3a_openclraytracer_tpu_torch.ops import rng
from ensem3a_openclraytracer_tpu_torch.ops import traversal as tv
from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays
from ensem3a_openclraytracer_tpu_torch.ops.envmap import sample_ibl
from ensem3a_openclraytracer_tpu_torch.scene.scene import build_light_pack

pytestmark = pytest.mark.cuda


@functools.cache
def _closedbox(dev):
    """The benchmark's ``closedbox15k`` scene (``common.closedbox``):
    ``(geometry, materials, env, camera)``."""
    return common.closedbox(dev)

@functools.cache
def _outdoor600k(dev):
    """The benchmark's ``outdoor600k`` scene (``common.outdoor600k``)."""
    return common.outdoor600k(dev)


ROLES = {  # role -> (scene maker, expected triangle blocks)
    "one_block": (lambda dev: tt.make_cornell_scene(device=dev), 1),
    "one_block_outdoor": (lambda dev: tt.make_outdoor_scene(n_cubes=4, device=dev), 1),
    "61_blocks": (lambda dev: tt.make_outdoor_scene(n_cubes=1300, device=dev), 61),
    "586_blocks": (lambda dev: tt.make_outdoor_scene(n_cubes=12500, device=dev), 586),
    "closedbox": (_closedbox, 62),
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _rays(geom, cam, dev, seed, res=128, n_bounce=16384):
    o, d = camera_rays(cam.position, cam.rotation_deg, cam.fov_deg, res, res)
    h = ch.trace_plain(geom.feats, o.contiguous(), d)
    rng = np.random.default_rng(seed)
    pick = torch.as_tensor(rng.integers(0, o.shape[0], n_bounce), device=dev)
    bd = torch.as_tensor(rng.normal(size=(n_bounce, 3)).astype(np.float32), device=dev)
    bd = torch.nn.functional.normalize(bd, dim=-1)
    bo = o[pick] + d[pick] * h.t[pick, None]
    return torch.cat([o, bo]).contiguous(), torch.cat([d, bd]).contiguous()


@pytest.mark.parametrize("role", sorted(r for r, (_, blocks) in ROLES.items() if blocks == 1))
def test_kernel_matches_plain(cuda, role):
    make, blocks = ROLES[role]
    g, _, _, c = make(cuda)
    assert g.feats.block_bounds.shape[0] == blocks
    o, d = _rays(g, c, cuda, seed=blocks)
    order = ch.coherent_order(o, d)
    o, d = o[order].contiguous(), d[order].contiguous()
    before = ch.LAUNCHES["closest_hit"]
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    t, tri = ch.trace_resident(g.feats, o, d, stats=stats)
    torch.cuda.synchronize()
    assert ch.LAUNCHES["closest_hit"] == before + 1
    # one staging per CUDA block of 256 rays
    assert int(stats[1]) == -(-o.shape[0] // 256)
    assert 0 < int(stats[0]) <= o.shape[0] * g.feats.edges.shape[-1]
    ref = ch.trace_plain(g.feats, o, d)
    hit = t < ch.MISS_T
    same = tri.to(torch.int64) == ref.tri
    assert float(same.float().mean()) >= 0.999
    assert float((hit == ref.hit).float().mean()) >= 0.999
    err = (t - ref.t).abs()[same]
    assert bool((err <= 1e-4 * torch.clamp(ref.t[same], min=1.0)).all())
    assert bool(torch.all(t[~hit] == ch.MAX_DIST)) and bool(torch.all(tri[~hit] == 0))


def test_dispatch_and_stats(cuda):
    """61 blocks take ``trace_pairs`` (and ``trace_resident`` refuses
    them); on Cornell ``trace_resident``'s counts and its contiguity check."""
    g, _, _, c = ROLES["61_blocks"][0](cuda)
    o, d = _rays(g, c, cuda, seed=5, res=64, n_bounce=4096)
    before = dict(pairs=pp.LAUNCHES["pairs"], closest_hit=ch.LAUNCHES["closest_hit"])
    h = ch.trace(g, o, d)
    assert pp.LAUNCHES["pairs"] == before["pairs"] + 1
    assert ch.LAUNCHES["closest_hit"] == before["closest_hit"]
    ref = ch.trace_plain(g.feats, o, d)
    assert float((h.tri == ref.tri).float().mean()) >= 0.999
    with pytest.raises(ValueError, match="one triangle block"):
        ch.trace_resident(g.feats, o, d)
    g, _, _, c = ROLES["one_block"][0](cuda)
    o, d = _rays(g, c, cuda, seed=5, res=64, n_bounce=4096)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    ch.trace_resident(g.feats, o, d, stats=stats)
    pairs, stagings = (int(x) for x in stats.cpu())
    assert 0 < pairs <= o.shape[0] * g.feats.edges.shape[-1]
    assert stagings > 0
    with pytest.raises(ValueError, match="contiguous"):
        ch.trace_resident(g.feats, o.t().contiguous().t(), d)


FUSED = {  # role -> (scene maker, expected blocks, sun, nee)
    "cornell": (lambda dev: tt.make_cornell_scene(device=dev), 1, False, False),
    "cornell_nee": (lambda dev: tt.make_cornell_scene(device=dev), 1, False, True),
    "outdoor_47_blocks": (lambda dev: tt.make_outdoor_scene(n_cubes=1000, device=dev), 47, True,
                          False),
    "closedbox_nee": (_closedbox, 62, False, True),
}


def _fused_inputs(make, dev, res=64):
    """The engine's own per-sample arguments (``fused_args``, Morton-permuted
    on multi-block scenes) for the camera's rays."""
    g, m, e, c = make(dev)
    o, d = camera_rays(c.position, c.rotation_deg, c.fov_deg, res, res)
    h = ch.trace(g, o, d)
    args, _ = fu.fused_args(g, m, e, o, d, h, _gather_surface(g, m, o, d, h))
    return g, m, e, args


def _image(out, e):
    rad, esc_thr, esc_dir = out[:3]
    return rad + esc_thr * sample_ibl(e.ibl, esc_dir) * e.ibl_power


@pytest.mark.parametrize("role", sorted(FUSED))
def test_fused_kernel_matches_plain(cuda, role):
    make, blocks, sun, nee = FUSED[role]
    g, m, e, args = _fused_inputs(make, cuda)
    assert g.feats.block_bounds.shape[0] == blocks
    n, mb = args[2].shape[0], 3
    rng_ = np.random.default_rng(3)
    u = torch.as_tensor(rng_.random((mb + 1, n, 5 if nee else 2)).astype(np.float32), device=cuda)
    kw = dict(max_bounce=mb, sun_enabled=sun, uniforms=u, nee=nee,
              lights=build_light_pack(g, m) if nee else None)
    queue = not ch.resident(g.feats)
    kernel = "sample_fused_queue" if queue else "sample_fused"
    before = dict(fu.LAUNCHES)
    slots = fu.queue_stats_len(mb) if queue else 5
    stats = torch.zeros(slots, dtype=torch.int64, device=cuda)
    k = _image(fu.sample_fused(*args, stats=stats, **kw), e)
    torch.cuda.synchronize()
    assert fu.LAUNCHES == {**before, kernel: before[kernel] + 1}
    plain_stats = torch.zeros_like(stats)
    p = _image(fu.sample_fused_plain(*args, stats=plain_stats, **kw), e)
    assert bool(torch.isfinite(k).all())
    diff = (k - p).abs().amax(dim=-1)
    assert float((diff > 1e-3).float().mean()) < 0.02
    assert float(diff.median()) < 1e-5
    assert int(stats[0]) > 0 and int(stats[1]) > 0 and int(stats[3]) > 0
    if queue:  # 2b's segments and cycles (ops/fused.QUEUE_STATS)
        got = dict(zip(fu.queue_stats_fields(mb), stats.tolist()))
        want = dict(zip(fu.queue_stats_fields(mb), plain_stats.tolist()))
        lanes = [got[f"lanes.{b}"] for b in range(mb + 1)]
        assert got["segments"] == sum(lanes) > 0
        for f in ("pairs", "stagings", "rounds", "slabs", "segments", "lanes.0", "nee_rays",
                  "subtiles_offered", "subtiles_tested"):
            assert abs(got[f] - want[f]) <= 0.01 * want[f], (f, got, want)
        assert 0 < got["subtiles_tested"] <= got["subtiles_offered"]
        assert got["pairs"] == pp.SUB * got["subtiles_tested"]
        assert (got["nee_rays"] > 0) is nee
        assert 0 < got["sync_cycles"] < got["kernel_cycles"]
        assert min(got[f] for f in fu.QUEUE_STATS[8:]) >= 0 < got["shade_cycles"]


RECORD = {  # role -> (scene maker, blocks, wrapper)
    "one_block": (lambda dev: tt.make_cornell_scene(device=dev), 1, "sample_fused_blocks"),
    "queue_multi_block": (lambda dev: tt.make_outdoor_scene(n_cubes=100, device=dev), None,
                          "sample_fused"),
}


@pytest.mark.parametrize("role", sorted(RECORD))
def test_fused_record_matches_plain(cuda, role):
    """Record mode of each kernel against plain: ``fused_sample.cu`` on one
    block, and the dispatch's queue kernel on several."""
    make, blocks, wrapper = RECORD[role]
    g, m, e, args = _fused_inputs(make, cuda)
    nb = g.feats.block_bounds.shape[0]
    assert nb == blocks if blocks else not ch.resident(g.feats)
    key = rng.key_from_generator(torch.Generator(device=cuda).manual_seed(1), cuda)
    kw = dict(max_bounce=3, sun_enabled=True, record=True)
    kernel = "sample_fused_queue" if wrapper == "sample_fused" else "sample_fused"
    before = dict(fu.LAUNCHES)
    k = getattr(fu, wrapper)(*args, key, 2, **kw)
    assert fu.LAUNCHES == {**before, kernel: before[kernel] + 1}
    p = fu.sample_fused_plain(*args, key, 2, **kw)
    assert torch.equal(k[3], p[3])
    for a, b in zip(k[4:], p[4:]):
        assert float((a == b).float().mean()) >= 0.995


RENDER = {  # role -> (scene maker, sun, nee, bilinear IBL)
    "cornell": (lambda dev: tt.make_cornell_scene(device=dev), False, False, True),
    "cornell_nee": (lambda dev: tt.make_cornell_scene(device=dev), False, True, True),
    "outdoor4_sun_ibl": (lambda dev: tt.make_outdoor_scene(n_cubes=4, device=dev), True, False,
                         True),
    "outdoor4_sun_ibl_nearest": (lambda dev: tt.make_outdoor_scene(n_cubes=4, device=dev), True,
                                 False, False),
}


def _render_kw(g, m, e, role):
    _, sun, nee, bilinear = RENDER[role]
    return dict(ibl=e.ibl, ibl_power=e.ibl_power, ibl_bilinear=bilinear, max_bounce=3,
                sun_enabled=sun, nee=nee, lights=build_light_pack(g, m) if nee else None)


@pytest.mark.parametrize("role", sorted(RENDER))
def test_render_kernel_matches_plain(cuda, role):
    """The whole-render launch against ``render_fused_plain`` at 64^2, 2
    spp, on explicit uniforms: one launch, pixel forks below 2 %, median
    |diff| below 1e-5."""
    g, m, e, args = _fused_inputs(RENDER[role][0], cuda)
    assert g.feats.block_bounds.shape[0] == 1
    kw = _render_kw(g, m, e, role)
    n, spp = args[2].shape[0], 2
    rng_ = np.random.default_rng(17)
    u = torch.as_tensor(rng_.random((spp, 4, n, 5 if kw["nee"] else 2)).astype(np.float32),
                        device=cuda)
    before = dict(fu.LAUNCHES)
    stats = torch.zeros(5, dtype=torch.int64, device=cuda)
    k = fu.render_fused_resident(*args, None, 0, spp, uniforms=u, stats=stats, **kw)
    torch.cuda.synchronize()
    assert fu.LAUNCHES == {**before, "sample_fused": before["sample_fused"] + 1}
    p = fu.render_fused_plain(*args, None, 0, spp, uniforms=u, **kw)
    assert k.shape == (n, 3) and bool(torch.isfinite(k).all()) and float(k.mean()) > 0.0
    diff = (k - p).abs().amax(dim=-1)
    assert float((diff > 1e-3).float().mean()) < 0.02
    assert float(diff.median()) < 1e-5
    assert int(stats[0]) > 0 and int(stats[1]) > 0 and int(stats[3]) > 0


@pytest.mark.parametrize("role", sorted(RENDER))
def test_render_kernel_matches_per_sample_launches(cuda, role):
    """On the kernel's own Philox stream, the whole-render launch (64
    samples, chunked) against 64 one-sample launches plus the IBL and the
    sum on the host: 0 pixel forks at 1e-3; one sample (one chunk) the
    same; and the launch draws what the RNG kernel's stream fed in draws."""
    g, m, e, args = _fused_inputs(RENDER[role][0], cuda)
    kw = _render_kw(g, m, e, role)
    n, spp = args[2].shape[0], 64
    key = rng.key_from_generator(torch.Generator(device=cuda).manual_seed(21), cuda)
    s_kw = {k: kw[k] for k in ("max_bounce", "sun_enabled", "nee", "lights")}
    env = lambda d: sample_ibl(e.ibl, d, bilinear=kw["ibl_bilinear"]) * e.ibl_power
    before = dict(fu.LAUNCHES)
    acc = torch.zeros((n, 3), device=cuda)
    for s in range(spp):
        rad, esc_thr, esc_dir = fu.sample_fused_blocks(*args, key, s, **s_kw)
        acc = acc + rad + esc_thr * env(esc_dir)
    assert fu.LAUNCHES["sample_fused"] == before["sample_fused"] + spp
    assert fu.render_plan(n, spp)["chunks"] > 1
    whole = fu.render_fused_resident(*args, key, 0, spp, **kw)
    assert fu.LAUNCHES["sample_fused"] == before["sample_fused"] + spp + 1
    assert int(((whole - acc).abs().amax(dim=-1) > 1e-3).sum()) == 0
    assert float(whole.mean()) > 0.0
    one = fu.render_fused_resident(*args, key, 5, 1, **kw)
    rad, esc_thr, esc_dir = fu.sample_fused_blocks(*args, key, 5, **s_kw)
    assert int(((one - (rad + esc_thr * env(esc_dir))).abs().amax(dim=-1) > 1e-3).sum()) == 0
    u = torch.stack([rng.uniforms(key, (4, n, 5 if kw["nee"] else 2), s) for s in range(3)])
    assert torch.equal(fu.render_fused_resident(*args, key, 0, 3, **kw),
                       fu.render_fused_resident(*args, None, 0, 3, uniforms=u, **kw))


RENDER_QUEUE = {  # role -> (scene maker, sun, nee, bilinear IBL): 2b's render into a sum
    "outdoor_47_sun_ibl": (lambda dev: tt.make_outdoor_scene(n_cubes=1000, device=dev), True,
                           False, True),
    "outdoor_47_sun_ibl_nearest": (lambda dev: tt.make_outdoor_scene(n_cubes=1000, device=dev),
                                   True, False, False),
    "outdoor_panel_nee": (lambda dev: tt.make_outdoor_scene(n_cubes=1000, emissive_panel=True,
                                                            device=dev), True, True, True),
    "closedbox_nee": (_closedbox, False, True, True),
}


def _queue_render_kw(g, m, e, role):
    _, sun, nee, bilinear = RENDER_QUEUE[role]
    return dict(ibl=e.ibl, ibl_power=e.ibl_power, ibl_bilinear=bilinear, max_bounce=3,
                sun_enabled=sun, nee=nee, lights=build_light_pack(g, m) if nee else None)


@pytest.mark.parametrize("role", sorted(RENDER_QUEUE))
def test_queue_render_kernel_matches_plain(cuda, role):
    """2b's render (``render_fused_queue``: one launch a sample, the IBL and
    the sum inside it) against ``render_fused_plain`` at 64^2, 2 spp, on
    explicit uniforms: one launch a sample, pixel forks below 2 %, median
    |diff| below 1e-5, counts (the escapes looked up among them) within
    1 % of the plain version's."""
    g, m, e, args = _fused_inputs(RENDER_QUEUE[role][0], cuda)
    assert g.feats.block_bounds.shape[0] >= 2 and not ch.resident(g.feats)
    kw = _queue_render_kw(g, m, e, role)
    n, spp = args[2].shape[0], 2
    rng_ = np.random.default_rng(19)
    u = torch.as_tensor(rng_.random((spp, 4, n, 5 if kw["nee"] else 2)).astype(np.float32),
                        device=cuda)
    before = dict(fu.LAUNCHES)
    stats = torch.zeros(fu.queue_stats_len(3), dtype=torch.int64, device=cuda)
    k = fu.render_fused_queue(*args, None, 0, spp, uniforms=u, stats=stats, **kw)
    torch.cuda.synchronize()
    assert fu.LAUNCHES == {**before, "sample_fused_queue": before["sample_fused_queue"] + spp}
    plain_stats = torch.zeros_like(stats)
    p = fu.render_fused_plain(*args, None, 0, spp, uniforms=u, stats=plain_stats, **kw)
    assert k.shape == (n, 3) and bool(torch.isfinite(k).all()) and float(k.mean()) > 0.0
    diff = (k - p).abs().amax(dim=-1)
    assert float((diff > 1e-3).float().mean()) < 0.02
    assert float(diff.median()) < 1e-5
    counted = [0, 1, 2, 3, fu.SEGMENTS, fu.ESCAPE_LOOKUPS, fu.SUBTILES, fu.SUBTILES + 1] + list(
        range(len(fu.QUEUE_STATS), len(stats)))
    ks, ps = stats[counted].double(), plain_stats[counted].double()
    assert bool((ps > 0).all()) and bool(((ks - ps).abs() <= 0.01 * ps).all()), (stats, plain_stats)


@pytest.mark.parametrize("role", sorted(RENDER_QUEUE))
def test_queue_render_kernel_matches_per_sample_launches(cuda, role):
    """On the kernel's own Philox stream, 2b's render of 16 samples against
    16 one-sample launches (no running sum: they write ``rad``,
    ``esc_thr`` and ``esc_dir`` and look up no sky) plus the IBL and the
    sum on the host: 0 pixel forks at 1e-3, one launch a sample either way;
    one sample from an offset the same; the render draws what the RNG
    kernel's stream fed in draws; and record mode still writes what the
    plain recorder writes."""
    g, m, e, args = _fused_inputs(RENDER_QUEUE[role][0], cuda)
    kw = _queue_render_kw(g, m, e, role)
    n, spp, mb = args[2].shape[0], 16, kw["max_bounce"]
    key = rng.key_from_generator(torch.Generator(device=cuda).manual_seed(23), cuda)
    s_kw = {k: kw[k] for k in ("max_bounce", "sun_enabled", "nee", "lights")}
    env = lambda d: sample_ibl(e.ibl, d, bilinear=kw["ibl_bilinear"]) * e.ibl_power
    fields = fu.queue_stats_fields(mb)
    before = dict(fu.LAUNCHES)
    one_stats = torch.zeros(len(fields), dtype=torch.int64, device=cuda)
    acc = torch.zeros((n, 3), device=cuda)
    for s in range(spp):
        rad, esc_thr, esc_dir = fu.sample_fused_queue(*args, key, s, stats=one_stats, **s_kw)
        acc = acc + rad + esc_thr * env(esc_dir)
    assert fu.LAUNCHES["sample_fused_queue"] == before["sample_fused_queue"] + spp
    stats = torch.zeros_like(one_stats)
    whole = fu.render_fused_queue(*args, key, 0, spp, stats=stats, **kw)
    assert fu.LAUNCHES["sample_fused_queue"] == before["sample_fused_queue"] + 2 * spp
    assert int(((whole - acc).abs().amax(dim=-1) > 1e-3).sum()) == 0
    assert float(whole.mean()) > 0.0
    named, one_named = (dict(zip(fields, x.tolist())) for x in (stats, one_stats))
    assert one_named["escape_lookups"] == 0 < named["escape_lookups"] <= spp * n
    one = fu.render_fused_queue(*args, key, 5, 1, **kw)
    rad, esc_thr, esc_dir = fu.sample_fused_queue(*args, key, 5, **s_kw)
    assert int(((one - (rad + esc_thr * env(esc_dir))).abs().amax(dim=-1) > 1e-3).sum()) == 0
    u = torch.stack([rng.uniforms(key, (mb + 1, n, 5 if kw["nee"] else 2), s) for s in range(3)])
    assert torch.equal(fu.render_fused_queue(*args, key, 0, 3, **kw),
                       fu.render_fused_queue(*args, None, 0, 3, uniforms=u, **kw))
    if not kw["nee"]:  # record mode is BSDF-only
        rk = fu.sample_fused_queue(*args, key, 1, record=True, **s_kw)
        rp = fu.sample_fused_plain(*args, key, 1, record=True, **s_kw)
        assert torch.equal(rk[3], rp[3])
        for a, b in zip(rk[4:], rp[4:]):
            assert float((a == b).float().mean()) >= 0.995
        diff = (rk[0] + rk[1] * env(rk[2]) - rp[0] - rp[1] * env(rp[2])).abs().amax(dim=-1)
        assert float((diff > 1e-3).float().mean()) < 0.02 and float(diff.median()) < 1e-5


def test_multi_block_render_replay_runs_one_kernel_a_sample(cuda):
    """Profiled ``render_radiance_jit`` replays on 61 blocks at 2 and at 8
    samples run 2b once a sample and nothing else a sample: besides 2b's
    launches they run the same device kernels, give or take the few that
    a profiler's window misses at its edges (one sample of the per-sample
    loop that the sky lookups and the sum inside 2b replaced ran ~59), and
    each replay renders what its eager call does."""
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import (
        render_radiance,
        render_radiance_jit,
    )

    g, m, e, c = tt.make_outdoor_scene(n_cubes=1300, device=cuda)
    assert g.feats.block_bounds.shape[0] == 61
    gen = lambda: torch.Generator(device=cuda).manual_seed(5)
    counts = {}
    for spp in (2, 8):
        kw = dict(height=128, width=128, spp=spp, max_bounce=4, sun_enabled=True)
        first = render_radiance_jit(g, m, e, c, gen(), **kw)  # warms up and captures
        others = []
        for _ in range(2):
            with launches.trace() as prof:
                replay = render_radiance_jit(g, m, e, c, gen(), **kw)
            kernels = [ev.name() for ev in prof.profiler.kineto_results.events()
                       if ev.device_type() == torch.autograd.DeviceType.CUDA
                       and not ev.is_user_annotation()
                       and not ev.name().startswith(("Memcpy", "Memset"))]
            assert launches.count_kernels(kernels)["sample_fused_queue"] == spp
            assert torch.equal(first, replay)
            others.append(len(kernels) - spp)
        assert torch.equal(replay, render_radiance(g, m, e, c, gen(), **kw))
        counts[spp] = max(others)
    assert abs(counts[8] - counts[2]) <= 5, counts


def test_in_kernel_stream_matches_rng_kernel(cuda):
    """The fused kernel's own Philox draws equal the RNG kernel's stream fed
    in explicitly: the same paths, bit for bit."""
    for make, _, sun, nee in FUSED.values():
        g, m, e, args = _fused_inputs(make, cuda)
        n, mb = args[2].shape[0], 3
        key = rng.key_from_generator(torch.Generator(device=cuda).manual_seed(9), cuda)
        kw = dict(max_bounce=mb, sun_enabled=sun, nee=nee,
                  lights=build_light_pack(g, m) if nee else None)
        own = fu.sample_fused(*args, key, 5, **kw)
        u = rng.uniforms(key, (mb + 1, n, 5 if nee else 2), 5)
        fed = fu.sample_fused(*args, uniforms=u, **kw)
        for a, b in zip(own, fed):
            assert torch.equal(a, b)


def test_rng_kernel_bit_equal_to_plain(cuda):
    key = torch.tensor([123456789, -987654321], dtype=torch.int32, device=cuda)
    for shape, sample in (((1 << 20) + 3,), 0), ((5, 77, 5), 17), ((2,), 3):
        before = rng.LAUNCHES["uniforms"]
        k = rng.uniforms(key, shape, sample)
        assert rng.LAUNCHES["uniforms"] == before + 1
        assert torch.equal(k, rng.uniforms_plain(key, shape, sample))


def _agree(t, tri, hit, ref):
    same = tri == ref.tri
    assert float(same.float().mean()) >= 0.999
    assert float((hit == ref.hit).float().mean()) >= 0.999
    err = (t - ref.t).abs()[same]
    assert bool((err <= 1e-4 * torch.clamp(ref.t[same], min=1.0)).all())


def test_grouped_kernel_matches_plain(cuda):
    g = tt.make_outdoor_scene(n_cubes=100, device=cuda)[0]
    o, d = common.bounce_rays(g, 8192, seed=2)
    before = pg.LAUNCHES["grouped_pairs"]
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    t, tri, hit, pairs = pg.trace_grouped(g.feats, o, d, stats=stats)
    torch.cuda.synchronize()
    assert pg.LAUNCHES["grouped_pairs"] == before + 1
    plain_stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    ref = pg.trace_grouped(g.feats, o, d, engine="plain", stats=plain_stats)
    assert pg.LAUNCHES["grouped_pairs"] == before + 1
    assert int(pairs) == int(ref[3]) > 0
    _agree(t, tri, hit, ch.Hit(*ref[:3]))
    _agree(t, tri, hit, ch.trace_plain(g.feats, o, d))
    assert 0 < int(stats[0]) <= 8192 * g.feats.edges.shape[-1] and int(stats[1]) > 0
    assert stats.tolist() == plain_stats.tolist()  # pairs tested, stagings
    t2, tri2 = pg.grouped_pairs(g.feats, pg.build_schedule(g.feats, o, d))
    t1, tri1 = pg.grouped_pairs(g.feats, pg.build_schedule(g.feats, o, d))
    assert torch.equal(t1.view(torch.int32), t2.view(torch.int32)) and torch.equal(tri1, tri2)


def _compact_fold(feats, o, d, queues, fold):
    """Best keys and counts of ``fold`` over recorded rounds, from no hit."""
    best = torch.full((o.shape[0] + 1,), pc.NO_HIT_KEY, dtype=torch.int64, device=o.device)
    stats = torch.zeros(2, dtype=torch.int64, device=o.device)
    for q in queues:
        fold(feats, o, d, q, best, stats)
    return best, stats


def test_compact_kernel_matches_plain(cuda):
    g = tt.make_outdoor_scene(n_cubes=100, device=cuda)[0]
    o, d = common.bounce_rays(g, 8192, seed=3)
    before = pc.LAUNCHES["pair_compact"]
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    queues = []
    t, tri, hit, rounds = pc.trace_compact(g.feats, o, d, stats=stats, queues=queues)
    torch.cuda.synchronize()
    assert rounds > 0 and pc.LAUNCHES["pair_compact"] == before + rounds
    ref = pc.trace_compact(g.feats, o, d, engine="plain")
    assert ref[3] == rounds and pc.LAUNCHES["pair_compact"] == before + rounds
    _agree(t, tri, hit, ch.Hit(*ref[:3]))
    _agree(t, tri, hit, ch.trace_plain(g.feats, o, d))
    assert 0 < int(stats[0]) <= 8192 * g.feats.edges.shape[-1] and int(stats[1]) > 0
    # on the same rounds: counts equal to the plain version's, two launches bit-equal
    plain_best, plain_stats = _compact_fold(g.feats, o, d, queues, pc.pair_compact_plain)
    assert stats.tolist() == plain_stats.tolist()  # pairs tested, stagings per sub-tile
    first, again = (_compact_fold(g.feats, o, d, queues, pc.pair_compact) for _ in range(2))
    assert torch.equal(first[0], again[0]) and first[1].tolist() == stats.tolist()
    _agree(*pc.key_hit(first[0][:-1]), pc.key_hit(plain_best[:-1]))


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("rt", [32, 96, 1024])
def test_compact_kernel_on_partial_sub_tiles(cuda, rt, k):
    """Tiles whose sub-tiles are partly real and partly padding (3,000 rays,
    tiles of 32, 96 and 1024 slots, 1 or 8 blocks a round): the kernel's
    result and counts against its plain version's on the same rounds."""
    g = tt.make_outdoor_scene(n_cubes=100, device=cuda)[0]
    o, d = common.bounce_rays(g, 3000, seed=4)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    queues = []
    t, tri, hit, rounds = pc.trace_compact(g.feats, o, d, k=k, rt=rt, stats=stats, queues=queues)
    assert rounds == len(queues) > 0
    sub = pc.sub_tile(rt)
    real = torch.stack([(q.queue_rid.view(-1, sub) < 3000).sum(dim=1) for q in queues[:1]])
    assert bool(((real > 0) & (real < sub)).any())  # a partial sub-tile
    plain_best, plain_stats = _compact_fold(g.feats, o, d, queues, pc.pair_compact_plain)
    assert stats.tolist() == plain_stats.tolist()
    _agree(t, tri, hit, pc.key_hit(plain_best[:-1]))
    _agree(t, tri, hit, ch.trace_plain(g.feats, o, d))


@pytest.mark.parametrize("role", ["61_blocks", "586_blocks", "closedbox"])
def test_pairs_kernel_matches_plain(cuda, role):
    """``pairs.cu`` on camera and bounce rays (and, in the closed box,
    shadow rays towards other surfaces, as NEE casts them) against
    ``trace_plain``; its counts, the pairs its test phase's cull let
    through among them, equal the plain version's, and a second launch is
    bit-equal."""
    make, blocks = ROLES[role]
    g, _, _, c = make(cuda)
    assert g.feats.block_bounds.shape[0] == blocks
    o, d = _rays(g, c, cuda, seed=blocks)
    if role == "closedbox":
        so, sd = common.shadow_rays(g, 16384, seed=blocks)
        o, d = torch.cat([o, so]).contiguous(), torch.cat([d, sd]).contiguous()
    before = pp.LAUNCHES["pairs"]
    stats = torch.zeros(4, dtype=torch.int64, device=cuda)
    h = pp.trace_pairs(g.feats, o, d, stats=stats)
    torch.cuda.synchronize()
    assert pp.LAUNCHES["pairs"] == before + 1
    _agree(h.t, h.tri, h.hit, ch.trace_plain(g.feats, o, d))
    assert bool(torch.all(h.hit == (h.t < ch.MISS_T))) and bool(torch.all(h.tri[~h.hit] == 0))
    again = pp.trace_pairs(g.feats, o, d)  # atomics reorder the work, not the result
    assert torch.equal(again.t, h.t) and torch.equal(again.tri, h.tri)
    plain_stats = torch.zeros(4, dtype=torch.int64, device=cuda)
    pp.trace_pairs_plain(g.feats, o, d, stats=plain_stats)
    assert torch.equal(stats, plain_stats)  # the same rounds, pairs, stagings and slab tests


def test_pairs_kernel_makes_no_host_sync_and_is_the_dispatch(cuda):
    g, _, _, c = ROLES["61_blocks"][0](cuda)
    o, d = _rays(g, c, cuda, seed=7, res=64, n_bounce=5000)
    before = dict(pairs=pp.LAUNCHES["pairs"], closest_hit=ch.LAUNCHES["closest_hit"])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = ch.trace(g, o, d)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pp.LAUNCHES["pairs"] == before["pairs"] + 1
    assert ch.LAUNCHES["closest_hit"] == before["closest_hit"]
    _agree(h.t, h.tri, h.hit, ch.trace_plain(g.feats, o, d))
    e = torch.zeros(0, 3, device=cuda)
    h0 = pp.trace_pairs(g.feats, e, e)
    assert h0.t.shape == (0,) and pp.LAUNCHES["pairs"] == before["pairs"] + 1


def test_pairs_kernel_beyond_the_shared_memory_block_limit(cuda):
    """More triangle blocks than the select phase's shared memory holds
    (``csrc/pairs.cuh``'s ``SEL_BLOCKS``, one staging buffer's float4s):
    the select phase stages the bounds in chunks, on the floor of
    ``common.floor_features``."""
    rng = np.random.default_rng(12)
    bx, by = 129, 128
    assert bx * by > pp.SEL_BLOCKS
    feats = common.floor_features(bx, by, cuda)
    o = np.stack([rng.uniform(-bx / 2, bx / 2, 2000), rng.uniform(-by / 2, by / 2, 2000),
                  np.full(2000, 5.0)], axis=-1)
    dd = np.concatenate([rng.normal(scale=0.5, size=(2000, 2)), -np.ones((2000, 1))], axis=-1)
    o, d = (torch.as_tensor(x.astype(np.float32), device=cuda) for x in (o, dd))
    d = torch.nn.functional.normalize(d, dim=-1)
    stats = torch.zeros(4, dtype=torch.int64, device=cuda)
    h = pp.trace_pairs(feats, o, d, stats=stats)
    _agree(h.t, h.tri, h.hit, ch.trace_plain(feats, o, d))
    assert float(h.hit.float().mean()) > 0.3
    plain_stats = torch.zeros(4, dtype=torch.int64, device=cuda)
    pp.trace_pairs_plain(feats, o, d, stats=plain_stats)
    assert torch.equal(stats, plain_stats)


def test_kernel_slice_rule_is_the_plain_rule(cuda):
    """``bq::slices``, called on the host, equals ``ops/pairs.slices`` on
    every item count up to past the grid, on grids around the card's."""
    g = fu.queue_grid()
    grid = g["blocks_per_sm"] * g["sms"]
    for n in (1, 2, 3, 7, grid // 4, grid // 2, grid - 1, grid, grid + 1, 2 * grid):
        for items in range(0, 2 * n + 3):
            assert pp._lib().pairs_slices(items, n) == pp.slices(items, n), (items, n)


def test_kernel_sub_tile_is_the_plain_sub_tile(cuda):
    """Both block-queue kernels cull by ``ops/pairs.SUB`` triangles, the
    sub-tile of ``TriFeatures.sub_bounds``, and 2b keeps four CUDA blocks an
    SM with the cull's entry lists in its shared memory."""
    assert pp._lib().pairs_sub_tile() == pp.SUB == fu._queue_lib().fused_queue_sub_tile()
    assert pp.SUB == ch.SUB_TILE and ch.TRI_TILE == pp.SUBS * pp.SUB
    grid = fu.queue_grid()
    assert grid["blocks_per_sm"] == 4 and grid["registers"] <= 128, grid
    assert pp.kernel_grid()["smem_bytes"] == grid["smem_bytes"]


def test_kernel_select_block_limit_is_the_plain_limit(cuda):
    """Both block-queue kernels keep the bounds of ``ops/pairs.SEL_BLOCKS``
    blocks resident in their select's shared memory and stage more in
    chunks of that many, so the cases above it are above the kernels' own
    limit; ``AGG_BLOCKS`` lies below it (a grouped select keeps every bound
    resident)."""
    assert pp._lib().pairs_sel_blocks() == pp.SEL_BLOCKS == fu._queue_lib().fused_queue_sel_blocks()
    assert pp.AGG_BLOCKS <= pp.SEL_BLOCKS


def test_kernel_select_rule_is_the_plain_rule(cuda):
    """``bq::select_lanes``, called on the host, equals
    ``ops/pairs.select_lanes`` at the live counts around each group size's
    edge, on block counts from 1 to past a warp and grids around the
    card's."""
    g = fu.queue_grid()
    threads = g["blocks_per_sm"] * g["sms"] * g["threads"]
    for grid in (1, 7, 128, threads // 2, threads - 1, threads, threads + 1):
        edges = {0, 1, 2, 3} | {grid // 2 ** k + e for k in range(7) for e in (-1, 0, 1)}
        for nb in (1, 2, 3, 4, 5, 31, 32, 33, 61, 586, 1280, 1281, 1600, 16512):
            for n in sorted(x for x in edges if x >= 0):
                assert (pp._lib().pairs_select_lanes(n, nb, grid)
                        == pp.select_lanes(n, nb, grid)), (n, nb, grid)


@pytest.mark.parametrize("role", ["61_blocks", "586_blocks"])
def test_pairs_kernel_groups_small_selects_exactly(cuda, role):
    """Traces of ``pairs.cu`` few enough that every select round gives each
    ray a group of lanes (``ops/pairs.select_lanes`` > 1 on the launch's
    grid): each ray's hit is bit-equal to the one it gets inside a batch
    whose first round keeps one thread a ray, and to a second launch's, and
    agrees with ``trace_plain``.  Where the hits equal the plain version's
    bit for bit, so do the counts; one ray of the 586-block set at half the
    grid's threads lands on another triangle in the plain version's tensor
    arithmetic on the card, and its best ``t`` admits one more block there
    (256 more pairs).  The one-thread kernel gives the same hits and counts
    on these rays: ``experiments/ab_fused_queue.py``'s ``groups_586``
    holds another source's hits and counts to this one's and prints both
    kernels' forks from the plain version."""
    make, blocks = ROLES[role]
    g, _, _, c = make(cuda)
    assert g.feats.block_bounds.shape[0] == blocks
    grid = pp.kernel_grid()
    threads = grid["blocks_per_sm"] * grid["sms"] * grid["threads"]
    o, d = _rays(g, c, cuda, seed=blocks + 2, n_bounce=threads)
    assert pp.select_lanes(o.shape[0], blocks, threads) == 1
    whole = pp.trace_pairs(g.feats, o, d)
    for n in (300, 5000, threads // 2):
        assert pp.select_lanes(n, blocks, threads) > 1
        part = slice(o.shape[0] - n, o.shape[0])  # bounce rays
        op, dp = o[part].contiguous(), d[part].contiguous()
        stats = torch.zeros(4, dtype=torch.int64, device=cuda)
        h = pp.trace_pairs(g.feats, op, dp, stats=stats)
        again = pp.trace_pairs(g.feats, op, dp)
        for x, y, z in zip(h, whole, again):
            assert torch.equal(x, y[part]) and torch.equal(x, z)
        _agree(h.t, h.tri, h.hit, ch.trace_plain(g.feats, op, dp))
        plain_stats = torch.zeros(4, dtype=torch.int64, device=cuda)
        ref = pp.trace_pairs_plain(g.feats, op, dp, stats=plain_stats)
        forks = int((h.tri != ref.tri).sum())
        assert forks <= 1 and torch.equal(stats[1:], plain_stats[1:]), (n, stats, plain_stats)
        assert abs(int(stats[0] - plain_stats[0])) <= forks * pp.K * ch.TRI_TILE, (n, forks)


@pytest.mark.parametrize("role", ["61_blocks", "586_blocks"])
def test_pairs_kernel_slices_small_traces_exactly(cuda, role):
    """A few hundred rays leave every round of ``pairs.cu`` too few work
    items to fill the grid, so each splits into triangle slices: each ray's
    hit is bit-equal to the one it gets inside a batch whose first round
    fills the grid unsliced, and to a second launch's, agrees with
    ``trace_plain``, and the counts stay the plain version's."""
    make, blocks = ROLES[role]
    g, _, _, c = make(cuda)
    assert g.feats.block_bounds.shape[0] == blocks
    o, d = _rays(g, c, cuda, seed=blocks + 1)
    small = slice(o.shape[0] - 300, o.shape[0])  # 300 bounce rays
    stats = torch.zeros(4, dtype=torch.int64, device=cuda)
    h = pp.trace_pairs(g.feats, o[small].contiguous(), d[small].contiguous(), stats=stats)
    whole = pp.trace_pairs(g.feats, o, d)
    again = pp.trace_pairs(g.feats, o[small].contiguous(), d[small].contiguous())
    assert torch.equal(h.t, whole.t[small]) and torch.equal(h.tri, whole.tri[small])
    assert torch.equal(h.hit, whole.hit[small])
    assert torch.equal(h.t, again.t) and torch.equal(h.tri, again.tri)
    _agree(h.t, h.tri, h.hit, ch.trace_plain(g.feats, o[small], d[small]))
    assert 0.1 < float(h.hit.float().mean()) < 1.0
    plain_stats = torch.zeros(4, dtype=torch.int64, device=cuda)
    pp.trace_pairs_plain(g.feats, o[small], d[small], stats=plain_stats)
    assert torch.equal(stats, plain_stats)


QUEUE = {  # role -> (scene maker, expected blocks or None to read them, sun, nee)
    "47_blocks": (lambda dev: tt.make_outdoor_scene(n_cubes=1000, device=dev), 47, True, False),
    "47_blocks_nee": (lambda dev: tt.make_outdoor_scene(n_cubes=1000, emissive_panel=True,
                                                        device=dev), None, True, True),
    "61_blocks": (lambda dev: tt.make_outdoor_scene(n_cubes=1300, device=dev), 61, True, False),
    "586_blocks": (lambda dev: tt.make_outdoor_scene(n_cubes=12500, device=dev), 586, True,
                   False),
    "4_blocks": (lambda dev: tt.make_outdoor_scene(n_cubes=64, device=dev), 4, True, False),
    "closedbox_nee": (_closedbox, 62, False, True),
}


@pytest.mark.parametrize("role", sorted(QUEUE))
def test_queue_kernel_matches_plain(cuda, role):
    """The multi-block fused kernel against its plain version on one
    explicit stream (forks, median, counts within 1 %, the sub-tile entries
    its test phase's cull offered and kept among them: shading float order
    forks a few knife-edge rays), a second launch bit-equal with the same
    counts, then record mode on the Philox stream (BSDF only; on 4 blocks,
    ``texel8k.grad``'s recorder), which on 586 blocks is beyond the JAX
    recorder's 256, again twice bit-equal."""
    make, blocks, sun, nee = QUEUE[role]
    g, m, e, args = _fused_inputs(make, cuda)
    nb = g.feats.block_bounds.shape[0]
    assert not ch.resident(g.feats) and (blocks is None or nb == blocks)
    n, mb = args[2].shape[0], 3
    rng_ = np.random.default_rng(nb)
    u = torch.as_tensor(rng_.random((mb + 1, n, 5 if nee else 2)).astype(np.float32), device=cuda)
    kw = dict(max_bounce=mb, sun_enabled=sun, uniforms=u, nee=nee,
              lights=build_light_pack(g, m) if nee else None)
    before = dict(fu.LAUNCHES)
    stats = torch.zeros(fu.queue_stats_len(mb), dtype=torch.int64, device=cuda)
    first = fu.sample_fused_queue(*args, stats=stats, **kw)
    k = _image(first, e)
    torch.cuda.synchronize()
    assert fu.LAUNCHES == {**before, "sample_fused_queue": before["sample_fused_queue"] + 1}
    plain_stats = torch.zeros_like(stats)
    p = _image(fu.sample_fused_plain(*args, stats=plain_stats, **kw), e)
    assert bool(torch.isfinite(k).all())
    diff = (k - p).abs().amax(dim=-1)
    assert float((diff > 1e-3).float().mean()) < 0.02
    assert float(diff.median()) < 1e-5
    # pairs, stagings, rounds, slab tests, segments, sub-tile entries, segments by bounce
    counted = [0, 1, 2, 3, fu.SEGMENTS, fu.SUBTILES, fu.SUBTILES + 1] + list(
        range(len(fu.QUEUE_STATS), len(stats)))
    ks, ps = stats[counted].double(), plain_stats[counted].double()
    assert bool((ps > 0).all()) and bool(((ks - ps).abs() <= 0.01 * ps).all()), (stats, plain_stats)
    fields = fu.queue_stats_fields(mb)
    named = dict(zip(fields, stats.tolist()))
    assert 0 < named["subtiles_tested"] <= named["subtiles_offered"]
    assert named["pairs"] == pp.SUB * named["subtiles_tested"]
    again_stats = torch.zeros_like(stats)
    again = fu.sample_fused_queue(*args, stats=again_stats, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, first))
    counts = [i for i, f in enumerate(fields) if not f.endswith("cycles")]
    assert torch.equal(again_stats[counts], stats[counts])
    # one sync to start, per bounce two around each trace loop, four per round
    loops = 1 + int(sun)
    assert int(stats[4]) == 1 + (mb + 1) * 2 * loops + 4 * int(stats[2]) and int(plain_stats[4]) == 0
    assert 0 < named["sync_cycles"] < named["kernel_cycles"]
    assert 0 < named["select_cycles"] < named["kernel_cycles"]
    assert all(v == 0 for f, v in zip(fields, plain_stats.tolist()) if f.endswith("cycles"))
    if not nee:
        key = rng.key_from_generator(torch.Generator(device=cuda).manual_seed(4), cuda)
        rk = fu.sample_fused_queue(*args, key, 1, max_bounce=mb, sun_enabled=sun, record=True)
        rp = fu.sample_fused_plain(*args, key, 1, max_bounce=mb, sun_enabled=sun, record=True)
        assert torch.equal(rk[3], rp[3])
        for a, b in zip(rk[4:], rp[4:]):
            assert float((a == b).float().mean()) >= 0.995
        rk2 = fu.sample_fused_queue(*args, key, 1, max_bounce=mb, sun_enabled=sun, record=True)
        assert all(torch.equal(a, b) for a, b in zip(rk, rk2))


@pytest.mark.parametrize("mb, sun", [(4, True), (0, False)], ids=["render", "first_bounce"])
def test_queue_kernel_matches_plain_on_the_outdoor600k_scene(cuda, mb, sun):
    """One 2b sample of ``outdoor600k.render``'s scene (600,002 triangles in
    2,344 blocks, above ``AGG_BLOCKS`` and ``SEL_BLOCKS``: every select one
    thread a ray over bounds staged in chunks) at its 65,536 lanes on the
    kernel's own Philox stream, against its plain version: the image agrees
    (forks and median as ``test_queue_kernel_matches_plain``), no select
    groups lanes, and a second launch gives the same outputs and counts.
    With one bounce and no sun the counts are those of one trace of the
    bounce rays off the camera rays' hits, and equal the plain version's
    exactly, so a pick that depended on the chunking would show; with the
    render's 4 bounces and sun a knife-edge ray that forks in shading's
    float order changes the later traces, so the counts agree within 1 %."""
    g, m, e, c = _outdoor600k(cuda)
    assert g.feats.block_bounds.shape[0] == 2344
    args = _fused_inputs(lambda dev: (g, m, e, c), cuda, res=256)[3]
    assert args[2].shape[0] == 65536
    key = rng.key_from_generator(torch.Generator(device=cuda).manual_seed(25), cuda)
    kw = dict(max_bounce=mb, sun_enabled=sun)
    fields = fu.queue_stats_fields(mb)
    runs = []
    for sample in (fu.sample_fused_queue, fu.sample_fused_queue, fu.sample_fused_plain):
        stats = torch.zeros(len(fields), dtype=torch.int64, device=cuda)
        out = sample(*args, key, 0, stats=stats, **kw)
        runs.append((dict(zip(fields, stats.tolist())), out))
    (named, out), (again, out2), (plain, ref) = runs
    assert all(torch.equal(a, b) for a, b in zip(out, out2))
    assert all(named[f] == again[f] for f in fields if not f.endswith("cycles"))
    diff = (_image(out, e) - _image(ref, e)).abs().amax(dim=-1)
    assert float((diff > 1e-3).float().mean()) < 0.02 and float(diff.median()) < 1e-5
    gap = 0.01 if mb else 0.0
    for f in fu.QUEUE_STATS[:4] + ("segments", "subtiles_offered", "subtiles_tested") + tuple(
            f"lanes.{b}" for b in range(mb + 1)):
        assert abs(named[f] - plain[f]) <= gap * plain[f], (f, named, plain)
    assert named["coop_select_rounds"] == 0 and named["rounds"] > 0
    assert 0 < named["select_cycles"] < named["kernel_cycles"]


@pytest.mark.parametrize("role", ["61_blocks", "586_blocks"])
def test_queue_kernel_slices_small_samples_exactly(cuda, role):
    """A 2b sample of 256 lanes has too few work items in every round to
    fill the grid: rounds split into triangle slices (``split_rounds`` > 0,
    ``items`` > ``stagings``), and every select gives each ray a group of
    lanes (``coop_select_rounds`` = ``rounds``); each lane's outputs are
    bit-equal to its rows of a 65,536-lane sample on the same uniforms
    (whose first rounds run unsliced, one thread a ray) and to a second
    launch's, the counts are the plain version's within 1 % and the image
    agrees with it."""
    make, blocks, sun, nee = QUEUE[role]
    g, m, e, args = _fused_inputs(make, cuda, res=256)
    assert g.feats.block_bounds.shape[0] == blocks
    n, mb, lanes = args[2].shape[0], 3, 256
    u = torch.as_tensor(np.random.default_rng(blocks).random((mb + 1, n, 2)).astype(np.float32),
                        device=cuda)
    kw = dict(max_bounce=mb, sun_enabled=sun)
    part = args[:2] + tuple(x[:lanes].contiguous() for x in args[2:9]) + args[9:]
    up = u[:, :lanes].contiguous()
    fields = fu.queue_stats_fields(mb)
    stats = torch.zeros(len(fields), dtype=torch.int64, device=cuda)
    small = fu.sample_fused_queue(*part, stats=stats, uniforms=up, **kw)
    again_stats = torch.zeros_like(stats)
    again = fu.sample_fused_queue(*part, stats=again_stats, uniforms=up, **kw)
    big_stats = torch.zeros_like(stats)
    big = fu.sample_fused_queue(*args, stats=big_stats, uniforms=u, **kw)
    named, big_named = (dict(zip(fields, x.tolist())) for x in (stats, big_stats))
    assert named["split_rounds"] > 0 and named["items"] > named["stagings"] > 0
    assert named["items"] <= pp.S_MAX * named["stagings"]
    assert big_named["split_rounds"] < big_named["rounds"]  # the first rounds fill the grid
    assert named["coop_select_rounds"] == named["rounds"] > 0
    assert 0 < big_named["coop_select_rounds"] < big_named["rounds"]
    for a, b, c in zip(small, again, big):
        assert torch.equal(a, b) and torch.equal(a, c[:lanes])
    counts = [i for i, f in enumerate(fields) if not f.endswith("cycles")]
    assert torch.equal(again_stats[counts], stats[counts])
    plain_stats = torch.zeros_like(stats)
    p = _image(fu.sample_fused_plain(*part, stats=plain_stats, uniforms=up, **kw), e)
    diff = (_image(small, e) - p).abs().amax(dim=-1)
    assert float((diff > 1e-3).float().mean()) < 0.02 and float(diff.median()) < 1e-5
    counted = [0, 1, 2, 3, fu.SEGMENTS] + list(range(len(fu.QUEUE_STATS), len(stats)))
    ks, ps = stats[counted].double(), plain_stats[counted].double()
    assert bool((ps[:5] > 0).all()) and bool(((ks - ps).abs() <= 0.01 * ps).all()), (stats,
                                                                                    plain_stats)
    for f in ("split_rounds", "items", "coop_select_rounds"):
        assert plain_stats[fu.QUEUE_STATS.index(f)] == 0


def _floor_sample(dev, n, side=40):
    """A 2b sample of ``n`` lanes on a ``side`` x ``side``-block floor
    (``common.floor_sample_inputs``), each trace one round of every lane.
    Its outputs and counts, those of a second launch, and the plain
    version's."""
    args, kw = common.floor_sample_inputs(side, n, dev)
    fields = fu.queue_stats_fields(0)
    runs = []
    for sample in (fu.sample_fused_queue, fu.sample_fused_queue, fu.sample_fused_plain):
        stats = torch.zeros(len(fields), dtype=torch.int64, device=dev)
        out = sample(*args, stats=stats, **kw)
        runs.append((dict(zip(fields, stats.tolist())), out))
    return runs


def test_queue_kernel_keeps_full_rounds_whole(cuda):
    """A 2b sample whose every trace is one round with more work items than
    the grid holds twice (4,096 lanes of ``_floor_sample``) splits no round:
    ``split_rounds`` 0 and ``items`` equal to ``stagings``; its counts
    equal the plain version's."""
    (named, out), _, (plain, ref) = _floor_sample(cuda, 4096)
    grid = fu.queue_grid()
    assert named["rounds"] == 2 and named["stagings"] > grid["blocks_per_sm"] * grid["sms"]
    assert named["split_rounds"] == 0 and named["items"] == named["stagings"]
    assert all(named[f] == plain[f] for f in fu.QUEUE_STATS[:4])
    for a, b in zip(out, ref):
        assert float((a - b).abs().max()) < 1e-5


@pytest.mark.parametrize("side, full, grouped", [(32, False, 2), (32, True, 0), (40, False, 0),
                                                (41, False, 0)],
                         ids=["few_rays", "full_grid", "above_agg_blocks", "above_sel_blocks"])
def test_queue_kernel_groups_selects_below_a_full_grid(cuda, side, full, grouped):
    """The two rounds of a ``_floor_sample`` on 32 x 32 blocks select with a
    group of lanes a ray when their rays are too few to fill the grid's
    threads twice (4,096 lanes: ``coop_select_rounds`` 2) and with one
    thread a ray when they fill it (as many lanes as the grid has threads:
    ``coop_select_rounds`` 0); on 40 x 40 blocks, more than
    ``ops/pairs.AGG_BLOCKS``, 4,096 lanes keep one thread a ray, and on 41 x
    41, more than ``bq::SEL_BLOCKS`` (1,600), too, with the block bounds
    staged in chunks for every batch of rays.  Either way the counts of
    pairs, stagings, rounds, slab tests, segments and lanes are the plain
    version's, the outputs agree with it, and a second launch gives the same
    outputs and counts bit for bit."""
    grid = fu.queue_grid()
    threads = grid["blocks_per_sm"] * grid["sms"] * grid["threads"]
    n = threads if full else 4096
    assert (side * side > pp.AGG_BLOCKS) == (side >= 40)
    assert (side * side > pp.SEL_BLOCKS) == (side == 41)
    (named, out), (again, out2), (plain, ref) = _floor_sample(cuda, n, side)
    assert named["rounds"] == 2 and named["segments"] == 2 * n
    assert named["coop_select_rounds"] == grouped
    assert plain["coop_select_rounds"] == 0
    for f in fu.QUEUE_STATS[:4] + ("segments", "lanes.0"):
        assert named[f] == plain[f], (f, named, plain)
    for a, b, c in zip(out, ref, out2):
        assert float((a - b).abs().max()) < 1e-5 and torch.equal(a, c)
    assert all(named[f] == again[f] for f in named if not f.endswith("cycles"))
    assert 0 < named["select_cycles"] < named["kernel_cycles"]


def test_queue_kernel_makes_no_host_sync_and_is_the_dispatch(cuda):
    """One multi-block sample through ``sample_fused`` under
    ``set_sync_debug_mode("error")`` launches the queue kernel once and
    nothing else; its own Philox draws equal the RNG kernel's stream fed in,
    bit for bit, with NEE; an empty batch launches nothing."""
    make = QUEUE["47_blocks_nee"][0]
    g, m, e, args = _fused_inputs(make, cuda)
    n, mb = args[2].shape[0], 3
    key = rng.key_from_generator(torch.Generator(device=cuda).manual_seed(9), cuda)
    kw = dict(max_bounce=mb, sun_enabled=True, nee=True, lights=build_light_pack(g, m))
    before = dict(fu.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        own = fu.sample_fused(*args, key, 5, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fu.LAUNCHES == {**before, "sample_fused_queue": before["sample_fused_queue"] + 1}
    fed = fu.sample_fused(*args, uniforms=rng.uniforms(key, (mb + 1, n, 5), 5), **kw)
    for a, b in zip(own, fed):
        assert torch.equal(a, b)
    empty = [x[:0] for x in args[2:9]]
    out = fu.sample_fused(*args[:2], *empty, *args[9:], key, 0, **kw)
    assert out[0].shape == (0, 3)
    assert fu.LAUNCHES["sample_fused_queue"] == before["sample_fused_queue"] + 2


GRAD_SCENES = {  # the gradient path: one block (fused_sample) and four (fused_queue)
    "one_block": (lambda dev: tt.make_cornell_scene(device=dev), False),
    "4_blocks": (lambda dev: tt.make_outdoor_scene(n_cubes=64, device=dev), True),
}


@pytest.mark.parametrize("role", sorted(GRAD_SCENES))
def test_replay_of_fused_records_matches_forward_render(cuda, role):
    """The fused recorder (one record launch per sample) and the replay of
    its records give the fused forward render of the same generator seed:
    forks < 2 %, median |diff| < 1e-5 (float order and the kernel's
    transcendental functions against torch's)."""
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import radiance_for_rays
    from ensem3a_openclraytracer_tpu_torch.models.replay import record_paths, replay_radiance

    make, sun = GRAD_SCENES[role]
    g, m, e, c = make(cuda)
    o, d = camera_rays(c.position, c.rotation_deg, c.fov_deg, 64, 64)
    spp, mb = 4, 3
    key = rng.key_from_generator(torch.Generator(device=cuda).manual_seed(3), cuda)
    kern = "sample_fused" if ch.resident(g.feats) else "sample_fused_queue"
    before = fu.LAUNCHES[kern]
    rec = record_paths(g, m, e, o, d, key, spp=spp, max_bounce=mb, sun_enabled=sun)
    assert fu.LAUNCHES[kern] == before + spp
    with torch.no_grad():
        img_r = replay_radiance(rec, g, m, e, d, sun_enabled=sun)
    img_f = radiance_for_rays(g, m, e, o, d, torch.Generator(device=cuda).manual_seed(3),
                              spp=spp, max_bounce=mb, sun_enabled=sun)
    diff = (img_r - img_f).abs().amax(dim=-1)
    assert torch.isfinite(img_r).all()
    assert float((diff > 1e-3).float().mean()) < 0.02 and float(diff.median()) < 1e-5


def _replay_grads(make, dev, u, sun, res, mb):
    from ensem3a_openclraytracer_tpu_torch.models.replay import render_radiance_replay

    g, m, e, c = make(dev)
    leaves = [x.clone().requires_grad_(True)
              for x in (m.color, m.roughness, e.sun_power, e.ibl_power, e.ibl)]
    img = render_radiance_replay(
        g, m._replace(color=leaves[0], roughness=leaves[1]),
        e._replace(sun_power=leaves[2], ibl_power=leaves[3], ibl=leaves[4]), c, height=res,
        width=res, spp=u.shape[0], max_bounce=mb, sun_enabled=sun,
        uniforms=torch.as_tensor(u, device=dev))
    grads = torch.autograd.grad(torch.mean(img ** 2), leaves, allow_unused=True)
    return [torch.zeros_like(x).cpu() if gx is None else gx.cpu() for gx, x in zip(grads, leaves)]


@pytest.mark.parametrize("role", sorted(GRAD_SCENES))
def test_replay_gradients_on_card_match_cpu(cuda, role):
    """The replay's gradients with the scan recorder on the card's trace
    kernels equal the same call on the CPU to 1e-4 relative per parameter."""
    make, sun = GRAD_SCENES[role]
    res, spp, mb = 32, 2, 3
    u = np.random.default_rng(5).random((spp, mb + 1, res * res, 2)).astype(np.float32)
    card = _replay_grads(make, cuda, u, sun, res, mb)
    cpu = _replay_grads(make, torch.device("cpu"), u, sun, res, mb)
    for a, b in zip(card, cpu):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-12)
    assert float(card[0].abs().max()) > 0.0


def test_kill_and_resume_on_card_is_bit_equal(cuda, tmp_path):
    """A run stopped after 3 iterations and resumed from its checkpoint
    gives the uninterrupted run's losses bit for bit on the card: the
    recorder, the replay and its backward are deterministic there."""
    from ensem3a_openclraytracer_tpu_torch.models import optimize as opt

    g, m, e, c = tt.make_cornell_scene(device=cuda)
    init, step = opt.make_train_step(g, m, e, c, opt.Adam(5e-2), height=32, width=32, spp=2,
                                     max_bounce=3, sun_enabled=False)
    target = torch.zeros((32, 32, 3), device=cuda)
    full, resumed = [], []
    opt.run_optimization(init, step, target, 3, iters=6, log=lambda i, x: full.append(x))
    ckpt = str(tmp_path / "opt.npz")
    for iters in (3, 6):
        opt.run_optimization(init, step, target, 3, iters=iters, checkpoint_path=ckpt,
                             checkpoint_every=3, log=lambda i, x: resumed.append(x))
    assert resumed == full and full[-1] < full[0]


@pytest.mark.parametrize("rows", [6, 36, 4096 * 8192])
def test_gather_rows_backward_is_deterministic_on_card(cuda, rows):
    """``ops/gathers.scatter_rows`` (the backward of every replay gather)
    repeats bit for bit on the card, where the embedding backward and
    ``index_add_`` add with atomics, and equals a float64 reference to
    float32 rounding."""
    from ensem3a_openclraytracer_tpu_torch.ops.gathers import scatter_rows

    r = np.random.default_rng(rows % 1000)
    n = 262144
    idx = torch.as_tensor(r.integers(0, rows, n), device=cuda)
    grad = torch.as_tensor(r.standard_normal((n, 3)).astype(np.float32), device=cuda)
    ref = scatter_rows(grad, idx, rows)
    for _ in range(3):
        junk = torch.empty(int(r.integers(1, 1 << 22)), device=cuda)  # move the allocator
        assert torch.equal(scatter_rows(grad, idx, rows), ref)
    del junk
    exact = torch.zeros((rows, 3), dtype=torch.float64, device=cuda).index_add_(
        0, idx, grad.to(torch.float64))
    assert float((ref.to(torch.float64) - exact).abs().max()) <= 1e-5 * max(
        float(exact.abs().max()), 1.0)


def _launches() -> dict:
    return launches.read()


def _zero_launches() -> None:
    launches.reset()


def _traced_launches(fn) -> dict:
    """The port's kernels that a torch.profiler trace of ``fn()`` saw run,
    by counter: a graph replay runs no wrapper, so its launches are counted
    here."""
    with launches.trace() as prof:
        fn()
    return launches.count_kernels(
        ev.name for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA)


@pytest.mark.parametrize("role", ["one_block", "61_blocks"])
def test_progressive_chunks_equal_one_shot_renders_on_card(cuda, role, tmp_path):
    """A progressive render on the default (fused) engine is the float64
    fold of ``render_radiance(gen=iteration_generator(seed, i),
    spp=chunk_spp)`` bit for bit, and a render stopped after two chunks
    and resumed from its checkpoint equals one that ran through."""
    from ensem3a_openclraytracer_tpu_torch.models.optimize import iteration_generator
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance
    from ensem3a_openclraytracer_tpu_torch.models.progressive import ProgressiveRenderer

    g, m, e, c = ROLES[role][0](cuda)
    sun = role != "one_block"
    kw = dict(height=64, width=64, max_bounce=3, chunk_spp=4, sun_enabled=sun)
    full = ProgressiveRenderer(g, m, e, c, base_seed=7, **kw)
    img = full.render(16)
    acc = np.zeros((64, 64, 3))
    for i in range(4):
        chunk = render_radiance(g, m, e, c, iteration_generator(7, i, cuda), height=64, width=64,
                                spp=4, max_bounce=3, sun_enabled=sun)
        acc = acc + chunk.cpu().numpy().astype(np.float64) * 4
    assert np.array_equal(img, (acc / 16).astype(np.float32))
    ckpt = str(tmp_path / "p.npz")
    ProgressiveRenderer(g, m, e, c, base_seed=7, **kw).render(8, checkpoint_path=ckpt)
    resumed = ProgressiveRenderer.resume(ckpt, g, m, e, c, **kw)
    resumed.render(16)
    assert np.array_equal(resumed.state.accum, full.state.accum)


@pytest.mark.parametrize("case", ["cornell", "outdoor_1000"])
def test_cli_render_launch_counts_on_card(cuda, case, tmp_path, monkeypatch):
    """``cli render`` on the card goes through the kernels: Cornell (one
    block) launches ``closest_hit`` and ``sample_fused`` once per chunk,
    outdoor_1000 (47 blocks) ``pairs`` once per chunk and
    ``sample_fused_queue`` once per sample.  The wrappers count the first
    chunk (the chunk graph's warm-up); a profiler trace counts every
    chunk's."""
    from ensem3a_openclraytracer_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    make = (tt.make_cornell_scene if case == "cornell"
            else lambda device: tt.make_outdoor_scene(n_cubes=1000, device=device))
    path = str(tmp_path / f"{case}.obj")
    tt.write_scene_files(path, *make(device="cpu"), resolution=64, spp=8, max_bounce=3)
    argv = ["render", path, "--chunk-spp", "4", "--out", str(tmp_path / "o.png")]
    _zero_launches()
    assert main(argv) == 0
    got = _launches()  # the first chunk, which warms up and captures; the second replays
    first = ({"closest_hit": 1, "pairs": 0, "sample_fused": 1, "sample_fused_queue": 0}
             if case == "cornell" else
             {"closest_hit": 0, "pairs": 1, "sample_fused": 0, "sample_fused_queue": 4})
    assert {k: got[k] for k in first} == first and got["uniforms"] == 0
    traced = _traced_launches(lambda: main(argv))
    want = {k: 2 * v for k, v in first.items()}
    assert {k: traced[k] for k in want} == want and traced["uniforms"] == 0


def test_cli_mesh_joins_nccl_from_torchrun_env(cuda, tmp_path, monkeypatch):
    """``render --mesh 1,1`` with ``torchrun``'s environment set for one
    rank joins an ``nccl`` group on ``cuda:0`` through
    ``parallel/distributed.initialize``, and its progressive sum is the one
    the render without ``--mesh`` makes, bit for bit."""
    import socket

    import torch.distributed as dist

    from ensem3a_openclraytracer_tpu_torch.cli import main
    from ensem3a_openclraytracer_tpu_torch.models.progressive import ProgressiveState

    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "cornell.obj")
    tt.write_scene_files(path, *tt.make_cornell_scene(device="cpu"), resolution=32, spp=8,
                         max_bounce=3)

    def render(tag, *extra):
        ckpt = str(tmp_path / f"{tag}.npz")
        assert main(["render", path, "--chunk-spp", "4", "--checkpoint", ckpt,
                     "--out", str(tmp_path / tag / "o.png"), *extra]) == 0
        return ProgressiveState.load(ckpt).accum

    plain = render("plain")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    assert not dist.is_initialized()
    try:
        sharded = render("mesh", "--mesh", "1,1")
        assert dist.is_initialized() and dist.get_backend() == "nccl"
        assert dist.get_world_size() == 1 and torch.cuda.current_device() == 0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert np.array_equal(sharded, plain)


# --- the tree: bvh_trace (csrc/bvh_trace.cu) and the device build ------------

TREES = {  # role -> tree-only scene maker
    "cornell": lambda dev: tt.make_cornell_scene(use_bvh=True, device=dev),
    "outdoor_64": lambda dev: tt.make_outdoor_scene(n_cubes=64, use_bvh=True, device=dev),
}


def _tree_rays(g, cam, dev, seed, res=64, n_bounce=4096):
    """Camera rays plus bounce rays from their hits (the tree's plain walk)."""
    o, d = camera_rays(cam.position, cam.rotation_deg, cam.fov_deg, res, res)
    h = tv.trace_bvh_plain(g.bvh, g.v0, g.v1, g.v2, o.contiguous(), d.contiguous())
    rng = np.random.default_rng(seed)
    pick = torch.as_tensor(rng.integers(0, o.shape[0], n_bounce), device=dev)
    bd = torch.as_tensor(rng.normal(size=(n_bounce, 3)).astype(np.float32), device=dev)
    bd = torch.nn.functional.normalize(bd, dim=-1)
    bo = o[pick] + d[pick] * h.t[pick, None]
    return torch.cat([o, bo]).contiguous(), torch.cat([d, bd]).contiguous()


def _hold_bvh_kernel(g, o, d, card_plain=True):
    """``trace_bvh`` (one kernel launch) against ``trace_bvh_plain`` on the
    CPU (the same arithmetic op for op: ``t``, ``tri``, ``hit`` equal), its
    five counts equal to the CPU walk's, a second launch bit-equal to the
    first, and with ``card_plain`` against ``trace_bvh_plain`` on the card
    at phase 2's bounds (``test_bvh_plain_walk_on_card_equals_cpu_walk``
    holds the card's walk to the CPU's bit for bit)."""
    before = tv.LAUNCHES["bvh_trace"]
    stats = torch.zeros(5, dtype=torch.int64, device=o.device)
    h = tv.trace_bvh(g.bvh, g.v0, g.v1, g.v2, o, d, stats=stats)
    h2 = tv.trace_bvh(g.bvh, g.v0, g.v1, g.v2, o, d)
    torch.cuda.synchronize()
    assert tv.LAUNCHES["bvh_trace"] == before + 2
    assert h.tri.dtype == torch.int64 and h.hit.dtype == torch.bool
    if card_plain:
        _agree(h.t, h.tri, h.hit, tv.trace_bvh_plain(g.bvh, g.v0, g.v1, g.v2, o, d))
    cpu = lambda x: x.cpu()
    gc = [cpu(x) for x in (g.v0, g.v1, g.v2)]
    nodes_c = tv.BVHNodes(*(cpu(x) for x in g.bvh))
    stats_c = torch.zeros(5, dtype=torch.int64)
    hc = tv.trace_bvh_plain(nodes_c, *gc, cpu(o), cpu(d), stats=stats_c)
    assert torch.equal(h.t.cpu(), hc.t) and torch.equal(h.tri.cpu(), hc.tri)
    assert torch.equal(h.hit.cpu(), hc.hit)
    assert torch.equal(stats.cpu(), stats_c) and int(stats_c[2]) == 0
    for a, b in zip(h2, h):
        assert torch.equal(a, b)
    assert torch.equal(h2.t.view(torch.int32), h.t.view(torch.int32))


@pytest.mark.parametrize("role", sorted(TREES))
def test_bvh_kernel_matches_plain(cuda, role):
    """Camera and bounce rays (see ``_hold_bvh_kernel``)."""
    g, _, _, c = TREES[role](cuda)
    assert g.feats is None and tv._rows(g.bvh).device.type == "cuda"
    o, d = _tree_rays(g, c, cuda, seed=3)
    _hold_bvh_kernel(g, o, d)


@pytest.mark.parametrize("rays", ["cornell_shared_edges", "outdoor_64_grazing"])
def test_bvh_kernel_matches_plain_on_ties(cuda, rays):
    """Rays through the edges that Cornell's triangles share (two triangles
    at about the same ``t``: the first one found must stay) and rays
    grazing the outdoor ground, held to the CPU walk as in
    ``_hold_bvh_kernel``.  These rays are built to sit on knife edges; the
    card's own plain walk is held to the CPU's on them by
    ``test_bvh_plain_walk_on_card_equals_cpu_walk``."""
    if rays == "cornell_shared_edges":
        g = TREES["cornell"](cuda)[0]
        o, d = tt.shared_edge_rays(g, n_origins=32, per_edge=8)
    else:
        g = TREES["outdoor_64"](cuda)[0]
        o, d = tt.grazing_rays(g, n=8192)
    assert o.device.type == "cuda"
    _hold_bvh_kernel(g, o, d, card_plain=False)


@pytest.mark.parametrize("rays", ["cornell_shared_edges", "outdoor_64_grazing"])
def test_bvh_plain_walk_on_card_equals_cpu_walk(cuda, rays):
    """``trace_bvh_plain`` on the card against the same walk on the CPU, bit
    for bit (``t``, ``tri``, ``hit`` and the five counts) on the knife-edge
    rays: its cross and dot products are rounded op by op (``cross_rn``,
    ``dot_rn``), so the walk does not depend on the device."""
    if rays == "cornell_shared_edges":
        g = TREES["cornell"](cuda)[0]
        o, d = tt.shared_edge_rays(g, n_origins=32, per_edge=8)
    else:
        g = TREES["outdoor_64"](cuda)[0]
        o, d = tt.grazing_rays(g, n=8192)
    stats = torch.zeros(5, dtype=torch.int64, device=cuda)
    h = tv.trace_bvh_plain(g.bvh, g.v0, g.v1, g.v2, o, d, stats=stats)
    cpu = lambda x: x.cpu()
    stats_c = torch.zeros(5, dtype=torch.int64)
    hc = tv.trace_bvh_plain(tv.BVHNodes(*(cpu(x) for x in g.bvh)), *(cpu(x) for x in
                            (g.v0, g.v1, g.v2, o, d)), stats=stats_c)
    assert torch.equal(h.t.cpu().view(torch.int32), hc.t.view(torch.int32))
    assert torch.equal(h.tri.cpu(), hc.tri) and torch.equal(h.hit.cpu(), hc.hit)
    assert torch.equal(stats.cpu(), stats_c)


def test_bvh_device_build_on_card_equals_host(cuda):
    from ensem3a_openclraytracer_tpu_torch.accel import build_lbvh, validate_bvh
    from ensem3a_openclraytracer_tpu_torch.accel.lbvh_device import build_lbvh_device

    soups = [tt.make_outdoor_scene(n_cubes=1300, device="cpu")[0]]
    c = np.repeat(np.random.default_rng(0).uniform(-1, 1, (50, 3)), 40, axis=0).astype(np.float32)
    soups.append((c, c + np.float32([0.01, 0, 0]), c + np.float32([0, 0.01, 0])))
    for g in soups:
        v = [x.numpy() if isinstance(x, torch.Tensor) else x for x in (g[0], g[1], g[2])]
        dev_nodes = build_lbvh_device(*v, device=cuda)
        host = build_lbvh(*v)
        for f in ("left", "right", "bmin", "bmax", "tri"):
            a = getattr(dev_nodes, f)
            assert a.device.type == "cuda"
            np.testing.assert_array_equal(a.cpu().numpy(), getattr(host, f), err_msg=f)
        validate_bvh(dev_nodes, v[0].shape[0])


def test_bvh_trace_makes_no_host_sync_and_is_the_dispatch(cuda):
    g, _, _, c = TREES["outdoor_64"](cuda)
    o, d = _tree_rays(g, c, cuda, seed=9, res=32, n_bounce=1000)
    read = lambda: (tv.LAUNCHES["bvh_trace"], ch.LAUNCHES["closest_hit"], pp.LAUNCHES["pairs"])
    start = read()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = ch.trace(g, o, d)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert read() == (start[0] + 1, start[1], start[2])
    _agree(h.t, h.tri, h.hit, tv.trace_bvh_plain(g.bvh, g.v0, g.v1, g.v2, o, d))
    e = torch.zeros(0, 3, device=cuda)
    assert tv.trace_bvh(g.bvh, g.v0, g.v1, g.v2, e, e).t.shape == (0,)
    assert tv.LAUNCHES["bvh_trace"] == start[0] + 1
    with pytest.raises(ValueError, match="contiguous"):
        tv.trace_bvh(g.bvh, g.v0.t().contiguous().t(), g.v1, g.v2, o, d)
    with pytest.raises(ValueError, match="row layout"):
        tv.trace_bvh(tv.BVHNodes(*(x.contiguous() for x in g.bvh)), g.v0, g.v1, g.v2, o, d)


# --- the compiled entry points as captured CUDA graphs (utils/graphs.py) -------------------


def _same(a, b) -> bool:
    from ensem3a_openclraytracer_tpu_torch.utils.graphs import flatten

    (la, sa), (lb, sb) = flatten(a), flatten(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(la, lb))


def _hold_graph(graphed, eager, graph):
    """The first call captures one graph; it, the first replay and a replay
    with a new key equal the eager call bit for bit, and a new key moves
    the output.  The first call's warm-up launches the eager call's kernels
    (counted by the wrappers), the graph recorded them, a replay counts
    none, and a profiled replay runs them (counted in its trace)."""
    captures = graph.captures
    _zero_launches()
    first = graphed(1)
    warm = _launches()
    assert graph.captures == captures + 1
    _zero_launches()
    replay = graphed(1)
    assert not any(_launches().values())
    _zero_launches()
    ref = eager(1)
    want = _launches()
    assert _same(first, ref) and _same(replay, ref)
    assert warm == want and sum(want.values()) > 0
    assert graph.last_capture["launches"] == {k: v for k, v in want.items() if v}
    assert _traced_launches(lambda: graphed(3)) == want
    new = graphed(2)
    assert _same(new, eager(2)) and not _same(new, replay)
    assert graph.captures == captures + 1


GRAPH_RENDERS = {  # role -> (scene maker, render settings)
    "cornell": (lambda dev: tt.make_cornell_scene(device=dev), dict(spp=8, sun_enabled=False)),
    "cornell_nee": (lambda dev: tt.make_cornell_scene(device=dev),
                    dict(spp=8, sun_enabled=False, nee=True)),
    "outdoor_1300": (lambda dev: tt.make_outdoor_scene(n_cubes=1300, device=dev),
                     dict(spp=4, sun_enabled=True)),
    "outdoor_1300_tree": (lambda dev: tt.make_outdoor_scene(n_cubes=1300, use_bvh=True,
                                                            device=dev),
                          dict(spp=4, sun_enabled=True)),
    "closedbox_nee": (_closedbox, dict(spp=4, sun_enabled=False, nee=True)),
}


@pytest.mark.parametrize("role", sorted(GRAPH_RENDERS))
def test_render_radiance_jit_graph_equals_eager(cuda, role):
    """``render_radiance_jit`` on the card (one-block whole-render launch,
    with NEE, 2b on 61 blocks, the scan estimator on a tree-only pack)
    replays a graph bit-equal to ``render_radiance`` with the same
    generator, running the same kernels."""
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import (
        render_radiance,
        render_radiance_jit,
    )

    make, kw = GRAPH_RENDERS[role]
    g, m, e, c = make(cuda)
    kw = dict(kw, height=128, width=128, max_bounce=4)
    if kw.get("nee"):
        kw["lights"] = build_light_pack(g, m)
    gen = lambda s: torch.Generator(device=cuda).manual_seed(s)
    graphed = lambda s: render_radiance_jit(g, m, e, c, gen(s), **kw)
    eager = lambda s: render_radiance(g, m, e, c, gen(s), **kw)
    _hold_graph(graphed, eager, render_radiance_jit.graph)


@pytest.mark.parametrize("role", ["cornell_nee", "outdoor_1300"])
def test_render_replay_reads_new_input_values(cuda, role):
    """After the capture, a replay reads the caller's current values of
    every copied input: the camera, a material's colour, the emitters'
    power, the sun and the NEE lights, each changed alone and all together,
    render bit-equal to ``render_radiance`` on the new values with no new
    capture; the IBL, read in place, changed in place, too."""
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import (
        render_radiance,
        render_radiance_jit,
    )

    make, kw = GRAPH_RENDERS[role]
    g, m, e, c = make(cuda)
    kw = dict(kw, height=128, width=128, max_bounce=4)
    if kw.get("nee"):
        kw["lights"] = build_light_pack(g, m)
    gen = lambda: torch.Generator(device=cuda).manual_seed(4)
    graph = render_radiance_jit.graph
    before = render_radiance_jit(g, m, e, c, gen(), **kw)
    captures = graph.captures
    shift = lambda t, v: t + torch.tensor(v, dtype=t.dtype, device=cuda)
    m_color = m._replace(color=m.color * 0.8 + 0.1)
    m_power = m._replace(roughness=torch.where(m.mtype == 0, m.roughness * 1.25, m.roughness))
    e_sun = e._replace(sun_power=e.sun_power * 0.5 + 0.25,
                       sun_angles_deg=shift(e.sun_angles_deg, [3.0, -2.0, 1.0]))
    c_new = c._replace(position=shift(c.position, [0.05, -0.03, 0.02]),
                       rotation_deg=shift(c.rotation_deg, [1.0, -1.0, 0.5]))
    cases = [((g, m, e, c_new), kw), ((g, m_color, e, c), kw), ((g, m_power, e, c), kw),
             ((g, m, e_sun, c), kw)]
    kw_all = kw
    if kw.get("nee"):
        lp, d = kw["lights"], [0.01, 0.0, -0.01]
        kw_all = dict(kw, lights=lp._replace(v0=shift(lp.v0, d), v1=shift(lp.v1, d),
                                             v2=shift(lp.v2, d), power=lp.power * 1.5))
        cases.append(((g, m, e, c), kw_all))
    all_new = (g, m_color._replace(roughness=m_power.roughness), e_sun, c_new)
    cases.append((all_new, kw_all))
    for args, kw2 in cases:
        assert torch.equal(render_radiance_jit(*args, gen(), **kw2),
                           render_radiance(*args, gen(), **kw2))
    assert not torch.equal(render_radiance_jit(*all_new, gen(), **kw_all), before)
    e.ibl.mul_(0.75)
    img = render_radiance_jit(g, m, e, c, gen(), **kw)
    assert torch.equal(img, render_radiance(g, m, e, c, gen(), **kw))
    if role == "outdoor_1300":  # its camera sees the sky; Cornell's closed box does not
        assert not torch.equal(img, before)
    assert graph.captures == captures


def test_progressive_graph_resumed_equals_eager_fold(cuda, tmp_path):
    """The progressive chunk function replays one graph per renderer
    (bit-equal to its eager form on a new key too), and a render stopped
    after two chunks and resumed equals the float64 fold of eager
    ``render_radiance`` chunks bit for bit."""
    from ensem3a_openclraytracer_tpu_torch.models.optimize import iteration_generator
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance
    from ensem3a_openclraytracer_tpu_torch.models.progressive import ProgressiveRenderer

    g, m, e, c = tt.make_cornell_scene(device=cuda)
    kw = dict(height=64, width=64, max_bounce=3, chunk_spp=4, sun_enabled=False)
    gen = lambda s: iteration_generator(7, s, cuda)
    r = ProgressiveRenderer(g, m, e, c, base_seed=7, **kw)
    _hold_graph(lambda s: r._chunk_fn(gen(s)), lambda s: r._render.eager(g, m, e, c, gen(s)),
                r._render.graph)
    ckpt = str(tmp_path / "p.npz")
    ProgressiveRenderer(g, m, e, c, base_seed=7, **kw).render(8, checkpoint_path=ckpt)
    resumed = ProgressiveRenderer.resume(ckpt, g, m, e, c, **kw)
    resumed.render(16)
    assert resumed._render.graph.captures == 1
    acc = np.zeros((64, 64, 3))
    for i in range(4):
        chunk = render_radiance(g, m, e, c, gen(i), height=64, width=64, spp=4, max_bounce=3,
                                sun_enabled=False)
        acc = acc + chunk.cpu().numpy().astype(np.float64) * 4
    assert np.array_equal(resumed.state.accum, acc)


def test_trainer_graph_steps_equal_eager(cuda):
    """Three chained steps of the Cornell trainer (128^2, 8 spp) through the
    step's graph equal ``step.eager``'s bit for bit, and the step on its
    own replays bit-equal on a new key."""
    from ensem3a_openclraytracer_tpu_torch.models import optimize as opt

    g, m, e, c = tt.make_cornell_scene(device=cuda)
    init, step = opt.make_train_step(g, m, e, c, opt.Adam(5e-2), height=128, width=128, spp=8,
                                     max_bounce=4, sun_enabled=False)
    p, st = init()
    target = torch.zeros((128, 128, 3), device=cuda)
    gen = lambda s: torch.Generator(device=cuda).manual_seed(s)
    _hold_graph(lambda s: step(p, st, target, gen(s)), lambda s: step.eager(p, st, target, gen(s)),
                step.graph)
    runs = {}
    for label, fn in (("graph", step), ("eager", step.eager)):
        q, s_, out = p, st, []
        for i in range(3):
            q, s_, loss = fn(q, s_, target, opt.iteration_generator(5, i, cuda))
            out.append((q, s_, loss))
        runs[label] = out
    assert _same(runs["graph"], runs["eager"])
    assert step.graph.captures == 1


def test_texel_step_graph_equals_eager(cuda):
    """The texel step (outdoor, 64 cubes, a 4096x8192 sky, 128^2, 4 spp, sun):
    every trainable, the sky included, copied into the graph, the update
    bit-equal to the eager step's."""
    from ensem3a_openclraytracer_tpu_torch.models import optimize as opt
    from ensem3a_openclraytracer_tpu_torch.scene.materials import default_sky

    g, m, e, c = tt.make_outdoor_scene(n_cubes=64, device=cuda)
    e = e._replace(ibl=torch.as_tensor(default_sky(4096, 8192), device=cuda))
    init, step = opt.make_train_step(g, m, e, c, opt.Adam(5e-2), height=128, width=128, spp=4,
                                     max_bounce=4, sun_enabled=True)
    p, st = init()
    target = torch.zeros((128, 128, 3), device=cuda)
    gen = lambda s: torch.Generator(device=cuda).manual_seed(s)
    _hold_graph(lambda s: step(p, st, target, gen(s)), lambda s: step.eager(p, st, target, gen(s)),
                step.graph)


def test_capture_runs_under_sync_debug_error(cuda):
    """A host sync inside a captured function raises (every capture runs
    under ``set_sync_debug_mode("error")``), nothing is cached, and the mode
    is put back; a function that syncs nowhere captures."""
    from ensem3a_openclraytracer_tpu_torch.utils.graphs import Graphed

    x = torch.arange(8.0, device=cuda)
    bad = Graphed(lambda t: t * float(t.sum()))
    with pytest.raises(RuntimeError, match="synchroniz"):
        bad(x)
    assert bad.captures == 0 and torch.cuda.get_sync_debug_mode() == 0
    good = Graphed(lambda t: t * t.sum())
    good(x)
    assert torch.equal(good(x + 1), (x + 1) * (x + 1).sum()) and good.captures == 1
