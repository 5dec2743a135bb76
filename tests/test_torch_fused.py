"""Port parity, fused sample engine: ``sample_fused_plain`` against the JAX
package's ``sample_fused`` (run as ``tests/test_fused.py`` runs it: in
interpret mode with an explicit uniform stream), and the port's fused
path against its own scan path on the same stream.

The JAX kernel tests triangle sides with bf16 products and keeps 24 bits
of ``t``, so knife-edge rays fork: the bounds are the JAX package's own,
pixel forks (max-channel |diff| > 1e-3) below 2 % and median |diff|
below 1e-5, not p98 or equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu import testing as jt
from ensem3a_openclraytracer_tpu.models import pathtracer as jp
from ensem3a_openclraytracer_tpu.ops import fused as jf
from ensem3a_openclraytracer_tpu.ops.camera import camera_rays as j_camera_rays
from ensem3a_openclraytracer_tpu.ops.envmap import sample_ibl as j_sample_ibl
from ensem3a_openclraytracer_tpu.ops.envmap import sun_direction as j_sun_direction
from ensem3a_openclraytracer_tpu.scene.scene import build_light_pack as j_light_pack
from ensem3a_openclraytracer_tpu_torch import convert
from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.models import pathtracer as tp
from ensem3a_openclraytracer_tpu_torch.ops import fused as tf
from ensem3a_openclraytracer_tpu_torch.ops import rng
from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays
from ensem3a_openclraytracer_tpu_torch.ops.closest_hit import resident, trace
from ensem3a_openclraytracer_tpu_torch.ops.pairs import trace_pairs_plain as pairs_plain
from ensem3a_openclraytracer_tpu_torch.ops.envmap import sample_ibl
from ensem3a_openclraytracer_tpu_torch.scene.scene import build_light_pack

RES, MB = 24, 3

CASES = {
    "cornell": dict(make=lambda: jt.make_cornell_scene(use_bvh=False), sun=False, blocks=1),
    "outdoor4_sun": dict(make=lambda: jt.make_outdoor_scene(n_cubes=4, use_bvh=False), sun=True,
                         blocks=1),
    "outdoor24_multiblock": dict(make=lambda: jt.make_outdoor_scene(n_cubes=24, use_bvh=False),
                                 sun=True, blocks=2),
    "cornell_nee": dict(make=lambda: jt.make_cornell_scene(use_bvh=False), sun=False, blocks=1,
                        nee=True),
    "outdoor24_multiblock_nee": dict(
        make=lambda: jt.make_outdoor_scene(n_cubes=24, use_bvh=False, emissive_panel=True),
        sun=True, blocks=2, nee=True),
}


def _uniforms(seed, n, n_u):
    rng_ = np.random.default_rng(seed)
    return rng_.random(size=(MB + 1, n, n_u), dtype=np.float64).astype(np.float32)


def _jax_sample(jg, jm, je, jc, u, *, sun, nee=False, record=False):
    """The JAX kernel's raw outputs for one sample, and its primary hits."""
    ray_o, ray_d = j_camera_rays(jc.position, jc.rotation_deg, jc.fov_deg, RES, RES)
    h = jp.trace(jg, ray_o, ray_d)
    s = jp._gather_surface(jg, jm, ray_o, ray_d, h)
    attrs = jf.build_tri_attrs(jg.n, jg.mat, jm.mtype, jm.color, jm.roughness,
                               jg.feats.edges.shape[-1])
    out = jf.sample_fused(
        jg.feats, attrs, s.p, s.n, s.mtype, s.color, s.rough, h.hit, ray_d,
        j_sun_direction(je.sun_angles_deg), je.sun_power, jax.random.PRNGKey(0),
        max_bounce=MB, sun_enabled=sun, interpret=True, uniforms=jnp.asarray(u), nee=nee,
        lights=j_light_pack(jg, jm) if nee else None, record=record)
    return [np.asarray(x) for x in out], ray_d, h


def _port_args(g, m, e, c, res=RES, permute=False):
    """The engine's per-sample arguments (``fused_args``) for the camera's
    rays; unpermuted by default, so lanes line up with the JAX kernel's."""
    ray_o, ray_d = camera_rays(c.position, c.rotation_deg, c.fov_deg, res, res)
    h = trace(g, ray_o, ray_d)
    s = tp._gather_surface(g, m, ray_o, ray_d, h)
    args, _ = tf.fused_args(g, m, e, ray_o, ray_d, h, s, permute=permute)
    return args, ray_d, h


def _port_sample(g, m, e, c, u, *, sun, nee=False, record=False, lights=None):
    args, ray_d, h = _port_args(g, m, e, c)
    out = tf.sample_fused(*args, max_bounce=MB, sun_enabled=sun, uniforms=torch.as_tensor(u),
                          nee=nee, lights=lights, record=record)
    return [x.numpy() for x in out], ray_d, h


def _radiance(out, ibl_fn, ray_d, hit):
    rad, esc_thr, esc_dir = out[:3]
    miss = np.where(np.asarray(hit)[:, None], 0.0, np.asarray(ibl_fn(ray_d)))
    return rad + esc_thr * np.asarray(ibl_fn(esc_dir)) + miss


def _assert_forks(a, b, name):
    diff = np.abs(a - b).max(axis=-1)
    frac = float((diff > 1e-3).mean())
    assert np.isfinite(a).all() and np.isfinite(b).all(), name
    assert frac < 0.02, f"{name}: pixel forks {frac:.4f}, max diff {diff.max()}"
    assert np.median(diff) < 1e-5, f"{name}: median diff {np.median(diff)}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_sample_fused_plain_matches_jax(name):
    case = CASES[name]
    jg, jm, je, jc = case["make"]()
    nee = case.get("nee", False)
    assert jg.feats.block_bounds.shape[0] == case["blocks"]
    u = _uniforms(sorted(CASES).index(name), RES * RES, 5 if nee else 2)
    ref, jd, jh = _jax_sample(jg, jm, je, jc, u, sun=case["sun"], nee=nee)
    g, m, e, c = convert.scene(jg, jm, je, jc, device="cpu")
    lights = convert.lights(j_light_pack(jg, jm), "cpu") if nee else None
    out, d, h = _port_sample(g, m, e, c, u, sun=case["sun"], nee=nee, lights=lights)
    ibl_j = lambda x: j_sample_ibl(je.ibl, jnp.asarray(x)) * je.ibl_power
    ibl_t = lambda x: sample_ibl(e.ibl, torch.as_tensor(x)) * e.ibl_power
    img_j = _radiance(ref, ibl_j, jd, jh.hit)
    img_t = _radiance(out, ibl_t, d, h.hit)
    assert img_t.mean() > 0.0
    _assert_forks(img_t, img_j, name)


@pytest.mark.parametrize("n_cubes,blocks", [(4, 1), (24, 2)])
def test_record_mode_matches_jax(n_cubes, blocks):
    jg, jm, je, jc = jt.make_outdoor_scene(n_cubes=n_cubes, use_bvh=False)
    assert jg.feats.block_bounds.shape[0] == blocks
    u = _uniforms(21, RES * RES, 2)
    ref, _, _ = _jax_sample(jg, jm, je, jc, u, sun=True, record=True)
    g, m, e, c = convert.scene(jg, jm, je, jc, device="cpu")
    out, _, _ = _port_sample(g, m, e, c, u, sun=True, record=True)
    np.testing.assert_array_equal(out[3], ref[3])  # u
    for k, what in ((4, "tri"), (5, "sun_tri")):
        agree = float((out[k] == ref[k]).mean())
        assert agree >= 0.995, f"{what} agrees on {agree:.4f}"
        assert (out[k] >= -1).all() and (out[k] != -1).any()
    _assert_forks(out[0], ref[0], "record rad")


@pytest.mark.parametrize("name", ["cornell", "outdoor24_multiblock", "cornell_nee"])
def test_fused_path_matches_scan_path(name):
    """``sample_fused_plain`` plus the IBL outside against the port's
    ``radiance_for_rays(fused=False)``, one sample on one stream."""
    case = CASES[name]
    g, m, e, c = convert.scene(*case["make"](), device="cpu")
    nee = case.get("nee", False)
    n = RES * RES
    u = _uniforms(31, n, 5 if nee else 2)
    lights = build_light_pack(g, m) if nee else None
    ray_o, ray_d = camera_rays(c.position, c.rotation_deg, c.fov_deg, RES, RES)
    ut = torch.as_tensor(u)
    scan = tp.radiance_for_rays(
        g, m, e, ray_o, ray_d, spp=1, max_bounce=MB, sun_enabled=case["sun"], fused=False,
        uniforms=ut[None, :, :, :2], light_uniforms=ut[None, :, :, 2:] if nee else None,
        nee=nee, lights=lights).numpy()
    out, d, h = _port_sample(g, m, e, c, u, sun=case["sun"], nee=nee, lights=lights)
    fused = _radiance(out, lambda x: sample_ibl(e.ibl, torch.as_tensor(x)) * e.ibl_power, d,
                      h.hit)
    _assert_forks(fused, scan, name)


@pytest.mark.parametrize("nee", [False, True])
def test_plain_traces_are_exact_and_counted(nee):
    """On a multi-block scene the plain version traces each of the kernel's
    trace loops (bounce + NEE, then sun) with ``trace_pairs_plain`` on the
    rays the kernel traces: every trace equals ``trace_plain`` bit for bit,
    and its counts add up to what ``stats`` receives."""
    g, m, e, c = tt.make_outdoor_scene(n_cubes=24, emissive_panel=nee, device="cpu")
    assert g.feats.block_bounds.shape[0] == 2
    args, _, _ = _port_args(g, m, e, c, permute=True)
    n = RES * RES
    kw = dict(max_bounce=MB, sun_enabled=True, nee=nee,
              lights=build_light_pack(g, m) if nee else None,
              uniforms=torch.as_tensor(_uniforms(41, n, 5 if nee else 2)))
    traces, stats = [], torch.zeros(tf.queue_stats_len(MB), dtype=torch.int64)
    out = tf.sample_fused_plain(*args, stats=stats, traces=traces, **kw)
    assert len(traces) == 2 * (MB + 1)  # bounce (+ NEE) and sun per bounce
    total = torch.zeros(4, dtype=torch.int64)
    for o, d, h in traces:
        ref = trace(g, o, d)
        assert torch.equal(h.t, ref.t) and torch.equal(h.tri, ref.tri) and torch.equal(h.hit, ref.hit)
        pairs_plain(g.feats, o, d, stats=total)
    assert traces[0][0].shape[0] > n if nee else traces[0][0].shape[0] <= n
    assert torch.equal(stats[:4], total) and int(stats[4]) == 0  # no grid syncs in plain
    named = dict(zip(tf.queue_stats_fields(MB), stats.tolist()))
    assert all(named[f] == 0 for f in tf.QUEUE_STATS if f.endswith("cycles"))  # nor cycles
    assert bool((stats[:4] > 0).all()) and int(stats[2]) >= 1
    again = tf.sample_fused_plain(*args, **kw)  # counting changes nothing
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_sample_fused_dispatch_by_block_count():
    """``sample_fused`` sends one-block scenes (``resident``) to the
    resident kernel's wrapper and scenes of more blocks to the queue
    kernel's; on the CPU each wrapper takes the plain version."""
    calls = []
    real = {name: getattr(tf, name) for name in ("sample_fused_queue", "sample_fused_blocks")}
    for name, fn in real.items():
        setattr(tf, name, lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    try:
        for n_cubes, want in ((4, "sample_fused_blocks"), (24, "sample_fused_queue")):
            g, m, e, c = tt.make_outdoor_scene(n_cubes=n_cubes, device="cpu")
            assert resident(g.feats) == (want == "sample_fused_blocks")
            args, _, _ = _port_args(g, m, e, c)
            key = rng.key_from_generator(torch.Generator().manual_seed(3), "cpu")
            before = dict(tf.LAUNCHES)
            out = tf.sample_fused(*args, key, 0, max_bounce=1, sun_enabled=True)
            assert calls[-1] == want and tf.LAUNCHES == before
            ref = tf.sample_fused_plain(*args, key, 0, max_bounce=1, sun_enabled=True)
            assert all(torch.equal(a, b) for a, b in zip(out, ref))
    finally:
        for name, fn in real.items():
            setattr(tf, name, fn)
    assert calls == ["sample_fused_blocks", "sample_fused_queue"]


def test_fused_dispatch_on_cpu():
    """``fused=None`` stays on the scan path on the CPU; ``fused=True``
    runs the plain fused version there; bad combinations raise."""
    g, m, e, c = tt.make_cornell_scene(device="cpu")
    ray_o, ray_d = camera_rays(c.position, c.rotation_deg, c.fov_deg, 8, 8)
    kw = dict(spp=2, max_bounce=2, sun_enabled=False)

    def run(fused, seed=5, **extra):
        gen = torch.Generator().manual_seed(seed)
        return tp.radiance_for_rays(g, m, e, ray_o, ray_d, gen, fused=fused, **kw, **extra)

    calls = []
    real = tf.sample_fused_plain
    try:
        tf.sample_fused_plain = lambda *a, **k: calls.append(1) or real(*a, **k)
        auto, scan = run(None), run(False)
        assert not calls and torch.equal(auto, scan)
        fused = run(True)
        assert len(calls) == kw["spp"]
    finally:
        tf.sample_fused_plain = real
    assert fused.shape == (64, 3) and torch.isfinite(fused).all() and float(fused.mean()) > 0
    # one stream: the scan path draws the same Philox uniforms for a 1-block scene
    assert float(((fused - scan).abs().amax(-1) > 1e-3).float().mean()) < 0.05
    lights = build_light_pack(g, m)
    u = torch.zeros((1, 3, 64, 2))
    for bad in (dict(geom=g._replace(feats=None)), dict(mis=True, nee=True, lights=lights),
                dict(uniforms=u), dict(glass_mode="refract")):
        geom = bad.pop("geom", g)
        with pytest.raises(ValueError):
            tp.radiance_for_rays(geom, m, e, ray_o, ray_d, fused=True, spp=1, max_bounce=2,
                                 sun_enabled=False, **bad)
    args, _, _ = _port_args(g, m, e, c)
    with pytest.raises(ValueError, match="BSDF-only"):
        tf.sample_fused(*args, rng.key_from_generator(torch.Generator(), "cpu"), max_bounce=1,
                        sun_enabled=False, nee=True, lights=lights, record=True)


def test_multiblock_engine_keeps_each_pixel_its_own():
    """On a multi-block scene the engine hands ``sample_fused`` its rays in
    Morton order and scatters the sums back: with a stand-in sample that
    returns a fingerprint of each lane's arguments, every pixel gets the
    fingerprint of its own primary hit (and its own IBL on a miss)."""
    g, m, e, c = tt.make_outdoor_scene(n_cubes=24, device="cpu")
    assert g.feats.block_bounds.shape[0] == 2
    res = 16

    def fingerprint(p, n, mtype, color, rough, live, in_dir):
        f = p + 2.0 * n + 3.0 * in_dir + 5.0 * color + (7.0 * rough + 11.0 * mtype)[:, None]
        return torch.where(live[:, None], f, torch.zeros_like(f))

    seen = []

    def fake(feats, attrs, p, n, mtype, color, rough, live, in_dir, sun_dir, sun_power, key,
             sample, **kw):
        seen.append((p, sample))
        return fingerprint(p, n, mtype, color, rough, live, in_dir), torch.zeros_like(p), \
            torch.zeros_like(p) + p.new_tensor([0.0, 0.0, 1.0])

    ray_o, ray_d = camera_rays(c.position, c.rotation_deg, c.fov_deg, res, res)
    real = tf.sample_fused_plain
    try:
        tf.sample_fused_plain = fake
        out = tp.radiance_for_rays(g, m, e, ray_o, ray_d, torch.Generator().manual_seed(2),
                                   fused=True, spp=2, max_bounce=2, sun_enabled=True)
    finally:
        tf.sample_fused_plain = real
    args, _, h = _port_args(g, m, e, c, res=res)
    assert [s for _, s in seen] == [0, 1]
    assert not torch.equal(seen[0][0], args[2])  # the lanes were permuted
    want = fingerprint(*args[2:9])
    miss = sample_ibl(e.ibl, ray_d) * e.ibl_power
    want = torch.where(h.hit[:, None], want, miss)
    assert h.hit.any() and (~h.hit).any()
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)


def test_in_kernel_stream_equals_explicit_uniforms():
    """With ``uniforms=None`` the engine draws ``uniforms(key, (mb+1, N,
    n_u), sample)``: fed in explicitly, the same stream gives the same
    sample bit for bit."""
    g, m, e, c = tt.make_outdoor_scene(n_cubes=4, device="cpu")
    args, _, _ = _port_args(g, m, e, c)
    key = torch.tensor([0x1234567, -0x2345678], dtype=torch.int32)
    for sample in (0, 3):
        a = tf.sample_fused(*args, key, sample, max_bounce=MB, sun_enabled=True)
        u = rng.uniforms(key, (MB + 1, RES * RES, 2), sample)
        b = tf.sample_fused(*args, max_bounce=MB, sun_enabled=True, uniforms=u)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_attrs_and_morton_order():
    jg, jm, _, _ = jt.make_outdoor_scene(n_cubes=24, use_bvh=False)
    g, m = convert.geometry(jg, "cpu"), convert.materials(jm, "cpu")
    tpad = g.feats.edges.shape[-1]
    ref = np.asarray(jf.build_tri_attrs(jg.n, jg.mat, jm.mtype, jm.color, jm.roughness, tpad))
    np.testing.assert_array_equal(tf.build_tri_attrs(g.n, g.mat, m.mtype, m.color, m.roughness,
                                                     tpad).numpy(), ref.T)
    pts = np.random.default_rng(4).normal(size=(999, 3)).astype(np.float32)
    np.testing.assert_array_equal(tf.morton_order_points(torch.as_tensor(pts)).numpy(),
                                  np.asarray(jf.morton_order_points(jnp.asarray(pts))))
