"""Port parity, the renders of the fused engine that add the samples up
in their kernels: ``render_fused_plain`` (the plain version of
``csrc/fused_sample.cu``'s whole-render launch and of
``csrc/fused_queue.cu``'s launches into a running sum) against the JAX
package's fused sample summed over samples with its IBL lookup, the
engine's one-block and multi-block routes against the per-sample loop
they replaced, the escapes the multi-block render counts, and the
``fused=None`` engine rule.

The JAX kernel tests triangle sides with bf16 products and keeps 24 bits
of ``t``, so knife-edge rays fork: the bounds against JAX are the JAX
package's own (pixel forks below 2 %, median |diff| below 1e-5, as in
``tests/test_torch_fused.py``).  The port against itself runs the same
operations in the same order: rtol 1e-6, or bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu import testing as jt
from ensem3a_openclraytracer_tpu.ops.envmap import sample_ibl as j_sample_ibl
from ensem3a_openclraytracer_tpu.scene.scene import build_light_pack as j_light_pack
from ensem3a_openclraytracer_tpu_torch import convert
from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.models import pathtracer as tp
from ensem3a_openclraytracer_tpu_torch.ops import fused as tf
from ensem3a_openclraytracer_tpu_torch.ops import rng
from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays
from ensem3a_openclraytracer_tpu_torch.ops.closest_hit import resident, trace
from ensem3a_openclraytracer_tpu_torch.ops.envmap import sample_ibl
from ensem3a_openclraytracer_tpu_torch.ops.geometry import select
from ensem3a_openclraytracer_tpu_torch.scene.scene import build_light_pack
from test_torch_fused import MB, RES, _assert_forks, _jax_sample, _port_args

SPP = 2

CASES = {  # one-block scenes: Cornell (no sun, no IBL light), with NEE, outdoor (sun + IBL)
    "cornell": dict(make=lambda: jt.make_cornell_scene(use_bvh=False), sun=False),
    "cornell_nee": dict(make=lambda: jt.make_cornell_scene(use_bvh=False), sun=False, nee=True),
    "outdoor4_sun_ibl": dict(make=lambda: jt.make_outdoor_scene(n_cubes=4, use_bvh=False),
                             sun=True),
}


def _u(seed, n, n_u, spp=SPP):
    rng_ = np.random.default_rng(seed)
    return rng_.random(size=(spp, MB + 1, n, n_u), dtype=np.float64).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_render_fused_plain_matches_jax(name):
    """Two samples on explicit uniforms: the JAX fused sample (interpret
    mode) plus ``esc_thr * sample_ibl(esc_dir) * ibl_power``, summed over
    the samples, against ``render_fused_plain``."""
    case = CASES[name]
    jg, jm, je, jc = case["make"]()
    assert jg.feats.block_bounds.shape[0] == 1
    nee = case.get("nee", False)
    n = RES * RES
    u = _u(sorted(CASES).index(name) + 50, n, 5 if nee else 2)
    ref = np.zeros((n, 3), np.float32)
    for s in range(SPP):
        (rad, esc_thr, esc_dir), _, _ = _jax_sample(jg, jm, je, jc, u[s], sun=case["sun"], nee=nee)
        ref = ref + rad + esc_thr * np.asarray(j_sample_ibl(je.ibl, jnp.asarray(esc_dir))
                                               * je.ibl_power)
    g, m, e, c = convert.scene(jg, jm, je, jc, device="cpu")
    lights = convert.lights(j_light_pack(jg, jm), "cpu") if nee else None
    args, _, _ = _port_args(g, m, e, c)
    out = tf.render_fused_plain(*args, None, 0, SPP, ibl=e.ibl, ibl_power=e.ibl_power,
                                max_bounce=MB, sun_enabled=case["sun"],
                                uniforms=torch.as_tensor(u), nee=nee, lights=lights).numpy()
    assert out.shape == (n, 3) and out.mean() > 0.0
    _assert_forks(out, ref, name)


@pytest.mark.parametrize("name,bilinear", [("cornell", True), ("cornell_nee", True),
                                           ("outdoor4_sun_ibl", True),
                                           ("outdoor4_sun_ibl", False)])
def test_one_block_route_equals_per_sample_loop(name, bilinear):
    """``radiance_for_rays(fused=True)`` on a one-block scene runs the whole
    render through ``render_fused_*``: with ``engine="plain"`` it equals the
    per-sample loop it replaced (``sample_fused_plain`` per sample, the IBL
    and the sum outside) on the same Philox key, and the kernel route on the
    CPU (the same plain version) equals it bit for bit."""
    case = CASES[name]
    g, m, e, c = convert.scene(*case["make"](), device="cpu")
    nee = case.get("nee", False)
    lights = build_light_pack(g, m) if nee else None
    res = 16
    ray_o, ray_d = camera_rays(c.position, c.rotation_deg, c.fov_deg, res, res)
    kw = dict(spp=3, max_bounce=MB, sun_enabled=case["sun"], nee=nee, lights=lights, fused=True,
              ibl_bilinear=bilinear)
    calls = []
    real = tf.render_fused_plain
    try:
        tf.render_fused_plain = lambda *a, **k: calls.append(1) or real(*a, **k)
        out = tp.radiance_for_rays(g, m, e, ray_o, ray_d, torch.Generator().manual_seed(7),
                                   engine="plain", **kw)
        kernel_route = tp.radiance_for_rays(g, m, e, ray_o, ray_d,
                                            torch.Generator().manual_seed(7), **kw)
    finally:
        tf.render_fused_plain = real
    assert calls == [1, 1]  # one call per render, not one per sample

    key = rng.key_from_generator(torch.Generator().manual_seed(7), "cpu")
    h = trace(g, ray_o, ray_d)
    args, order = tf.fused_args(g, m, e, ray_o, ray_d, h, tp._gather_surface(g, m, ray_o, ray_d, h))
    assert order is None
    env = lambda d: sample_ibl(e.ibl, d, bilinear=bilinear) * e.ibl_power
    acc = torch.zeros_like(ray_d)
    for s in range(kw["spp"]):
        rad, esc_thr, esc_dir = tf.sample_fused_plain(*args, key, s, max_bounce=MB,
                                                      sun_enabled=case["sun"], nee=nee,
                                                      lights=lights)
        acc = acc + rad + esc_thr * env(esc_dir)
    miss = torch.where(h.hit[:, None], torch.zeros_like(ray_d), env(ray_d))
    want = acc / kw["spp"] + miss
    assert float(out.mean()) > 0.0
    torch.testing.assert_close(out, want, rtol=1e-6, atol=0.0)
    assert torch.equal(kernel_route, out)


def test_render_fused_plain_sample_range_draws_each_samples_stream():
    """Samples ``s0 .. s0 + ns - 1`` on the Philox key equal the same
    samples fed in as explicit uniforms ``[ns, mb + 1, N, n_u]`` from
    ``uniforms(key, ..., s)``, bit for bit, with NEE and with IBL."""
    for make, sun, nee in ((lambda: tt.make_cornell_scene(device="cpu"), False, True),
                           (lambda: tt.make_outdoor_scene(n_cubes=4, device="cpu"), True, False)):
        g, m, e, c = make()
        args, _, _ = _port_args(g, m, e, c)
        n, n_u = RES * RES, 5 if nee else 2
        key = torch.tensor([0x3456789, -0x1234567], dtype=torch.int32)
        kw = dict(ibl=e.ibl, ibl_power=e.ibl_power, max_bounce=MB, sun_enabled=sun, nee=nee,
                  lights=build_light_pack(g, m) if nee else None)
        own = tf.render_fused_plain(*args, key, 2, 3, **kw)
        u = torch.stack([rng.uniforms(key, (MB + 1, n, n_u), s) for s in (2, 3, 4)])
        fed = tf.render_fused_plain(*args, None, 0, 3, uniforms=u, **kw)
        assert torch.equal(own, fed) and float(own.mean()) > 0.0


def test_one_block_wrappers_on_cpu_and_their_refusals():
    """On the CPU ``render_fused_resident`` is ``render_fused_plain`` and
    launches nothing; both one-block wrappers refuse a multi-block scene, and
    the render wrapper refuses uniforms of the wrong shape and no samples."""
    g, m, e, c = tt.make_outdoor_scene(n_cubes=4, device="cpu")
    args, _, _ = _port_args(g, m, e, c)
    key = rng.key_from_generator(torch.Generator().manual_seed(1), "cpu")
    kw = dict(ibl=e.ibl, ibl_power=e.ibl_power, max_bounce=2, sun_enabled=True)
    before = dict(tf.LAUNCHES)
    out = tf.render_fused_resident(*args, key, 0, 2, **kw)
    assert tf.LAUNCHES == before
    assert torch.equal(out, tf.render_fused_plain(*args, key, 0, 2, **kw))
    with pytest.raises(ValueError, match="uniforms"):
        tf.render_fused_resident(*args, None, 0, 2, uniforms=torch.zeros(3, RES * RES, 2), **kw)
    with pytest.raises(ValueError, match="ns 0"):
        tf.render_fused_resident(*args, key, 0, 0, **kw)
    g2, m2, e2, c2 = tt.make_outdoor_scene(n_cubes=24, device="cpu")
    args2, _, _ = _port_args(g2, m2, e2, c2)
    with pytest.raises(ValueError, match="one triangle block"):
        tf.render_fused_resident(*args2, key, 0, 2, **kw)
    with pytest.raises(ValueError, match="one triangle block"):
        tf.sample_fused_blocks(*args2, key, 0, max_bounce=2, sun_enabled=True)


MULTI = {  # multi-block scenes: outdoor with sun and IBL, and with a light panel and NEE
    "outdoor24_sun_ibl": dict(make=lambda: tt.make_outdoor_scene(n_cubes=24, device="cpu")),
    "outdoor24_nee": dict(make=lambda: tt.make_outdoor_scene(n_cubes=24, emissive_panel=True,
                                                             device="cpu"), nee=True),
}


def test_render_fused_queue_on_cpu_is_plain():
    """On the CPU ``render_fused_queue`` is ``render_fused_plain`` on a
    two-block scene with sun and IBL: the same sum bit for bit, the same
    counts, and no launch."""
    g, m, e, c = MULTI["outdoor24_sun_ibl"]["make"]()
    assert g.feats.block_bounds.shape[0] >= 2 and not resident(g.feats)
    args, _, _ = _port_args(g, m, e, c, permute=True)
    key = rng.key_from_generator(torch.Generator().manual_seed(6), "cpu")
    kw = dict(ibl=e.ibl, ibl_power=e.ibl_power, max_bounce=MB, sun_enabled=True)
    stats, plain_stats = (torch.zeros(tf.queue_stats_len(MB), dtype=torch.int64) for _ in "ab")
    before = dict(tf.LAUNCHES)
    out = tf.render_fused_queue(*args, key, 1, 2, stats=stats, **kw)
    assert tf.LAUNCHES == before
    assert torch.equal(out, tf.render_fused_plain(*args, key, 1, 2, stats=plain_stats, **kw))
    assert torch.equal(stats, plain_stats) and float(out.mean()) > 0.0


@pytest.mark.parametrize("name,bilinear", [("outdoor24_sun_ibl", True),
                                           ("outdoor24_sun_ibl", False),
                                           ("outdoor24_nee", True)])
def test_multi_block_route_equals_per_sample_loop(name, bilinear):
    """``radiance_for_rays(fused=True)`` on a multi-block scene runs the
    whole render through one ``render_fused_*`` call: with
    ``engine="plain"`` it equals, bit for bit, the per-sample loop it
    replaced (``sample_fused_plain`` per sample on the Morton-ordered
    lanes, the IBL and the sum outside, the sums scattered back to pixel
    order), counts what that loop counts into ``render_stats``, and the
    kernel route on the CPU (the same plain version) equals it."""
    g, m, e, c = MULTI[name]["make"]()
    assert not resident(g.feats)
    nee = MULTI[name].get("nee", False)
    lights = build_light_pack(g, m) if nee else None
    res, spp = 16, 3
    ray_o, ray_d = camera_rays(c.position, c.rotation_deg, c.fov_deg, res, res)
    kw = dict(spp=spp, max_bounce=MB, sun_enabled=True, nee=nee, lights=lights, fused=True,
              ibl_bilinear=bilinear)
    calls = []
    real = tf.render_fused_plain
    try:
        tf.render_fused_plain = lambda *a, **k: calls.append(1) or real(*a, **k)
        out = tp.radiance_for_rays(g, m, e, ray_o, ray_d, torch.Generator().manual_seed(7),
                                   engine="plain", **kw)
        counted = tf.render_stats("cpu", MB).clone()
        kernel_route = tp.radiance_for_rays(g, m, e, ray_o, ray_d,
                                            torch.Generator().manual_seed(7), **kw)
    finally:
        tf.render_fused_plain = real
    assert calls == [1, 1]  # one call per render, not one per sample

    key = rng.key_from_generator(torch.Generator().manual_seed(7), "cpu")
    h = trace(g, ray_o, ray_d, "plain")
    args, order = tf.fused_args(g, m, e, ray_o, ray_d, h, tp._gather_surface(g, m, ray_o, ray_d, h))
    assert order is not None
    env = lambda d: sample_ibl(e.ibl, d, bilinear=bilinear) * e.ibl_power
    stats = torch.zeros(tf.queue_stats_len(MB), dtype=torch.int64)
    acc = torch.zeros_like(ray_d)
    for s in range(spp):
        rad, esc_thr, esc_dir = tf.sample_fused_plain(*args, key, s, max_bounce=MB,
                                                      sun_enabled=True, nee=nee, lights=lights,
                                                      stats=stats)
        acc = acc + rad + esc_thr * env(esc_dir)
    acc = torch.empty_like(acc).index_copy_(0, order, acc)
    want = acc / spp + select(h.hit, torch.zeros_like(ray_d), env(ray_d))
    assert float(out.mean()) > 0.0
    assert torch.equal(out, want)
    assert torch.equal(kernel_route, out)
    lookups = tf.QUEUE_STATS.index("escape_lookups")
    rest = [i for i in range(len(stats)) if i != lookups]  # the loop looked up no sky itself
    assert torch.equal(counted[rest], stats[rest]) and int(stats[lookups]) == 0
    assert int(counted[lookups]) > 0


def test_render_fused_plain_counts_escape_lookups():
    """``escape_lookups`` is one of 2b's fields, before the lanes of each
    bounce; ``render_fused_plain`` on a multi-block scene counts into it
    exactly the lanes that escaped in each sample (the lanes whose sky it
    looks up), a one-sample ``sample_fused_plain`` none, and a one-block
    render has no such slot."""
    fields = tf.queue_stats_fields(MB)
    assert "escape_lookups" in fields
    assert fields.index("escape_lookups") == len(tf.QUEUE_STATS) - 1
    assert fields[len(tf.QUEUE_STATS):] == tuple(f"lanes.{b}" for b in range(MB + 1))
    g, m, e, c = MULTI["outdoor24_sun_ibl"]["make"]()
    args, _, _ = _port_args(g, m, e, c, permute=True)
    key = rng.key_from_generator(torch.Generator().manual_seed(8), "cpu")
    kw = dict(max_bounce=MB, sun_enabled=True)
    lookups = fields.index("escape_lookups")
    escaped, total = [], 0
    for s in (2, 3, 4):
        one = torch.zeros(len(fields), dtype=torch.int64)
        rad, esc_thr, esc_dir = tf.sample_fused_plain(*args, key, s, stats=one, escaped=escaped,
                                                      **kw)
        esc = escaped[-1]
        assert esc.shape == (args[2].shape[0],) and esc.dtype == torch.bool
        # a lane that never escaped keeps the defaults, one that did its escape direction
        assert not bool(esc_thr[~esc].any()) and bool((esc_dir[~esc] == esc_dir.new_tensor(
            [0.0, 0.0, 1.0])).all())
        assert bool((esc_dir[esc].norm(dim=-1) - 1.0).abs().max() < 1e-4)
        assert int(one[lookups]) == 0
        total += int(esc.sum())
    stats = torch.zeros(len(fields), dtype=torch.int64)
    tf.render_fused_plain(*args, key, 2, 3, ibl=e.ibl, ibl_power=e.ibl_power, stats=stats, **kw)
    assert int(stats[lookups]) == total > 0
    g1, m1, e1, c1 = tt.make_outdoor_scene(n_cubes=4, device="cpu")
    args1, _, _ = _port_args(g1, m1, e1, c1)
    stats1 = torch.zeros(5, dtype=torch.int64)
    tf.render_fused_plain(*args1, key, 0, 2, ibl=e1.ibl, ibl_power=e1.ibl_power, stats=stats1,
                          **kw)
    assert torch.equal(stats1, torch.zeros(5, dtype=torch.int64))


SCENES = {  # blocks -> scene
    1: lambda: tt.make_outdoor_scene(n_cubes=4, device="cpu")[0],
    2: lambda: tt.make_outdoor_scene(n_cubes=24, device="cpu")[0],
    61: lambda: tt.make_outdoor_scene(n_cubes=1300, device="cpu")[0],
}


@pytest.mark.parametrize("blocks", sorted(SCENES))
def test_engine_rule_takes_fused_at_any_block_count(blocks):
    """``fused=None`` on the card is the fused engine for 1, 2 and 61
    triangle blocks (no TPU cutover at 48); on the CPU the scan estimator."""
    g = SCENES[blocks]()
    assert g.feats.block_bounds.shape[0] == blocks
    assert tp.fused_by_default(g, "cuda")
    assert tp.fused_by_default(g, torch.device("cuda", 0))
    assert not tp.fused_by_default(g, "cpu")


@pytest.mark.parametrize("refusal", ["mis", "refract_glass", "explicit_uniforms", "gradient",
                                     "no_features"])
def test_engine_rule_keeps_its_refusals(refusal):
    g = SCENES[61]()
    kw = {"mis": dict(mis=True), "refract_glass": dict(glass_mode="refract"),
          "explicit_uniforms": dict(uniforms=torch.zeros(1, 5, 4, 2)),
          "gradient": dict(needs_grad=True), "no_features": {}}[refusal]
    if refusal == "no_features":
        g = g._replace(feats=None)
    assert not tp.fused_by_default(g, "cuda", **kw)
