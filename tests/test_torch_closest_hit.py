"""Port parity, closest hit: the port's exact scan (the CUDA kernel's plain
version) against the JAX package's ``trace_mxu`` scan, the ray order
against ``coherent_order``, the block and sub-tile boxes of the features,
and ``resident``, the one rule that picks the kernel family of every trace
and fused sample.

Triangles sharing an edge tie under the inclusive side tests, and the two
scans round their dot products in different orders, so a knife-edge ray
may pick a neighbouring triangle: the bound is on the fork fraction
(``tri`` agrees on >= 99.5 % of rays), with ``|dt| <= 1e-4 max(1, t)``
where it agrees."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu import testing as jt
from ensem3a_openclraytracer_tpu.ops.fused import _expand_bits_10_jnp
from ensem3a_openclraytracer_tpu.ops.fused import coherent_order as j_coherent_order
from ensem3a_openclraytracer_tpu.ops.intersect import trace_bruteforce as j_bruteforce
from ensem3a_openclraytracer_tpu.ops.intersect_mxu import trace_mxu
from ensem3a_openclraytracer_tpu_torch import convert
from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.models.pathtracer import _gather_surface
from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
from ensem3a_openclraytracer_tpu_torch.ops import fused as fu
from ensem3a_openclraytracer_tpu_torch.ops import pairs as pp
from ensem3a_openclraytracer_tpu_torch.ops import rng
from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays
from ensem3a_openclraytracer_tpu_torch.ops.intersect import trace_bruteforce

SCENES = {
    "cornell": lambda: jt.make_cornell_scene(use_bvh=False),
    "outdoor16": lambda: jt.make_outdoor_scene(n_cubes=16, use_bvh=False),
    "outdoor1300": lambda: jt.make_outdoor_scene(n_cubes=1300, use_bvh=False),
}
N_RAYS = 4096


def _rays(geom, cam, seed):
    """1024 camera rays plus random rays from points inside the scene's
    bounds, in random directions (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    o_c, d_c = camera_rays(cam.position, cam.rotation_deg, cam.fov_deg, 32, 32)
    v = geom.v0.numpy()
    lo, hi = v.min(0), v.max(0)
    hi = np.maximum(hi, lo + 1.0)
    n = N_RAYS - o_c.shape[0]
    o = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (np.concatenate([o_c.numpy(), o]).astype(np.float32),
            np.concatenate([d_c.numpy(), d]).astype(np.float32))


def _assert_agree(h, t_ref, tri_ref, hit_ref, min_frac=0.995):
    t, tri, hit = h.t.numpy(), h.tri.numpy(), h.hit.numpy()
    hit_ref = np.asarray(hit_ref)
    same = tri == np.asarray(tri_ref)
    assert same.mean() >= min_frac, f"tri agrees on {same.mean():.5f}"
    assert (hit == hit_ref).mean() >= min_frac, f"hit agrees on {(hit == hit_ref).mean():.5f}"
    t_ref = np.asarray(t_ref)
    err = np.abs(t - t_ref)[same]
    assert np.all(err <= 1e-4 * np.maximum(1.0, t_ref[same])), err.max()
    assert hit.mean() > 0.3


@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_plain_matches_trace_mxu(name):
    jg, _, _, jc = SCENES[name]()
    g, c = convert.geometry(jg, "cpu"), convert.camera(jc, "cpu")
    o, d = _rays(g, c, seed=len(name))
    h = ch.trace_plain(g.feats, torch.as_tensor(o), torch.as_tensor(d))
    jh = trace_mxu(jg.feats, jnp.asarray(o), jnp.asarray(d))
    _assert_agree(h, jh.t, jh.tri, jh.hit)
    # the dispatch and the kernel wrapper take the plain version on the CPU;
    # the resident kernel's wrapper refuses more than one block
    h2 = ch.trace(g, torch.as_tensor(o), torch.as_tensor(d))
    assert torch.equal(h2.t, h.t) and torch.equal(h2.tri, h.tri)
    launches = ch.LAUNCHES["closest_hit"]
    if ch.resident(g.feats):
        t3, tri3 = ch.trace_resident(g.feats, torch.as_tensor(o), torch.as_tensor(d))
        assert torch.equal(t3, h.t) and tri3.dtype == torch.int32
    else:
        with pytest.raises(ValueError, match="one triangle block"):
            ch.trace_resident(g.feats, torch.as_tensor(o), torch.as_tensor(d))
    assert ch.LAUNCHES["closest_hit"] == launches


def test_trace_bruteforce_matches_jax():
    jg, _, _, jc = SCENES["outdoor16"]()
    g, c = convert.geometry(jg, "cpu"), convert.camera(jc, "cpu")
    o, d = _rays(g, c, seed=3)
    h = trace_bruteforce(g.v0, g.v1, g.v2, torch.as_tensor(o), torch.as_tensor(d))
    jh = j_bruteforce(jg.v0, jg.v1, jg.v2, jnp.asarray(o), jnp.asarray(d))
    _assert_agree(h, jh.t, jh.tri, jh.hit)


def test_tile_size_does_not_change_hits():
    g = convert.geometry(SCENES["outdoor16"]()[0], "cpu")
    rng = np.random.default_rng(9)
    o = torch.as_tensor(rng.normal(size=(512, 3)).astype(np.float32) * 3 + [0, 8, 1])
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(512, 3)).astype(np.float32)), dim=-1)
    a = ch.trace_plain(g.feats, o, d, tri_tile=8)
    b = ch.trace_plain(g.feats, o, d)
    assert torch.equal(a.t, b.t) and torch.equal(a.tri, b.tri)


@pytest.mark.parametrize("seed", [0, 1])
def test_coherent_order(seed):
    rng = np.random.default_rng(seed)
    p = (rng.normal(size=(5000, 3)) * [10, 3, 1]).astype(np.float32)
    d = rng.normal(size=(5000, 3)).astype(np.float32)
    order = ch.coherent_order(torch.as_tensor(p), torch.as_tensor(d)).numpy()
    assert np.array_equal(np.sort(order), np.arange(5000))
    keys = ch.coherent_keys(torch.as_tensor(p), torch.as_tensor(d)).numpy()
    # the JAX package's key, built as its coherent_order builds it
    jp, jd = jnp.asarray(p), jnp.asarray(d)
    lo, hi = jnp.min(jp, axis=0), jnp.max(jp, axis=0)
    q = jnp.clip((jp - lo) / jnp.maximum(hi - lo, 1e-12), 0.0, 0.9999999)
    g = (q * 512.0).astype(jnp.uint32)
    code = ((_expand_bits_10_jnp(g[:, 0]) << 2) | (_expand_bits_10_jnp(g[:, 1]) << 1)
            | _expand_bits_10_jnp(g[:, 2]))
    octant = (((jd[:, 0] >= 0).astype(jnp.uint32) << 2) | ((jd[:, 1] >= 0).astype(jnp.uint32) << 1)
              | (jd[:, 2] >= 0).astype(jnp.uint32))
    jkeys = np.asarray((octant << jnp.uint32(27)) | code).astype(np.int64)
    np.testing.assert_array_equal(keys, jkeys)
    jorder = np.asarray(j_coherent_order(jp, jd))
    np.testing.assert_array_equal(keys[order], keys[jorder])
    assert np.all(np.diff(keys[order]) >= 0)


def test_features_of_empty_and_padded_blocks():
    f = ch.build_tri_features(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)), "cpu")
    assert f.block_bounds.shape == (0, 8) and f.num_tris == 0
    h = ch.trace_plain(f, torch.zeros(4, 3), torch.tensor([[0.0, 0.0, 1.0]] * 4))
    assert not h.hit.any() and torch.all(h.t == ch.MAX_DIST) and torch.all(h.tri == 0)
    # 257 triangles pad to two full blocks; padding rows are zero (never hit)
    rng = np.random.default_rng(0)
    v = [rng.normal(size=(257, 3)).astype(np.float32) for _ in range(3)]
    f = ch.build_tri_features(*v, "cpu")
    assert f.edges.shape == (3, 6, 512) and f.block_bounds.shape == (2, 8)
    assert torch.all(f.edges[..., 257:] == 0) and torch.all(f.normal_d[:, 257:] == 0)
    o = torch.as_tensor(rng.normal(size=(256, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(256, 3)).astype(np.float32)), dim=-1)
    h = ch.trace_plain(f, o, d)
    assert h.hit.any() and int(h.tri.max()) < 257


BOX_SCENES = {  # scene -> geometry: 1, 2 (a padded last block) and 61 blocks; a converted pack
    "cornell": lambda: tt.make_cornell_scene(device="cpu")[0],
    "random257": lambda: None,
    "outdoor1300": lambda: tt.make_outdoor_scene(n_cubes=1300, device="cpu")[0],
    "outdoor16_converted": lambda: convert.geometry(SCENES["outdoor16"]()[0], "cpu"),
}


@pytest.mark.parametrize("name", sorted(BOX_SCENES))
def test_block_and_sub_tile_boxes_hold_their_triangles(name):
    """``block_bounds`` and ``sub_bounds``: each box is the least and most
    of its run's vertices (``TRI_TILE`` and ``SUB_TILE`` triangles), a run
    of padding alone an inverted box, each with the scene's margin in
    column 6; a block's sub-tile boxes lie inside its box."""
    g = BOX_SCENES[name]()
    if g is None:
        rng = np.random.default_rng(4)
        v = [rng.normal(size=(257, 3)).astype(np.float32) for _ in range(3)]
        f = ch.build_tri_features(*v, "cpu")
    else:
        f = g.feats
        v = [x.numpy() for x in (g.v0, g.v1, g.v2)]
    allv = np.stack(v)  # [3, T, 3]
    t, nb = allv.shape[1], f.block_bounds.shape[0]
    subs = ch.TRI_TILE // ch.SUB_TILE
    assert f.sub_bounds.shape == (nb * subs, 8) and f.sub_bounds.dtype == torch.float32
    for boxes, width in ((f.block_bounds.numpy(), ch.TRI_TILE), (f.sub_bounds.numpy(), ch.SUB_TILE)):
        for j, box in enumerate(boxes):
            run = allv[:, j * width:min((j + 1) * width, t)].reshape(-1, 3)
            if run.size:
                assert np.array_equal(box[:3], run.min(0)) and np.array_equal(box[3:6], run.max(0))
            else:  # padding alone: inverted, never entered
                assert np.all(box[:3] == np.inf) and np.all(box[3:6] == -np.inf)
        assert np.all(boxes[:, 6] == f.block_bounds.numpy()[0, 6]) and boxes[0, 6] > 0
    sub = f.sub_bounds.numpy().reshape(nb, subs, 8)
    real = sub[..., 0] <= sub[..., 3]
    blk = f.block_bounds.numpy()[:, None]
    assert np.all(~real | ((sub[..., :3] >= blk[..., :3]) & (sub[..., 3:6] <= blk[..., 3:6])).all(-1))
    assert int(real.sum()) == -(-t // ch.SUB_TILE)
    # a ray's entry into a sub-tile is never nearer than into its block
    rng = np.random.default_rng(5)
    lo, hi = allv.reshape(-1, 3).min(0), allv.reshape(-1, 3).max(0)
    o = torch.as_tensor((lo + (hi - lo) * rng.random((512, 3))).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(rng.normal(size=(512, 3)).astype(np.float32)),
                                      dim=-1)
    block = ch.block_entries(f.block_bounds, o, d)
    inner = ch.block_entries(f.sub_bounds.view(nb, subs, 8), o[:, None], d[:, None])
    assert bool((inner >= block[..., None]).all())


RULE_SCENES = {  # scene -> (maker, triangle blocks)
    "cornell": (lambda: tt.make_cornell_scene(device="cpu"), 1),
    "outdoor24": (lambda: tt.make_outdoor_scene(n_cubes=24, device="cpu"), 2),
    "outdoor1300": (lambda: tt.make_outdoor_scene(n_cubes=1300, device="cpu"), 61),
}


@pytest.mark.parametrize("name", sorted(RULE_SCENES))
def test_resident_is_the_one_rule(name, monkeypatch):
    """``resident`` holds every choice of kernel family to one answer: on
    one block ``trace`` takes the resident kernel's plain version (what
    ``trace_resident`` returns), ``fused_args`` keeps the rays' order and
    the one-block wrappers run; on more blocks ``trace`` takes the block
    queues' plain version, ``fused_args`` permutes and each one-block
    wrapper refuses.  (``sample_fused``'s choice: ``test_torch_fused``.)"""
    make, blocks = RULE_SCENES[name]
    g, m, e, c = make()
    assert g.feats.block_bounds.shape[0] == blocks
    one = ch.resident(g.feats)
    assert one == (blocks == 1)
    o, d = camera_rays(c.position, c.rotation_deg, c.fov_deg, 8, 8)
    calls = []
    for mod, fn in ((ch, "trace_plain"), (pp, "trace_pairs_plain")):
        monkeypatch.setattr(mod, fn, lambda *a, _n=fn, _f=getattr(mod, fn), **k:
                            calls.append(_n) or _f(*a, **k))
    h = ch.trace(g, o, d)
    assert calls == ["trace_plain" if one else "trace_pairs_plain"]
    monkeypatch.undo()

    args, order = fu.fused_args(g, m, e, o, d, h, _gather_surface(g, m, o, d, h))
    assert (order is None) == one
    key = rng.key_from_generator(torch.Generator().manual_seed(2), "cpu")
    kw = dict(max_bounce=1, sun_enabled=False)
    guards = (
        lambda: ch.trace_resident(g.feats, o, d),
        lambda: fu.sample_fused_blocks(*args, key, 0, **kw),
        lambda: fu.render_fused_resident(*args, key, 0, 1, ibl=e.ibl, ibl_power=e.ibl_power,
                                         **kw),
    )
    if one:
        t, tri = guards[0]()
        assert torch.equal(t, h.t) and torch.equal(tri.long(), h.tri)
        for guard in guards[1:]:
            guard()  # the plain version, on the CPU
    else:
        for guard in guards:
            with pytest.raises(ValueError, match="one triangle block"):
                guard()
