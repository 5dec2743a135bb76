"""Parity of the port's acceleration-structure layer with the JAX package's:
the host LBVH build (``accel/lbvh.py``), the device build
(``accel/lbvh_device.py``), the validator, the tree walk
(``ops/traversal.trace_bvh_plain``) and tree-only renders and gradients.

The same numpy inputs (made from a seed) go through both packages.
Bounds: trees equal array for array.  Traversal: ``hit`` equal, ``tri``
equal on >= 99.9 % of rays, ``|dt| <= 1e-4 max(1, t)``, against the JAX
``trace_bvh`` run op by op (``jax.disable_jit``), where every product and
sum rounds once, as the port's tensor ops and its CUDA kernel round them.
Under ``jit`` XLA contracts the Moller-Trumbore products into FMAs on the
CPU, so a ray through the shared edge of two triangles (v = 0 exactly)
misses one of them there; against the jitted reference the two walks
differ only on such ties.  Also against the port's ``trace_bruteforce``:
``hit`` equal and ``t`` within 1e-4 rtol/atol (the bound of
``tests/test_traversal_equiv.py``).  Images: < 2 % pixel forks (|diff| >
1e-3), median |diff| < 1e-5; gradients: 1e-4 relative per parameter, as
``tests/test_torch_replay_jax.py`` holds them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu import testing as jt
from ensem3a_openclraytracer_tpu.accel import lbvh as jlbvh
from ensem3a_openclraytracer_tpu.models import replay as jrp
from ensem3a_openclraytracer_tpu.models.pathtracer import render_radiance as j_render
from ensem3a_openclraytracer_tpu.ops.camera import camera_rays as j_camera_rays
from ensem3a_openclraytracer_tpu.ops.traversal import trace_bvh as j_trace_bvh
from ensem3a_openclraytracer_tpu_torch import convert
from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.accel import (
    build_lbvh,
    from_reference_abi,
    to_reference_abi,
    validate_bvh,
)
from ensem3a_openclraytracer_tpu_torch.accel.lbvh_device import build_lbvh_device
from ensem3a_openclraytracer_tpu_torch.models import replay as rp
from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance
from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
from ensem3a_openclraytracer_tpu_torch.ops import traversal as tv
from ensem3a_openclraytracer_tpu_torch.ops.intersect import trace_bruteforce
from ensem3a_openclraytracer_tpu_torch.ops.traversal import BVHNodes, trace_bvh, trace_bvh_plain
from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene

FIELDS = ("left", "right", "bmin", "bmax", "tri")
SOUPS = ["1", "2", "3", "7", "64", "211", "1000", "duplicates"]
RES, SPP, MB = 16, 2, 3


def _soup(name):
    """Triangles around random centroids (numpy seed), or 200 triangles
    over 10 repeated centroids (equal Morton codes: the rank tie-break)."""
    rng = np.random.default_rng(SOUPS.index(name))
    if name == "duplicates":
        c = np.repeat(rng.uniform(-1, 1, (10, 3)), 20, axis=0).astype(np.float32)
        return c, c + np.float32([0.01, 0, 0]), c + np.float32([0, 0.01, 0])
    t = int(name)
    c = rng.uniform(-5, 5, (t, 3))
    return tuple((c + 0.2 * rng.normal(size=(t, 3))).astype(np.float32) for _ in range(3))


def _host(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same_tree(a, b):
    for f in FIELDS:
        x, y = _host(getattr(a, f)), _host(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, (f, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("name", SOUPS)
def test_host_build_matches_jax(name):
    v0, v1, v2 = _soup(name)
    t = v0.shape[0]
    nodes = build_lbvh(v0, v1, v2)
    ref = jlbvh.build_lbvh(v0, v1, v2)
    _same_tree(nodes, ref)
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    stats = validate_bvh(nodes, t, tri_min, tri_max)
    assert stats["nodes"] == (2 * t - 1 if t > 1 else 1) and stats["leaves"] == t
    flat = to_reference_abi(nodes)
    np.testing.assert_array_equal(flat, jlbvh.to_reference_abi(ref))
    _same_tree(from_reference_abi(flat), jlbvh.from_reference_abi(flat))
    _same_tree(from_reference_abi(flat.reshape(-1)), nodes)


@pytest.mark.parametrize("name", SOUPS)
def test_device_build_equals_host_build(name):
    v0, v1, v2 = _soup(name)
    nodes = build_lbvh_device(v0, v1, v2, device="cpu")
    assert all(getattr(nodes, f).device.type == "cpu" for f in FIELDS)
    _same_tree(nodes, build_lbvh(v0, v1, v2))
    validate_bvh(nodes, v0.shape[0])


def _incoherent_rays(g, n=512, seed=11):
    """Rays from random points inside the scene's box in random directions."""
    rng = np.random.default_rng(seed)
    allv = np.concatenate([_host(g.v0), _host(g.v1), _host(g.v2)])
    lo, hi = allv.min(0), allv.max(0)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


TRACES = {  # name -> (JAX tree-only scene, rays: "camera" (24^2) or "incoherent" (512))
    "cornell_camera": (lambda: jt.make_cornell_scene(use_bvh=True), "camera"),
    "outdoor64_camera": (lambda: jt.make_outdoor_scene(n_cubes=64, use_bvh=True), "camera"),
    "outdoor64_incoherent": (lambda: jt.make_outdoor_scene(n_cubes=64, use_bvh=True), "incoherent"),
}


@functools.lru_cache(maxsize=None)
def _trace_case(name):
    """(JAX scene, port pack, rays, port plain hit, JAX jitted hit)."""
    make, kind = TRACES[name]
    jg, _, _, jc = make()
    g = convert.geometry(jg, "cpu")
    assert g.feats is None and g.bvh is not None
    if kind == "camera":
        rays = j_camera_rays(jc.position, jc.rotation_deg, jc.fov_deg, 24, 24)
        o, d = (np.array(x) for x in rays)
    else:
        o, d = _incoherent_rays(g)
    h = trace_bvh_plain(g.bvh, g.v0, g.v1, g.v2, torch.as_tensor(o), torch.as_tensor(d))
    jitted = j_trace_bvh(jg.bvh, jg.v0, jg.v1, jg.v2, jnp.asarray(o), jnp.asarray(d))
    return jg, g, o, d, h, jitted


def _hold(h, ref):
    """The traversal bounds: hit equal, tri on >= 99.9 %, |dt| <= 1e-4 max(1, t)."""
    hit, ref_hit = h.hit.numpy(), np.asarray(ref.hit)
    np.testing.assert_array_equal(hit, ref_hit)
    same = h.tri.numpy() == np.asarray(ref.tri)
    assert same.mean() >= 0.999, f"tri agrees on {same.mean():.5f}"
    t, rt = h.t.numpy()[same], np.asarray(ref.t)[same]
    assert (np.abs(t - rt) <= 1e-4 * np.maximum(1.0, rt)).all()


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_matches_jax_op_by_op(name):
    jg, g, o, d, h, _ = _trace_case(name)
    with jax.disable_jit():
        ref = j_trace_bvh(jg.bvh, jg.v0, jg.v1, jg.v2, jnp.asarray(o), jnp.asarray(d))
    _hold(h, ref)
    assert h.tri.dtype == torch.int64 and float(h.hit.float().mean()) > 0.0
    miss = ~h.hit
    assert (h.t[miss] == 1000.0).all() and (h.tri[miss] == 0).all()


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_forks_from_jitted_jax_only_on_ties(name):
    """Against the jitted JAX walk: the same hits, and where the triangle
    differs the two distances agree (a ray through a shared edge)."""
    _, _, _, _, h, ref = _trace_case(name)
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(ref.hit))
    t, rt = h.t.numpy(), np.asarray(ref.t)
    assert (np.abs(t - rt) <= 1e-6 * np.maximum(1.0, rt)).all(), np.abs(t - rt).max()


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_matches_bruteforce(name):
    _, g, o, d, h, _ = _trace_case(name)
    bf = trace_bruteforce(g.v0, g.v1, g.v2, torch.as_tensor(o), torch.as_tensor(d))
    assert torch.equal(bf.hit, h.hit)
    np.testing.assert_allclose(h.t[bf.hit].numpy(), bf.t[bf.hit].numpy(), rtol=1e-4, atol=1e-4)


def test_trace_dispatch_and_stats():
    """``ops/closest_hit.trace`` takes the tree on a tree-only pack (the
    wrapper's plain version on the CPU, no launch), ``trace_bvh`` counts
    the walk, and a stack too small for the tree drops pushes: the walk
    ends, and it can only lose hits."""
    _, g, o, d, h, _ = _trace_case("outdoor64_incoherent")
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    stats = torch.zeros(3, dtype=torch.int64)
    via = trace_bvh(g.bvh, g.v0, g.v1, g.v2, o, d, stats=stats)
    for a, b in zip(via, h):
        assert torch.equal(a, b)
    popped, leaf_tests, dropped = stats.tolist()
    assert popped >= o.shape[0] and 0 < leaf_tests < popped and dropped == 0
    hd = ch.trace(g, o, d)
    assert torch.equal(hd.t, h.t) and torch.equal(hd.tri, h.tri)
    shallow = torch.zeros(3, dtype=torch.int64)
    hs = trace_bvh_plain(g.bvh, g.v0, g.v1, g.v2, o, d, max_stack=4, stats=shallow)
    assert shallow[2] > 0 and shallow[0] < popped
    assert not (hs.hit & ~h.hit).any() and (hs.t >= h.t).all()
    assert (hs.hit == h.hit).float().mean() < 1.0


# --- tree-only renders and gradients -----------------------------------------

RENDERS = {  # JAX maker, port maker (testing.py), sun
    "cornell": (lambda: jt.make_cornell_scene(use_bvh=True),
                lambda: tt.make_cornell_scene(use_bvh=True, device="cpu"), False),
    "outdoor5": (lambda: jt.make_outdoor_scene(n_cubes=5, use_bvh=True),
                 lambda: tt.make_outdoor_scene(n_cubes=5, use_bvh=True, device="cpu"), True),
}


@functools.lru_cache(maxsize=None)
def _render_case(name):
    """The JAX scene, the explicit uniforms and the JAX render on them."""
    jmake, _, sun = RENDERS[name]
    jg, jm, je, jc = jmake()
    assert jg.feats is None and jg.bvh is not None
    rng = np.random.default_rng(20 + sorted(RENDERS).index(name))
    u = rng.random((SPP, MB + 1, RES * RES, 2), dtype=np.float64).astype(np.float32)
    ref = np.asarray(j_render(jg, jm, je, jc, jax.random.PRNGKey(0), height=RES, width=RES,
                              spp=SPP, max_bounce=MB, sun_enabled=sun, uniforms=jnp.asarray(u),
                              fused=False))
    return (jg, jm, je, jc), u, ref


def _port_pack(name, source, tmp_path):
    """The port's tree-only pack of the scene: from ``testing``, from
    ``convert.geometry`` of the JAX pack, or from ``Scene.load`` of its
    written files."""
    (jg, _, _, _), _, _ = _render_case(name)
    if source == "convert":
        return convert.geometry(jg, "cpu")
    g, m, e, c = RENDERS[name][1]()
    if source == "scene_load":
        obj = str(tmp_path / f"{name}.obj")
        tt.write_scene_files(obj, g, m, e, c, resolution=RES, spp=SPP, max_bounce=MB)
        loaded = Scene.load(obj, use_bvh=True, device="cpu").geometry
        assert loaded.feats is None
        _same_tree(loaded.bvh, g.bvh)
        g = loaded
    return g


@pytest.mark.parametrize("source", ["testing", "convert", "scene_load"])
@pytest.mark.parametrize("name", sorted(RENDERS))
def test_tree_only_render_matches_jax(name, source, tmp_path):
    (jg, jm, je, jc), u, ref = _render_case(name)
    g = _port_pack(name, source, tmp_path)
    assert g.feats is None
    _same_tree(g.bvh, jg.bvh)
    _, m, e, c = convert.scene(jg, jm, je, jc, device="cpu")
    img = render_radiance(g, m, e, c, height=RES, width=RES, spp=SPP, max_bounce=MB,
                          sun_enabled=RENDERS[name][2], uniforms=torch.as_tensor(u)).numpy()
    assert img.shape == ref.shape and np.isfinite(img).all() and img.mean() > 0.0
    diff = np.abs(img - ref).max(axis=-1)
    frac, med = float((diff > 1e-3).mean()), float(np.median(diff))
    assert frac < 0.02 and med < 1e-5, f"{name}/{source}: forks {frac:.4f}, median {med:.2e}"


def test_replay_gradients_on_tree_match_jax():
    """Replay gradients of ``mean(img^2)`` on the tree-only outdoor_5 pack
    against ``jax.grad`` of the JAX replay on the same pack and uniforms."""
    (jg, jm, je, jc), u, _ = _render_case("outdoor5")
    kw = dict(height=RES, width=RES, spp=SPP, max_bounce=MB, sun_enabled=True)

    def loss(color, rough, sun_p, ibl_p, ibl):
        img = jrp.render_radiance_replay(
            jg, jm._replace(color=color, roughness=rough),
            je._replace(sun_power=sun_p, ibl_power=ibl_p, ibl=ibl), jc, jax.random.PRNGKey(0),
            uniforms=jnp.asarray(u), **kw)
        return jnp.mean(img ** 2)

    ref = jax.grad(loss, argnums=tuple(range(5)))(jm.color, jm.roughness, je.sun_power,
                                                 je.ibl_power, je.ibl)
    g, m, e, c = convert.scene(jg, jm, je, jc, device="cpu")
    assert g.feats is None
    leaves = [x.clone().requires_grad_(True)
              for x in (m.color, m.roughness, e.sun_power, e.ibl_power, e.ibl)]
    img = rp.render_radiance_replay(
        g, m._replace(color=leaves[0], roughness=leaves[1]),
        e._replace(sun_power=leaves[2], ibl_power=leaves[3], ibl=leaves[4]), c,
        uniforms=torch.as_tensor(u), **kw)
    got = torch.autograd.grad(torch.mean(img ** 2), leaves, allow_unused=True)
    for f, a, b, x in zip(("color", "roughness", "sun_power", "ibl_power", "ibl"), got, ref,
                          leaves):
        a = np.zeros(tuple(x.shape), np.float32) if a is None else a.numpy()
        b = np.asarray(b)
        rel = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-12)
        assert rel <= 1e-4, f"{f}: relative difference {rel:.2e}"
    assert float(np.abs(np.asarray(ref[0])).max()) > 0.0


def test_tree_nodes_pack_for_the_kernel():
    """A pack's tree lives in one ``[M, 8]`` row buffer, ``(bmin, left)``
    and ``(bmax, right)`` with the integers as int32 bit patterns, that
    ``bmin/left/bmax/right`` view, equal to the host build; a tree of
    separate arrays is refused by the kernel's layout check."""
    g = tt.make_cornell_scene(use_bvh=True, device="cpu")[0]
    nodes = g.bvh
    rows = tv._rows(nodes)
    assert isinstance(nodes, BVHNodes) and rows.shape == (nodes.tri.shape[0], 8)
    ints = rows.view(torch.int32)
    assert torch.equal(rows[:, 0:3], nodes.bmin) and torch.equal(rows[:, 4:7], nodes.bmax)
    assert torch.equal(ints[:, 3], nodes.left) and torch.equal(ints[:, 7], nodes.right)
    host = build_lbvh(*(x.numpy() for x in (g.v0, g.v1, g.v2)))
    for f in BVHNodes._fields:
        assert np.array_equal(getattr(nodes, f).numpy(), getattr(host, f)), f
    soa = BVHNodes(*(x.contiguous() for x in nodes))
    with pytest.raises(ValueError, match="row layout"):
        tv._rows(soa)
