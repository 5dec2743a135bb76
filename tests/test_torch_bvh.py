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
    stats = torch.zeros(5, dtype=torch.int64)
    via = trace_bvh(g.bvh, g.v0, g.v1, g.v2, o, d, stats=stats)
    for a, b in zip(via, h):
        assert torch.equal(a, b)
    popped, leaf_tests, dropped, most, warp_most = stats.tolist()
    assert popped >= o.shape[0] and 0 < leaf_tests < popped and dropped == 0
    assert popped / o.shape[0] <= most and popped <= 32 * warp_most
    hd = ch.trace(g, o, d)
    assert torch.equal(hd.t, h.t) and torch.equal(hd.tri, h.tri)
    shallow = torch.zeros(5, dtype=torch.int64)
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


# --- the walk's counters and a model of the CUDA kernel's walk ---------------
#
# ``csrc/bvh_trace.cu`` runs only on the card, so its algorithm is modelled
# here per ray in numpy float32, op for op (every product, sum and quotient
# rounded on its own, dot products summed in index order): both children of
# an accepted inner node tested at the node, the left one entered at once
# when it passes with ``tmin <= best_t``, the right one pushed as (what the
# walk needs of it, its entry distance) when ``tmax >= tmin`` and ``tmax >=
# 0``, and ``tmin <= best_t`` checked again when it pops.  The model must
# equal ``trace_bvh_plain`` bit for bit and in all five counts: the
# evidence on the CPU that the kernel's order is plain's.

F32 = np.float32
_TINY, _MT_EPS, _MIN_HIT, _MAX_DIST = F32(1e-12), F32(1e-7), F32(1e-4), F32(1000.0)


class _Ray:
    """One ray and the tree, in numpy float32, with plain's arithmetic."""

    def __init__(self, tree, o, d):
        self.left, self.right, self.bmin, self.bmax, self.tri, self.v = tree
        self.o, self.d = o, d
        nudged = [d[k] if abs(d[k]) >= _TINY else (-_TINY if d[k] < 0 else _TINY)
                  for k in range(3)]
        self.inv = [F32(1.0) / x for x in nudged]

    def slab(self, node):
        """``ops/geometry.ray_aabb``: (tmin, tmax)."""
        o, inv, lo, hi = self.o, self.inv, self.bmin[node], self.bmax[node]
        tmin = tmax = None
        for k in range(3):
            t1, t2 = (lo[k] - o[k]) * inv[k], (hi[k] - o[k]) * inv[k]
            near, far = min(t1, t2), max(t1, t2)
            tmin = near if k == 0 else max(tmin, near)
            tmax = far if k == 0 else min(tmax, far)
        return tmin, tmax

    def mt(self, tri):
        """``ops/geometry.moller_trumbore``: (hit, t)."""
        dot = lambda a, b: (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]
        cross = lambda a, b: [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                              a[0] * b[1] - a[1] * b[0]]
        a, b, c = self.v[tri]
        e1, e2, s = [b[k] - a[k] for k in range(3)], [c[k] - a[k] for k in range(3)], \
            [self.o[k] - a[k] for k in range(3)]
        h = cross(self.d, e2)
        det = dot(e1, h)
        parallel = abs(det) < _MT_EPS
        inv_det = F32(1.0) / (F32(1.0) if parallel else det)
        u = inv_det * dot(s, h)
        q = cross(s, e1)
        v = inv_det * dot(self.d, q)
        t = inv_det * dot(e2, q)
        hit = (not parallel and u >= 0 and u <= 1 and v >= 0 and u + v <= 1 and t > _MT_EPS)
        return hit, t

    def keep(self, tri, best):
        hit, t = self.mt(tri)
        return (t, tri) if hit and t > _MIN_HIT and t < best[0] else best


def _walk_plain(ray, max_stack=tv.MAX_STACK):
    """The plain walk for one ray: (t, tri, popped, leaf tests, dropped)."""
    best, stack, popped, leaves, dropped = (_MAX_DIST, 0), [0], 0, 0, 0
    while stack:
        node = stack.pop()
        popped += 1
        tmin, tmax = ray.slab(node)
        if not (tmax >= tmin and tmax >= 0 and tmin <= best[0]):
            continue
        if ray.tri[node] >= 0:
            leaves += 1
            best = ray.keep(int(ray.tri[node]), best)
            continue
        for child in (ray.right[node], ray.left[node]):
            if len(stack) < max_stack:
                stack.append(int(child))
            else:
                dropped += 1
    return best[0], best[1], popped, leaves, dropped


def _walk_kernel(ray, max_stack=tv.MAX_STACK, near_first=False):
    """``csrc/bvh_trace.cu``'s walk for one ray: (t, tri, popped, leaf
    tests, dropped).  A node is held as the kernel holds it once accepted:
    ``(left, right)`` for an inner node, ``(left < 0, its own index)`` for
    a leaf, whose ``tri`` is read when it is tested.  ``near_first`` makes
    the mutant that the kernel must not be: the child with the smaller
    entry distance entered first, the other one deferred."""
    node_of = lambda n: (int(ray.left[n]), n if ray.left[n] < 0 else int(ray.right[n]))
    best, stack, leaves, dropped = (_MAX_DIST, 0), [], 0, 0
    tmin, tmax = ray.slab(0)
    popped = 1
    cur = node_of(0) if tmax >= tmin and tmax >= 0 and tmin <= best[0] else None
    while cur is not None:
        a, b = cur
        cur = None
        if a >= 0:  # both children at their parent
            lmin, lmax = ray.slab(a)
            rmin, rmax = ray.slab(b)
            popped += 2
            if near_first and rmin < lmin:
                a, b, lmin, lmax, rmin, rmax = b, a, rmin, rmax, lmin, lmax
            if rmax >= rmin and rmax >= 0:
                if len(stack) < max_stack:
                    stack.append((node_of(b), rmin))
                else:
                    dropped += 1
            if lmax >= lmin and lmax >= 0 and lmin <= best[0]:
                cur = node_of(a)
                continue
        else:
            leaves += 1
            best = ray.keep(int(ray.tri[b]), best)
        while stack:
            node, entry = stack.pop()
            if entry <= best[0]:
                cur = node
                break
    return best[0], best[1], popped, leaves, dropped


def _per_ray(walk, g, o, d):
    """``walk`` over every ray: t, tri (arrays) and the five counts as
    ``trace_bvh_plain`` fills ``stats``."""
    b = g.bvh
    tree = (b.left.numpy(), b.right.numpy(), b.bmin.numpy(), b.bmax.numpy(), b.tri.numpy(),
            _host(torch.stack([g.v0, g.v1, g.v2], dim=1)))
    rows = [walk(_Ray(tree, oi, di)) for oi, di in zip(_host(o), _host(d))]
    t = np.asarray([r[0] for r in rows], np.float32)
    tri = np.asarray([r[1] for r in rows], np.int64)
    pops = np.asarray([r[2] for r in rows], np.int64)
    warps = np.pad(pops, (0, -pops.size % 32)).reshape(-1, 32).max(axis=1)
    counts = [int(pops.sum()), sum(r[3] for r in rows), sum(r[4] for r in rows),
              int(pops.max()), int(warps.sum())]
    return t, tri, counts


def _bounce_rays(g, o, d, n, seed):
    """``n`` rays leaving random hits of ``(o, d)`` in random directions."""
    h = trace_bvh_plain(g.bvh, g.v0, g.v1, g.v2, o, d)
    rng = np.random.default_rng(seed)
    hits = np.nonzero(h.hit.numpy())[0]
    pick = torch.as_tensor(rng.choice(hits, n))
    bd = torch.nn.functional.normalize(
        torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32)), dim=-1)
    return (o[pick] + d[pick] * h.t[pick, None]).contiguous(), bd.contiguous()


def _camera_and_bounce(name, n_bounce=576):
    _, g, o, d, _, _ = _trace_case(name)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    bo, bd = _bounce_rays(g, o, d, n_bounce, seed=5)
    return g, torch.cat([o, bo]), torch.cat([d, bd])


WALK_RAYS = {  # name -> (tree-only pack, ray_o, ray_d)
    "cornell_camera_bounce": lambda: _camera_and_bounce("cornell_camera"),
    "cornell_shared_edges": lambda: (lambda g: (g, *tt.shared_edge_rays(g)))(
        tt.make_cornell_scene(use_bvh=True, device="cpu")[0]),
    "outdoor64_camera_bounce": lambda: _camera_and_bounce("outdoor64_camera"),
    "outdoor64_grazing": lambda: (lambda g: (g, *tt.grazing_rays(g)))(
        tt.make_outdoor_scene(n_cubes=64, use_bvh=True, device="cpu")[0]),
}


@functools.lru_cache(maxsize=None)
def _walk_case(name):
    g, o, d = WALK_RAYS[name]()
    stats = torch.zeros(5, dtype=torch.int64)
    h = trace_bvh_plain(g.bvh, g.v0, g.v1, g.v2, o, d, stats=stats)
    return g, o, d, h, stats.tolist()


@pytest.mark.parametrize("name", ["cornell_camera_bounce", "outdoor64_camera_bounce"])
def test_walk_counters_match_per_ray_counts(name):
    """``stats[3]`` is the most nodes one ray popped and ``stats[4]`` the
    sum over groups of 32 rays of each group's most, against a per-ray walk
    in plain's order; ``stats[3]`` keeps the larger of what it held."""
    g, o, d, h, counts = _walk_case(name)
    t, tri, want = _per_ray(_walk_plain, g, o, d)
    assert counts == want, (counts, want)
    assert np.array_equal(t, h.t.numpy()) and np.array_equal(tri, h.tri.numpy())
    popped, _, dropped, most, warp_most = counts
    assert dropped == 0 and most > popped / o.shape[0]
    assert popped <= 32 * warp_most and warp_most <= most * -(-o.shape[0] // 32)
    held = torch.tensor([0, 0, 0, most + 7, 1], dtype=torch.int64)
    trace_bvh(g.bvh, g.v0, g.v1, g.v2, o, d, stats=held)
    assert held.tolist() == [popped, counts[1], 0, most + 7, warp_most + 1]


@pytest.mark.parametrize("name", sorted(WALK_RAYS))
def test_kernel_walk_model_equals_plain(name):
    """The kernel's walk, modelled per ray, against ``trace_bvh_plain``:
    ``t`` bit for bit, ``tri``, ``hit`` and the five counts equal, on
    camera and bounce rays, rays through Cornell's shared edges (ties) and
    rays grazing the outdoor ground."""
    g, o, d, h, counts = _walk_case(name)
    t, tri, got = _per_ray(_walk_kernel, g, o, d)
    assert np.array_equal(t.view(np.int32), h.t.numpy().view(np.int32))
    assert np.array_equal(tri, h.tri.numpy())
    assert np.array_equal(t < _MAX_DIST, h.hit.numpy())
    assert got == counts, (got, counts)
    assert counts[2] == 0 and counts[1] > 0 and bool(h.hit.any())


@pytest.mark.parametrize("name", sorted(WALK_RAYS))
def test_near_first_walk_model_differs_from_plain(name):
    """The model's near-child-first mutant takes another triangle than
    ``trace_bvh_plain`` on some rays of every set (a tie at equal ``t``
    keeps the first found) and pops other counts: the model's order is
    what ``test_kernel_walk_model_equals_plain`` holds to plain's."""
    g, o, d, h, counts = _walk_case(name)
    t, tri, got = _per_ray(functools.partial(_walk_kernel, near_first=True), g, o, d)
    assert int((tri != h.tri.numpy()).sum()) > 0
    assert got != counts
