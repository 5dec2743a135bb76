"""Closest-hit queries: triangle features, the exact f32 scan, and the
choice of kernel that answers them on the card.

Counterpart of the JAX package's ``ops/intersect_mxu.py`` (features and
the exact ``trace_mxu`` scan).  On the TPU three Pallas kernels carry
closest-hit queries, one per scene size: ``intersect_mxu._mxu_kernel``
(one 256-triangle block), ``pairs._tile_loop_kernel`` (2-64 blocks) and
``pairs._tile_stream_kernel`` (more).  Here one rule, :func:`resident`,
picks the kernel family of every trace and fused sample: a one-block
scene keeps its packed features resident in shared memory
(``csrc/closest_hit.cu``, :func:`trace_resident`, the role of
``_mxu_kernel``), more blocks take the block queues of ``ops/pairs.py``.

A ray hits triangle ``A, B, C`` when its Plucker side tests
``w = e . [d, d x o]`` against the three edge features share a sign
(``w == 0`` counts on both sides), and the plane distance
``t = ([o, 1] . [-n, n.A]) / (d . n)`` exceeds ``MIN_HIT_DIST``.  Among
equal ``t`` the lowest triangle index wins.  A ``t`` of
``MAX_DIST * 0.999`` or more is a miss: ``t = MAX_DIST``, ``tri = 0``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ensem3a_openclraytracer_tpu_torch.ops import launches
from ensem3a_openclraytracer_tpu_torch.ops.geometry import MAX_DIST, MIN_HIT_DIST
from ensem3a_openclraytracer_tpu_torch.ops.intersect import Hit

TRI_TILE = 256  # triangles per culling block (the TPU kernels' TRI_TILE)
MISS_T = MAX_DIST * 0.999

# Launches of the CUDA kernel, by kernel name.  Only a launch on the card
# counts; the CPU path runs the plain version and counts nothing.
LAUNCHES = launches.counter({"closest_hit": ("resident_hit_kernel",)})


class TriFeatures(NamedTuple):
    """Per-triangle intersection features, precomputed once per scene.

    ``edges [3, 6, Tp]``: Plucker features ``[A x B, A - B]`` of edges AB,
    BC, CA.  ``plane [4, Tp]``: ``[-n, n.A]`` so ``t * (n.d) = [o, 1] .
    plane``.  ``normal_d [3, Tp]``: ``n``.  Padding triangles are all zero
    (``d.n == 0``, never hit).  ``block_bounds [B, 8]``: the AABB of each
    ``TRI_TILE`` block (columns 0-5; padding-only blocks are inverted
    boxes) and in column 6 a scene-scale epsilon, which the kernels use as
    a conservative margin on their block culling.  ``packed [Tp, 28]``: the
    25 feature rows of each triangle side by side, padded to 28 (the
    triangle-major copy that every kernel stages with 16-byte loads;
    :func:`pack_features`), built once per scene.  ``edges``, ``plane``
    and ``normal_d`` are what the plain versions read."""

    edges: torch.Tensor
    plane: torch.Tensor
    normal_d: torch.Tensor
    block_bounds: torch.Tensor
    num_tris: int
    packed: torch.Tensor | None = None


PACKED_ROWS = 28  # feature rows per triangle in ``TriFeatures.packed``


def pack_features(edges: torch.Tensor, plane: torch.Tensor, normal_d: torch.Tensor) -> torch.Tensor:
    """``[Tp, 28]``: per triangle the 18 edge rows, the 4 plane rows and
    the 3 normal rows (the order of ``csrc/closest_hit.cuh``'s
    ``FEAT_ROWS``), then 3 zeros."""
    tp = edges.shape[-1]
    rows = torch.cat([edges.reshape(18, tp), plane, normal_d,
                      edges.new_zeros(PACKED_ROWS - 25, tp)])
    return rows.t().contiguous()


def build_tri_features(v0, v1, v2, device: torch.device) -> TriFeatures:
    """Host-side (numpy) feature build; pads ``T`` to a ``TRI_TILE``
    multiple above one block and to a multiple of 8 below it."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = v0.shape[0]
    pad_to = TRI_TILE if t > TRI_TILE else 8
    tp = -(-t // pad_to) * pad_to

    def edge_feat(a, b):
        return np.concatenate([np.cross(a, b), a - b], axis=-1)  # [T, 6]

    e = np.stack([edge_feat(v0, v1), edge_feat(v1, v2), edge_feat(v2, v0)])
    n = np.cross(v1 - v0, v2 - v0)
    na = np.einsum("td,td->t", n, v0)

    edges = np.zeros((3, 6, tp), np.float32)
    edges[:, :, :t] = np.transpose(e, (0, 2, 1))
    plane = np.zeros((4, tp), np.float32)
    plane[:3, :t] = -n.T
    plane[3, :t] = na
    normal_d = np.zeros((3, tp), np.float32)
    normal_d[:, :t] = n.T

    nb = -(-tp // TRI_TILE)
    bounds = np.zeros((nb, 8), np.float32)
    bounds[:, :3] = np.inf
    bounds[:, 3:6] = -np.inf
    allv = np.stack([v0, v1, v2])  # [3, T, 3]
    for b in range(nb):
        lo_t, hi_t = b * TRI_TILE, min((b + 1) * TRI_TILE, t)
        if lo_t < hi_t:
            blk = allv[:, lo_t:hi_t].reshape(-1, 3)
            bounds[b, :3] = blk.min(axis=0)
            bounds[b, 3:6] = blk.max(axis=0)
    scene_diag = 0.0
    if t > 0:
        flat = allv.reshape(-1, 3)
        scene_diag = float(np.linalg.norm(flat.max(axis=0) - flat.min(axis=0)))
    bounds[:, 6] = max(MIN_HIT_DIST, 2.0 ** -14 * scene_diag)

    as_t = lambda a: torch.as_tensor(a, device=device)
    edges, plane, normal_d = as_t(edges), as_t(plane), as_t(normal_d)
    return TriFeatures(
        edges=edges,
        plane=plane,
        normal_d=normal_d,
        block_bounds=as_t(bounds),
        num_tris=t,
        packed=pack_features(edges, plane, normal_d),
    )


def _finish(best_t: torch.Tensor, best_i: torch.Tensor) -> Hit:
    hit = best_t < MISS_T
    return Hit(
        t=torch.where(hit, best_t, torch.full_like(best_t, MAX_DIST)),
        tri=torch.where(hit, best_i, torch.zeros_like(best_i)),
        hit=hit,
    )


def ray_features(ray_o: torch.Tensor, ray_d: torch.Tensor):
    """``(r6, q4, d)``: ``[d, d x o]`` for the side tests, ``[o, 1]`` for
    the plane distance, and ``d``, all f32 ``[..., 6 / 4 / 3]``."""
    o = ray_o.to(torch.float32)
    d = ray_d.to(torch.float32)
    r6 = torch.cat([d, torch.linalg.cross(d, o, dim=-1)], dim=-1)
    q4 = torch.cat([o, torch.ones_like(o[..., :1])], dim=-1)
    return r6, q4, d


def tri_t(r6, q4, d, edges, plane, normal_d) -> torch.Tensor:
    """Hit distance of rays against triangles, ``[..., R, T]``, with
    ``MAX_DIST`` where the ray misses: the exact f32 arithmetic that every
    plain closest hit of the port shares.  Per ray ``r6 [..., R, 6]``,
    ``q4 [..., R, 4]``, ``d [..., R, 3]`` (:func:`ray_features`); per
    triangle ``edges [3, 6, ..., T]``, ``plane [4, ..., T]``, ``normal_d
    [3, ..., T]``; the leading ``...`` broadcast.  Dot products are summed
    term by term in index order, as the kernels do."""

    def rowdot(lhs, rows):  # sum_k lhs[..., k] * rows[k] in index order
        acc = lhs[..., 0, None] * rows[0][..., None, :]
        for k in range(1, rows.shape[0]):
            acc = acc + lhs[..., k, None] * rows[k][..., None, :]
        return acc

    w1 = rowdot(r6, edges[0])
    w2 = rowdot(r6, edges[1])
    w3 = rowdot(r6, edges[2])
    inside = ((w1 >= 0) & (w2 >= 0) & (w3 >= 0)) | ((w1 <= 0) & (w2 <= 0) & (w3 <= 0))
    den = rowdot(d, normal_d)
    num = rowdot(q4, plane)
    t = num / torch.where(den == 0.0, torch.ones_like(den), den)
    valid = inside & (den != 0.0) & (t > MIN_HIT_DIST)
    return torch.where(valid, t, torch.full_like(t, MAX_DIST))


def block_entries(block_bounds: torch.Tensor, ray_o: torch.Tensor,
                  ray_d: torch.Tensor) -> torch.Tensor:
    """``[N, B]`` conservative entry distance of each ray into each
    triangle block's box, grown by the margin in ``block_bounds[:, 6]``,
    ``+inf`` where the grown box is missed or the block holds only
    padding: the plain twin of ``block_entry`` in ``csrc/closest_hit.cuh``,
    with the same operations in the same order, one axis at a time."""
    tiny = 1e-12
    d = torch.where(
        torch.abs(ray_d) < tiny,
        torch.where(ray_d < 0, torch.full_like(ray_d, -tiny), torch.full_like(ray_d, tiny)),
        ray_d,
    )
    inv = 1.0 / d
    lo, hi, eps = block_bounds[:, 0:3], block_bounds[:, 3:6], block_bounds[:, 6]
    tmin = tmax = None
    for k in range(3):
        t1 = (lo[None, :, k] - ray_o[:, None, k]) * inv[:, None, k]
        t2 = (hi[None, :, k] - ray_o[:, None, k]) * inv[:, None, k]
        near, far = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = near if tmin is None else torch.maximum(tmin, near)
        tmax = far if tmax is None else torch.minimum(tmax, far)
    tmin = tmin - eps - 1e-6 * torch.abs(tmin)
    tmax = tmax + eps + 1e-6 * torch.abs(tmax)
    hit = (tmax >= tmin) & (tmax >= 0.0) & (lo[:, 0] <= hi[:, 0])
    return torch.where(hit, torch.clamp(tmin, min=0.0), torch.full_like(tmin, float("inf")))


def trace_plain(feats: TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor,
                tri_tile: int | None = None) -> Hit:
    """The exact f32 scan (the JAX package's ``trace_mxu``): every ray
    against every triangle, ``tri_tile`` triangles at a time, with the
    dot products summed term by term in index order (as the kernel does).
    Runs on whatever device the rays are on; it is the kernel's plain
    version and the CPU engine."""
    n = ray_o.shape[0]
    dev = ray_o.device
    r6, q4, d = ray_features(ray_o, ray_d)
    tp = feats.edges.shape[-1]
    if tri_tile is None:
        tri_tile = max(128, min(2048, (1 << 24) // max(n, 1)))

    best_t = torch.full((n,), MAX_DIST, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    for base in range(0, tp, tri_tile):
        sl = slice(base, min(base + tri_tile, tp))
        t = tri_t(r6, q4, d, feats.edges[:, :, sl], feats.plane[:, sl], feats.normal_d[:, sl])
        tmin, arg = torch.min(t, dim=1)
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, base + arg, best_i)
    return _finish(best_t, best_i)


def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def coherent_keys(p: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Sort keys ``(direction octant << 27) | 27-bit origin Morton code``
    (int64), as the JAX package's ``ops/fused.coherent_order`` builds them."""
    lo = torch.amin(p, dim=0)
    hi = torch.amax(p, dim=0)
    q = torch.clamp((p - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 0.9999999)
    g = (q * 512.0).to(torch.int64)  # 9 bits per axis
    code = (
        (_expand_bits_10(g[:, 0]) << 2)
        | (_expand_bits_10(g[:, 1]) << 1)
        | _expand_bits_10(g[:, 2])
    )
    octant = (
        ((d[:, 0] >= 0).to(torch.int64) << 2)
        | ((d[:, 1] >= 0).to(torch.int64) << 1)
        | (d[:, 2] >= 0).to(torch.int64)
    )
    return (octant << 27) | code


def coherent_order(p: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Argsort of rays by (direction octant, origin Morton code): rays
    that share a CUDA block then share a spatial cluster and an octant,
    so the kernel's per-block culling and early exit bite."""
    return torch.argsort(coherent_keys(p, d), stable=True)


_KERNEL_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]  # ray_o, ray_d, n
    + [ctypes.c_void_p] * 2  # packed, block_bounds
    + [ctypes.c_int] * 3  # tp, tile, nb
    + [ctypes.c_void_p] * 4  # out_t, out_tri, stats, stream
)


@functools.cache
def _launcher():
    """The kernel's C entry point, built and typed on first use."""
    from ensem3a_openclraytracer_tpu_torch import _build

    fn = _build.load("closest_hit").closest_hit_launch
    fn.argtypes = _KERNEL_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, name: str, shape: Tuple[int, ...], dtype, dev) -> None:
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {dtype} tensor of shape {shape} on {dev}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device} (contiguous={x.is_contiguous()})"
        )


def check_packed(feats: TriFeatures, tp: int, dev: torch.device) -> torch.Tensor:
    """``feats.packed``, checked for a kernel that stages it with 16-byte
    loads: contiguous f32 ``[tp, 28]`` on ``dev``, it and the block bounds
    16-byte aligned; raises otherwise."""
    if feats.packed is None:
        raise ValueError("features lack their packed copy: build them with build_tri_features")
    _check(feats.packed, "packed", (tp, PACKED_ROWS), torch.float32, dev)
    for x, name in ((feats.packed, "packed"), (feats.block_bounds, "block_bounds")):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return feats.packed


def check_features(feats: TriFeatures, dev: torch.device) -> Tuple[int, int, int]:
    """``(tp, tile, nb)`` of features that a closest-hit kernel can take on
    ``dev`` (contiguous f32, whole triangle blocks); raises otherwise."""
    tp = feats.edges.shape[-1]
    nb = feats.block_bounds.shape[0]
    tile = min(TRI_TILE, tp)
    if nb * tile != tp:
        raise ValueError(f"feature width {tp} is not {nb} blocks of {tile}")
    _check(feats.edges, "edges", (3, 6, tp), torch.float32, dev)
    _check(feats.plane, "plane", (4, tp), torch.float32, dev)
    _check(feats.normal_d, "normal_d", (3, tp), torch.float32, dev)
    _check(feats.block_bounds, "block_bounds", (nb, 8), torch.float32, dev)
    return tp, tile, nb


def resident(feats: TriFeatures) -> bool:
    """The one rule that picks a kernel family for a scene: one triangle
    block keeps its packed features resident in shared memory
    (:func:`trace_resident`, ``ops/fused.render_fused_resident`` and
    ``sample_fused_blocks``); any other count takes the block queues
    (``ops/pairs.trace_pairs``, ``ops/fused.sample_fused_queue``)."""
    return feats.block_bounds.shape[0] == 1


def trace_resident(feats: TriFeatures, ray_o: torch.Tensor, ray_d: torch.Tensor,
                   stats: torch.Tensor | None = None):
    """Closest hit ``(t [N] f32, tri [N] int32)`` on a one-block scene
    through the resident kernel ``csrc/closest_hit.cu`` for rays on the
    card (needs ``feats.packed``); rays on the CPU take
    :func:`trace_plain`.  Raises on more than one block, on any device.
    ``stats`` (int64 ``[2]`` on the card, optional) receives the (ray,
    triangle) pairs tested and the triangle-block stagings, added to what
    it holds."""
    if not resident(feats):
        raise ValueError(f"trace_resident takes one triangle block, not "
                         f"{feats.block_bounds.shape[0]}: trace sends other scenes to "
                         f"ops/pairs.trace_pairs")
    if ray_o.device.type == "cpu":
        h = trace_plain(feats, ray_o, ray_d)
        return h.t, h.tri.to(torch.int32)
    if ray_o.device.type != "cuda":
        raise ValueError(f"trace_resident runs on cuda or cpu, not {ray_o.device}")
    dev = ray_o.device
    n = ray_o.shape[0]
    tp, tile, nb = check_features(feats, dev)
    packed = check_packed(feats, tp, dev)
    _check(ray_o, "ray_o", (n, 3), torch.float32, dev)
    _check(ray_d, "ray_d", (n, 3), torch.float32, dev)
    if stats is not None:
        _check(stats, "stats", (2,), torch.int64, dev)
    out_t = torch.empty((n,), dtype=torch.float32, device=dev)
    out_tri = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return out_t, out_tri
    err = _launcher()(
        ray_o.data_ptr(), ray_d.data_ptr(), n, packed.data_ptr(),
        feats.block_bounds.data_ptr(), tp, tile, nb, out_t.data_ptr(), out_tri.data_ptr(),
        None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"closest_hit kernel launch failed: CUDA error {err}")
    LAUNCHES["closest_hit"] += 1
    return out_t, out_tri


def trace(geom, ray_o: torch.Tensor, ray_d: torch.Tensor, engine: str = "kernel") -> Hit:
    """Closest-hit dispatch: through ``geom.feats`` when the pack has
    them, on every device; through the tree (``ops/traversal.trace_bvh``)
    only when the pack has nothing else.  (The JAX package takes the tree
    on the CPU when a pack has both, a TPU rule: its matmul engines ran on
    the TPU.)  With features, rays on the card go through a kernel:
    :func:`trace_resident` on a :func:`resident` scene, else
    ``ops/pairs.trace_pairs`` (one launch, no ray sort).  Rays on the
    CPU, and any rays with ``engine="plain"``, take that kernel's plain
    version: :func:`trace_plain`, or ``ops/pairs.trace_pairs_plain`` (its
    block cull makes it much faster than the full scan); both equal
    :func:`trace_plain` bit for bit; on a tree,
    ``ops/traversal.trace_bvh_plain``.  Visibility is not
    differentiable: the inputs are detached."""
    ray_o = ray_o.detach().to(torch.float32).contiguous()
    ray_d = ray_d.detach().to(torch.float32).contiguous()
    feats = geom.feats
    if feats is None:
        from ensem3a_openclraytracer_tpu_torch.ops import traversal

        if geom.bvh is None:
            raise ValueError("the geometry pack has neither triangle features nor a tree")
        if engine not in ("kernel", "plain"):
            raise ValueError(f"unknown trace engine {engine!r}")
        run = traversal.trace_bvh_plain if engine == "plain" else traversal.trace_bvh
        return run(geom.bvh, geom.v0, geom.v1, geom.v2, ray_o, ray_d)
    queues = not resident(feats)
    if engine == "plain" or ray_o.device.type == "cpu":
        if queues:
            from ensem3a_openclraytracer_tpu_torch.ops.pairs import trace_pairs_plain

            return trace_pairs_plain(feats, ray_o, ray_d)
        return trace_plain(feats, ray_o, ray_d)
    if engine != "kernel":
        raise ValueError(f"unknown trace engine {engine!r}")
    if queues:
        from ensem3a_openclraytracer_tpu_torch.ops.pairs import trace_pairs

        return trace_pairs(feats, ray_o, ray_d)
    t, tri = trace_resident(feats, ray_o, ray_d)
    return Hit(t=t, tri=tri.to(torch.int64), hit=t < MISS_T)
