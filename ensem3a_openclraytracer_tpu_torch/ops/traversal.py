"""BVH closest hit: a stack walk per ray through an LBVH.

Counterpart of the JAX package's ``ops/traversal.py`` (the reference's
per-thread stack walk, MathLib.cl:234-288 + stack.cl).  There the whole
ray batch advances in lock-step through one ``lax.while_loop``: one node
popped per live lane per round, each lane's stack a row of an ``[N,
MAX_STACK]`` array.  :func:`trace_bvh_plain` is that loop in tensor ops,
step for step; on the card the same walk is the CUDA kernel
``csrc/bvh_trace.cu``, one thread per ray (:func:`trace_bvh`), since in
eager PyTorch every round of the loop would end in a host sync.  The
kernel tests both children of an accepted node at that node and defers
the right one with its entry distance, whose last test (``tmin <=
best_t``) it makes when the child pops: plain's visits, in plain's order,
with plain's counts.

The walk: the root in slot 0; pop the top; cull the node when its slab
test gives ``tmax < tmin``, ``tmax < 0`` or ``tmin > best_t``; test a leaf's
triangle with ``ops/geometry.moller_trumbore`` and keep it when ``t >
MIN_HIT_DIST`` and ``t < best_t`` (strict, so the first triangle found at
a tied ``t`` stays); push an inner node's right child, then its left, so
the left pops first.  A push past ``MAX_STACK`` is dropped: the child and
its subtree go unvisited and the walk still ends.  (The JAX loop drops
the write but counts the push, so its later pops re-read the top slot,
which need not end; an LBVH over 62-bit keys is at most 63 deep and the
walk holds at most depth + 1 nodes, so 64 slots never overflow on the
trees of ``accel``, where both walks agree.)  A miss is
``t = MAX_DIST``, ``tri = 0``, ``hit = t < MAX_DIST``: unlike the port's
other closest hits (``ops/closest_hit.MISS_T``), a hit beyond ``0.999 *
MAX_DIST`` stays a hit here, as in the JAX package.

Node arrays are SoA (``left/right/tri`` int32, ``bmin/bmax [M, 3]``), on a
device views of one row buffer (:func:`nodes_to`); the reference's flat
9-float ABI converts losslessly through ``accel/lbvh.to_reference_abi`` /
``from_reference_abi``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ensem3a_openclraytracer_tpu_torch.ops import launches
from ensem3a_openclraytracer_tpu_torch.ops.closest_hit import _check
from ensem3a_openclraytracer_tpu_torch.ops.geometry import (
    MAX_DIST,
    MIN_HIT_DIST,
    cross_rn,
    dot_rn,
    moller_trumbore,
    ray_aabb,
)
from ensem3a_openclraytracer_tpu_torch.ops.intersect import Hit

MAX_STACK = 64

# Launches of the CUDA kernel; only a launch on the card counts.
LAUNCHES = launches.counter({"bvh_trace": ("bvh_trace_kernel",)})


class BVHNodes(NamedTuple):
    """SoA flattened BVH.  Internal nodes: ``tri == -1``, children valid.
    Leaves: ``tri >= 0`` (original triangle index), children ``-1``.
    From :func:`nodes_to` (every tree of ``accel`` and of a pack), ``bmin``,
    ``left``, ``bmax`` and ``right`` are views of one ``[M, 8]`` f32 row
    buffer, a node per 32-byte row ``(bmin.xyz, left, bmax.xyz, right)``
    with the integers' bits: the layout the CUDA kernel reads."""

    left: torch.Tensor  # [M] int32
    right: torch.Tensor  # [M] int32
    bmin: torch.Tensor  # [M, 3] float32
    bmax: torch.Tensor  # [M, 3] float32
    tri: torch.Tensor  # [M] int32


def nodes_to(nodes: BVHNodes, device) -> BVHNodes:
    """The tree on ``device`` (numpy arrays or tensors in) in the row
    layout of :class:`BVHNodes`, ``tri`` on its own."""
    t = lambda a, dt: torch.as_tensor(a, device=device).to(dt)
    rows = torch.empty((nodes.tri.shape[0], 8), dtype=torch.float32, device=device)
    ints = rows.view(torch.int32)
    rows[:, 0:3], ints[:, 3] = t(nodes.bmin, torch.float32), t(nodes.left, torch.int32)
    rows[:, 4:7], ints[:, 7] = t(nodes.bmax, torch.float32), t(nodes.right, torch.int32)
    return BVHNodes(left=ints[:, 3], right=ints[:, 7], bmin=rows[:, 0:3], bmax=rows[:, 4:7],
                    tri=t(nodes.tri, torch.int32).contiguous())


def _rows(nodes: BVHNodes) -> torch.Tensor:
    """The ``[M, 8]`` row buffer that the tree's fields view, or raise."""
    b = nodes.bmin
    base, m = b.data_ptr(), b.shape[0]
    views = ((nodes.left, 12, torch.int32), (nodes.bmax, 16, torch.float32),
             (nodes.right, 28, torch.int32))
    if not (b.dtype == torch.float32 and b.stride() == (8, 1) and base % 16 == 0
            and all(x.dtype == dt and x.data_ptr() == base + off and x.stride()[0] == 8
                    and x.shape[0] == m for x, off, dt in views)):
        raise ValueError("the tree is not in the kernel's row layout: move it with "
                         "ops/traversal.nodes_to")
    return torch.as_strided(b, (m, 8), (8, 1))


def trace_bvh_plain(nodes: BVHNodes, v0, v1, v2, ray_o, ray_d, max_stack: int = MAX_STACK,
                    stats: Optional[torch.Tensor] = None) -> Hit:
    """Closest hit of ``[N]`` rays against the triangles ``v0/v1/v2 [T, 3]``
    through the tree: the JAX package's ``trace_bvh`` in tensor ops, one
    round per popped node, on whatever device the rays are on, its cross
    and dot products rounded op by op (``cross_rn``, ``dot_rn``, as the
    kernel rounds them), so its bits are the same on every device and
    build.  ``stats`` (int64 ``[5]``, optional) receives the nodes
    popped, the leaf tests and the pushes dropped past ``max_stack``,
    added to what it holds;
    then the most nodes that one ray popped (the larger of that and what
    ``stats[3]`` holds) and, added to ``stats[4]``, the sum over groups of
    32 rays in ray order (a warp's lanes on the card) of each group's most
    nodes popped.  ``stats[0] / (32 * stats[4])`` is the walk's SIMT
    efficiency."""
    n = ray_o.shape[0]
    dev = ray_o.device
    lanes = torch.arange(n, device=dev)
    left, right, tri = nodes.left.long(), nodes.right.long(), nodes.tri.long()
    # column max_stack takes the writes of lanes that do not push
    stack = torch.zeros((n, max_stack + 1), dtype=torch.int64, device=dev)  # root in slot 0
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    best_t = torch.full((n,), MAX_DIST, dtype=torch.float32, device=dev)
    best_i = torch.zeros(n, dtype=torch.int64, device=dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    lane_pops = torch.zeros(n, dtype=torch.int64, device=dev)
    while bool((sp > 0).any()):
        active = sp > 0
        lane_pops += active.long()
        idx = torch.where(active, stack[lanes, torch.clamp(sp - 1, min=0)], 0)
        sp = torch.where(active, sp - 1, sp)

        tmin, tmax = ray_aabb(ray_o, ray_d, nodes.bmin[idx], nodes.bmax[idx])
        box_hit = active & (tmax >= tmin) & (tmax >= 0.0) & (tmin <= best_t)
        ti = tri[idx]
        is_leaf = ti >= 0

        tsafe = torch.clamp(ti, min=0)
        t, _, _, mt_hit = moller_trumbore(ray_o, ray_d, v0[tsafe], v1[tsafe], v2[tsafe],
                                          cross=cross_rn, dot=dot_rn)
        good = box_hit & is_leaf & mt_hit & (t > MIN_HIT_DIST) & (t < best_t)
        best_t = torch.where(good, t, best_t)
        best_i = torch.where(good, ti, best_i)

        push = box_hit & ~is_leaf
        dropped = torch.zeros_like(sp)
        for child in (right[idx], left[idx]):
            fits = push & (sp < max_stack)
            dropped = dropped + (push & ~fits).long()
            stack.scatter_(1, torch.where(fits, sp, max_stack)[:, None], child[:, None])
            sp = sp + fits.long()
        counts += torch.stack([active.sum(), (box_hit & is_leaf).sum(), dropped.sum()])
    if stats is not None:
        stats[:3] += counts
        if n:
            stats[3] = torch.maximum(stats[3], lane_pops.max())
            warps = torch.nn.functional.pad(lane_pops, (0, -n % 32)).view(-1, 32)
            stats[4] += warps.amax(dim=1).sum()
    return Hit(t=best_t, tri=best_i, hit=best_t < MAX_DIST)


_KERNEL_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]  # ray_o, ray_d, n
    + [ctypes.c_void_p] * 2 + [ctypes.c_int]  # node rows, tri, node count
    + [ctypes.c_void_p] * 3 + [ctypes.c_int]  # v0, v1, v2, triangle count
    + [ctypes.c_void_p] * 5  # out_t, out_tri, out_hit, stats, stream
)


@functools.cache
def _launcher():
    """The kernel's C entry point, built and typed on first use."""
    from ensem3a_openclraytracer_tpu_torch import _build

    fn = _build.load("bvh_trace").bvh_trace_launch
    fn.argtypes = _KERNEL_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def trace_bvh(nodes: BVHNodes, v0, v1, v2, ray_o, ray_d,
              stats: Optional[torch.Tensor] = None) -> Hit:
    """Closest hit through the tree: on the card one launch of the CUDA
    kernel ``csrc/bvh_trace.cu`` (one thread per ray; the visits, order,
    arithmetic and counts of :func:`trace_bvh_plain`; no host sync), on
    the CPU :func:`trace_bvh_plain`.  The kernel reads the
    tree's row buffer (:func:`nodes_to`).  ``stats`` (int64 ``[5]``,
    optional) as :func:`trace_bvh_plain`'s."""
    ray_o = ray_o.detach().to(torch.float32).contiguous()
    ray_d = ray_d.detach().to(torch.float32).contiguous()
    if ray_o.device.type == "cpu":
        return trace_bvh_plain(nodes, v0, v1, v2, ray_o, ray_d, stats=stats)
    if ray_o.device.type != "cuda":
        raise ValueError(f"trace_bvh runs on cuda or cpu, not {ray_o.device}")
    dev = ray_o.device
    n, m, t = ray_o.shape[0], nodes.tri.shape[0], v0.shape[0]
    rows = _rows(nodes)
    _check(rows, "node rows", (m, 8), torch.float32, dev)
    _check(nodes.tri, "tri", (m,), torch.int32, dev)
    for x, name in ((v0, "v0"), (v1, "v1"), (v2, "v2")):
        _check(x, name, (t, 3), torch.float32, dev)
    _check(ray_o, "ray_o", (n, 3), torch.float32, dev)
    _check(ray_d, "ray_d", (n, 3), torch.float32, dev)
    if stats is not None:
        _check(stats, "stats", (5,), torch.int64, dev)
    out_t = torch.empty((n,), dtype=torch.float32, device=dev)
    out_tri = torch.empty((n,), dtype=torch.int64, device=dev)
    out_hit = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return Hit(t=out_t, tri=out_tri, hit=out_hit)
    err = _launcher()(
        ray_o.data_ptr(), ray_d.data_ptr(), n, rows.data_ptr(), nodes.tri.data_ptr(), m,
        v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), t,
        out_t.data_ptr(), out_tri.data_ptr(), out_hit.data_ptr(),
        None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bvh_trace kernel launch failed: CUDA error {err}")
    LAUNCHES["bvh_trace"] += 1
    return Hit(t=out_t, tri=out_tri, hit=out_hit)
