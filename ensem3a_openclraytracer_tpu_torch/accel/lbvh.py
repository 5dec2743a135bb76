"""LBVH builder on the host: Morton codes and a Karras radix tree, in numpy.

Counterpart of the JAX package's ``accel/lbvh.py`` (it replaced the
reference's recursive Python BVH, BVH.py:122-196): quantized centroid
Morton codes, one stable sort, a Karras-2012 binary radix tree (every
internal node found on its own from the code prefixes) and range-min/max
sparse tables for the internal boxes, all vectorised.  ``morton_codes``
also orders the triangles of every geometry pack.

The flattened node array converts losslessly to and from the reference's
9-float ABI ``[childL, childR, min.xyz, max.xyz, triId]`` (BVH.py:174-191).

Layout: ``T`` leaves, ``T - 1`` internal nodes.  Internals occupy indices
``[0, T - 2]`` (root = 0), leaves ``[T - 1, 2T - 2]`` in Morton order.
Leaves store the *original* triangle index.
"""

from __future__ import annotations

import numpy as np

from ensem3a_openclraytracer_tpu_torch.ops.traversal import BVHNodes


def _expand_bits_10(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of each uint32 so consecutive bits land 3 apart."""
    v = v.astype(np.uint64) & np.uint64(0x3FF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
    return v


def morton_codes(centroids: np.ndarray, bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points quantized to a 1024^3 grid in [bmin, bmax]."""
    extent = np.maximum(bmax - bmin, 1e-12)
    q = np.clip((centroids - bmin) / extent, 0.0, 0.9999999)
    g = (q * 1024.0).astype(np.uint32)
    return (
        (_expand_bits_10(g[:, 0]) << np.uint64(2))
        | (_expand_bits_10(g[:, 1]) << np.uint64(1))
        | _expand_bits_10(g[:, 2])
    ).astype(np.uint64)


def _bitlen_u64(x: np.ndarray) -> np.ndarray:
    """Exact bit length of uint64 values (vectorized)."""
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def bl32(v):
        out = np.zeros(v.shape, np.int64)
        nz = v != 0
        out[nz] = np.floor(np.log2(v[nz].astype(np.float64))).astype(np.int64) + 1
        return out

    hib = bl32(hi)
    return np.where(hib > 0, hib + 32, bl32(lo))


class _DeltaTable:
    """Common-prefix-length oracle over sorted, tie-broken 64-bit keys."""

    def __init__(self, keys: np.ndarray):
        self.keys = keys
        self.n = keys.shape[0]

    def __call__(self, i: np.ndarray, j: np.ndarray) -> np.ndarray:
        """delta(i, j): shared-prefix bits of keys i and j; -1 when j is
        out of range.  i must be in range."""
        valid = (j >= 0) & (j < self.n)
        js = np.clip(j, 0, self.n - 1)
        x = self.keys[i] ^ self.keys[js]
        d = 64 - _bitlen_u64(x)
        return np.where(valid, d, -1)


def _karras_tree(keys: np.ndarray):
    """The radix tree: for each internal node i in [0, T-2], its
    (left_child, right_child) in the flattened index space, and the first
    and last leaf of its range."""
    t = keys.shape[0]
    delta = _DeltaTable(keys)
    i = np.arange(t - 1, dtype=np.int64)

    d = np.sign(delta(i, i + 1) - delta(i, i - 1)).astype(np.int64)
    d = np.where(d == 0, 1, d)
    dmin = delta(i, i - d)

    # upper bound on the range length (vectorized doubling)
    lmax = np.full(t - 1, 2, np.int64)
    max_rounds = int(np.ceil(np.log2(max(t, 2)))) + 2
    for _ in range(max_rounds):
        grow = delta(i, i + lmax * d) > dmin
        if not grow.any():
            break
        lmax = np.where(grow, lmax * 2, lmax)

    # binary search the exact length
    l = np.zeros(t - 1, np.int64)
    step = lmax // 2
    while step.max(initial=0) > 0:
        cand = l + step
        ok = (step > 0) & (delta(i, i + cand * d) > dmin)
        l = np.where(ok, cand, l)
        step = step // 2
    j = i + l * d
    first = np.minimum(i, j)
    last = np.maximum(i, j)

    # split position: largest s with delta(i, i + (s+1)*d) > delta(i, j)
    dnode = delta(i, j)
    s = np.zeros(t - 1, np.int64)
    div = np.full(t - 1, 2, np.int64)
    while True:
        tstep = -(-l // div)  # ceil(l / div)
        cand = s + tstep
        ok = (tstep > 0) & (delta(i, i + cand * d) > dnode)
        s = np.where(ok, cand, s)
        if (tstep <= 1).all():
            break
        div = div * 2
    gamma = i + s * d + np.minimum(d, 0)

    leaf_base = t - 1
    left = np.where(first == gamma, leaf_base + gamma, gamma)
    right = np.where(last == gamma + 1, leaf_base + gamma + 1, gamma + 1)
    return left.astype(np.int32), right.astype(np.int32), first, last


def _range_minmax(first: np.ndarray, last: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Range min of ``lo`` / max of ``hi`` over [first, last] per query,
    via sparse tables (O(T log T) build, O(1) query)."""
    t = lo.shape[0]
    levels = max(1, int(np.floor(np.log2(t))) + 1)
    min_tab = [lo]
    max_tab = [hi]
    for k in range(1, levels):
        half = 1 << (k - 1)
        prev_min, prev_max = min_tab[-1], max_tab[-1]
        m = prev_min.shape[0] - half
        if m <= 0:
            break
        min_tab.append(np.minimum(prev_min[:m], prev_min[half : half + m]))
        max_tab.append(np.maximum(prev_max[:m], prev_max[half : half + m]))

    length = last - first + 1
    k = np.zeros_like(length)
    nz = length > 0
    k[nz] = np.floor(np.log2(length[nz].astype(np.float64))).astype(np.int64)
    k = np.clip(k, 0, len(min_tab) - 1)
    span = (np.int64(1) << k).astype(np.int64)
    second = last - span + 1

    out_min = np.empty((first.shape[0], lo.shape[1]), lo.dtype)
    out_max = np.empty_like(out_min)
    for kk in range(len(min_tab)):
        sel = k == kk
        if not sel.any():
            continue
        f = first[sel]
        s2 = second[sel]
        out_min[sel] = np.minimum(min_tab[kk][f], min_tab[kk][s2])
        out_max[sel] = np.maximum(max_tab[kk][f], max_tab[kk][s2])
    return out_min, out_max


def build_lbvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> BVHNodes:
    """Build the LBVH over triangles given as three ``[T, 3]`` float arrays.

    Returns :class:`BVHNodes` of host numpy arrays (callers move them to a
    device: ``ops/traversal.nodes_to``); ``2T - 1`` nodes (1 when T == 1).
    """
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    t = v0.shape[0]
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)

    if t == 1:
        return BVHNodes(
            left=np.array([-1], np.int32),
            right=np.array([-1], np.int32),
            bmin=tri_min.copy(),
            bmax=tri_max.copy(),
            tri=np.array([0], np.int32),
        )

    centroids = (tri_min + tri_max) * 0.5
    codes = morton_codes(centroids, centroids.min(0), centroids.max(0))
    order = np.argsort(codes, kind="stable").astype(np.int64)
    # tie-break equal codes by sorted position -> strictly increasing keys
    keys = (codes[order] << np.uint64(32)) | np.arange(t, dtype=np.uint64)

    left, right, first, last = _karras_tree(keys)

    smin = tri_min[order]
    smax = tri_max[order]
    int_min, int_max = _range_minmax(first, last, smin, smax)

    m = 2 * t - 1
    nodes = BVHNodes(
        left=np.full(m, -1, np.int32),
        right=np.full(m, -1, np.int32),
        bmin=np.empty((m, 3), np.float32),
        bmax=np.empty((m, 3), np.float32),
        tri=np.full(m, -1, np.int32),
    )
    nodes.left[: t - 1] = left
    nodes.right[: t - 1] = right
    nodes.bmin[: t - 1] = int_min
    nodes.bmax[: t - 1] = int_max
    nodes.bmin[t - 1 :] = smin
    nodes.bmax[t - 1 :] = smax
    nodes.tri[t - 1 :] = order.astype(np.int32)
    return nodes


# ---------------------------------------------------------------------------
# Reference 9-float ABI (BVH.py:174-191)
# ---------------------------------------------------------------------------


def _host(a) -> np.ndarray:
    """A numpy array of a host array or of a tensor on any device."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def to_reference_abi(nodes: BVHNodes) -> np.ndarray:
    """Flatten to the reference's ``[M, 9]`` float32 layout
    ``[childL, childR, min.xyz, max.xyz, triId]`` (-1 sentinels)."""
    m = nodes.left.shape[0]
    out = np.empty((m, 9), np.float32)
    out[:, 0] = _host(nodes.left)
    out[:, 1] = _host(nodes.right)
    out[:, 2:5] = _host(nodes.bmin)
    out[:, 5:8] = _host(nodes.bmax)
    out[:, 8] = _host(nodes.tri)
    return out


def from_reference_abi(flat: np.ndarray) -> BVHNodes:
    """Parse a reference-layout ``[M, 9]`` (or flat ``[M*9]``) node buffer
    into host numpy arrays."""
    flat = np.asarray(flat, np.float32).reshape(-1, 9)
    return BVHNodes(
        left=flat[:, 0].astype(np.int32),
        right=flat[:, 1].astype(np.int32),
        bmin=flat[:, 2:5].copy(),
        bmax=flat[:, 5:8].copy(),
        tri=flat[:, 8].astype(np.int32),
    )
