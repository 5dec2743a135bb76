"""LBVH build on a device: Morton codes, one sort and the Karras tree in torch.

Counterpart of the JAX package's ``accel/lbvh_device.py``: the host
builder of :mod:`accel.lbvh` as tensor ops on any device, so a scene on
the card goes from vertex buffers to a traversal-ready tree without a
round trip through the host.  Quantized centroid Morton codes, one stable
``torch.sort``, the Karras-2012 radix tree with a static number of rounds
in every search loop (``ceil(log2 T) + 2`` doublings, one more bisection
and split round: nothing waits on the data, so there is no host sync) and
sparse tables padded to one length for the internal boxes.

The tree is identical to ``accel.lbvh.build_lbvh``'s, array for array.
The host's uint64 keys ``(code << 32) | rank`` become int64 here (codes
have 30 bits, so a key fits in 62, and torch's unsigned 64-bit integers
are partial on CUDA); bit lengths are found in integer steps, and so is
the sparse-table level of each range (the JAX package picks it with a
float32 ``log2``, exact only below 2^24).
"""

from __future__ import annotations

import math

import torch

from ensem3a_openclraytracer_tpu_torch._device import DeviceLike, resolve_device
from ensem3a_openclraytracer_tpu_torch.ops.traversal import BVHNodes, nodes_to


def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes_device(centroids, bmin, bmax) -> torch.Tensor:
    """30-bit Morton codes (int64) on a 1024^3 grid: ``accel.lbvh.morton_codes``
    in tensor ops, equal to it."""
    extent = torch.clamp(bmax - bmin, min=1e-12)
    q = torch.clamp((centroids - bmin) / extent, 0.0, 0.9999999)
    g = (q * 1024.0).to(torch.int64)
    return (
        (_expand_bits_10(g[:, 0]) << 2)
        | (_expand_bits_10(g[:, 1]) << 1)
        | _expand_bits_10(g[:, 2])
    )


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative int64 values, in integer steps."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        hi = x >> s
        nz = hi != 0
        n = n + nz.long() * s
        x = torch.where(nz, hi, x)
    return n + (x != 0).long()


def _make_delta(keys: torch.Tensor, t: int):
    """Prefix-length oracle over the sorted int64 keys ``(code << 32) |
    rank``: ``delta(i, j) = 64 - bitlen(key_i ^ key_j)``, ``-1`` for
    out-of-range ``j``."""

    def delta(i, j):
        valid = (j >= 0) & (j < t)
        js = torch.clamp(j, 0, t - 1)
        d = 64 - _bitlen(keys[i] ^ keys[js])
        return torch.where(valid, d, torch.full_like(d, -1))

    return delta


def _karras_tree_device(keys: torch.Tensor, t: int):
    """(left, right) children per internal node, and the first and last
    leaf of its range: Karras-2012 with static log2-bounded loops."""
    delta = _make_delta(keys, t)
    i = torch.arange(t - 1, dtype=torch.int64, device=keys.device)

    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    dmin = delta(i, i - d)

    max_rounds = math.ceil(math.log2(max(t, 2))) + 2
    lmax = torch.full_like(i, 2)
    for _ in range(max_rounds):
        lmax = torch.where(delta(i, i + lmax * d) > dmin, lmax * 2, lmax)

    l = torch.zeros_like(i)
    step = lmax // 2
    for _ in range(max_rounds + 1):
        cand = l + step
        ok = (step > 0) & (delta(i, i + cand * d) > dmin)
        l = torch.where(ok, cand, l)
        step = step // 2
    j = i + l * d
    first = torch.minimum(i, j)
    last = torch.maximum(i, j)

    dnode = delta(i, j)
    s = torch.zeros_like(i)
    div = torch.full_like(i, 2)
    for _ in range(max_rounds + 1):
        tstep = -torch.div(-l, div, rounding_mode="floor")  # ceil(l / div)
        cand = s + tstep
        ok = (tstep > 0) & (delta(i, i + cand * d) > dnode)
        s = torch.where(ok, cand, s)
        div = div * 2
    gamma = i + s * d + torch.clamp(d, max=0)

    leaf_base = t - 1
    left = torch.where(first == gamma, leaf_base + gamma, gamma)
    right = torch.where(last == gamma + 1, leaf_base + gamma + 1, gamma + 1)
    return left.to(torch.int32), right.to(torch.int32), first, last


def _range_minmax_device(first, last, lo, hi, t: int):
    """Sparse-table range min/max with the level tables padded to one
    length and stacked, so each query's level pick is one gather."""
    levels = max(1, t.bit_length())  # floor(log2 t) + 1
    pad_min = torch.full((t, 3), float("inf"), dtype=lo.dtype, device=lo.device)
    pad_max = torch.full((t, 3), float("-inf"), dtype=hi.dtype, device=hi.device)
    min_tabs = [lo]
    max_tabs = [hi]
    for k in range(1, levels):
        half = 1 << (k - 1)
        prev_min, prev_max = min_tabs[-1], max_tabs[-1]
        m = t - half
        nmin = torch.minimum(prev_min[:m], prev_min[half : half + m])
        nmax = torch.maximum(prev_max[:m], prev_max[half : half + m])
        min_tabs.append(torch.cat([nmin, pad_min[m:]], dim=0))
        max_tabs.append(torch.cat([nmax, pad_max[m:]], dim=0))
    flat_min = torch.stack(min_tabs).reshape(levels * t, 3)
    flat_max = torch.stack(max_tabs).reshape(levels * t, 3)

    k = torch.clamp(_bitlen(torch.clamp(last - first + 1, min=1)) - 1, 0, levels - 1)
    second = last - (torch.ones_like(k) << k) + 1
    out_min = torch.minimum(flat_min[k * t + first], flat_min[k * t + second])
    out_max = torch.maximum(flat_max[k * t + first], flat_max[k * t + second])
    return out_min, out_max


def build_lbvh_device(v0, v1, v2, device: DeviceLike = None) -> BVHNodes:
    """Build the LBVH over triangles ``v0/v1/v2 [T, 3]`` (numpy arrays or
    tensors) with tensor ops on ``device`` (``None`` means ``cuda``).
    Returns :class:`BVHNodes` of tensors there in the kernel's row layout
    (``ops/traversal.nodes_to``), identical to ``accel.lbvh.build_lbvh``'s
    arrays; no host sync."""
    dev = resolve_device(device)
    v0, v1, v2 = (torch.as_tensor(v, device=dev).to(torch.float32) for v in (v0, v1, v2))
    t = v0.shape[0]
    tri_min = torch.minimum(torch.minimum(v0, v1), v2)
    tri_max = torch.maximum(torch.maximum(v0, v1), v2)
    neg = lambda n: torch.full((n,), -1, dtype=torch.int32, device=dev)
    if t == 1:
        return nodes_to(BVHNodes(left=neg(1), right=neg(1), bmin=tri_min, bmax=tri_max,
                                 tri=torch.zeros(1, dtype=torch.int32, device=dev)), dev)

    centroids = (tri_min + tri_max) * 0.5
    codes = morton_codes_device(centroids, centroids.amin(0), centroids.amax(0))
    codes_sorted, order = torch.sort(codes, stable=True)
    # tie-break equal codes by sorted position -> strictly increasing keys
    keys = (codes_sorted << 32) | torch.arange(t, dtype=torch.int64, device=dev)

    left, right, first, last = _karras_tree_device(keys, t)
    smin, smax = tri_min[order], tri_max[order]
    int_min, int_max = _range_minmax_device(first, last, smin, smax, t)

    m = 2 * t - 1
    node_left, node_right, node_tri = neg(m), neg(m), neg(m)
    node_left[: t - 1] = left
    node_right[: t - 1] = right
    node_tri[t - 1 :] = order.to(torch.int32)
    return nodes_to(BVHNodes(left=node_left, right=node_right, bmin=torch.cat([int_min, smin]),
                             bmax=torch.cat([int_max, smax]), tri=node_tri), dev)
