"""BVH structural invariant checks (host-side, test and debug support).

Counterpart of the JAX package's ``accel/validate.py``.  The reference had
no equivalent: its builder could silently corrupt child indices on
degenerate splits and drop triangles from multi-triangle leaves
(BVH.py:107-109, :186-189).  These checks make such failures loud.  Trees
on a device are read back through ``.cpu().numpy()``.
"""

from __future__ import annotations

import numpy as np

from ensem3a_openclraytracer_tpu_torch.accel.lbvh import _host
from ensem3a_openclraytracer_tpu_torch.ops.traversal import BVHNodes


def validate_bvh(nodes: BVHNodes, num_tris: int, tri_min=None, tri_max=None) -> dict:
    """Validate tree structure; returns stats dict, raises AssertionError on
    violation.  Checks: every node reachable exactly once from the root,
    every triangle referenced by exactly one leaf, child boxes contained in
    parent boxes, leaf boxes containing their triangle's box, and depth."""
    left, right, tri = _host(nodes.left), _host(nodes.right), _host(nodes.tri)
    bmin, bmax = _host(nodes.bmin), _host(nodes.bmax)
    m = left.shape[0]
    is_leaf = tri >= 0
    n_leaves = int(is_leaf.sum())
    assert n_leaves == num_tris, f"{n_leaves} leaves != {num_tris} tris"
    assert m == (2 * num_tris - 1 if num_tris > 1 else 1)

    seen = np.zeros(m, bool)
    depth = np.zeros(m, np.int32)
    stack = [(0, 0)]
    while stack:
        idx, d = stack.pop()
        assert 0 <= idx < m, f"child index {idx} out of range"
        assert not seen[idx], f"node {idx} reached twice"
        seen[idx] = True
        depth[idx] = d
        if tri[idx] >= 0:
            assert left[idx] == -1 and right[idx] == -1
        else:
            l, r = int(left[idx]), int(right[idx])
            for c in (l, r):
                assert (bmin[c] >= bmin[idx] - 1e-5).all(), "child min outside parent"
                assert (bmax[c] <= bmax[idx] + 1e-5).all(), "child max outside parent"
            stack.append((l, d + 1))
            stack.append((r, d + 1))
    assert seen.all(), "unreachable nodes"

    tris = np.sort(tri[is_leaf])
    assert (tris == np.arange(num_tris)).all(), "triangle coverage broken"

    if tri_min is not None:
        leaf_idx = np.nonzero(is_leaf)[0]
        t = tri[leaf_idx]
        assert (bmin[leaf_idx] <= _host(tri_min)[t] + 1e-5).all()
        assert (bmax[leaf_idx] >= _host(tri_max)[t] - 1e-5).all()

    return {
        "nodes": m,
        "leaves": n_leaves,
        "max_depth": int(depth.max()),
        "mean_leaf_depth": float(depth[is_leaf].mean()),
    }
