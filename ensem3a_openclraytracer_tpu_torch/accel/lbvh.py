"""Morton codes for spatial triangle ordering (host side, numpy).

Only the part of the JAX package's LBVH builder that geometry packing
needs: quantized centroid Morton codes.  The tree build itself
(``build_lbvh``) arrives with the BVH slice of the port.
"""

from __future__ import annotations

import numpy as np


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
