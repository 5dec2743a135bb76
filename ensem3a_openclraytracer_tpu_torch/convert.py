"""Carry the JAX package's scene parameters across to the port.

The JAX package keeps scenes as pytrees of arrays.  These functions read
them by attribute access and ``numpy.asarray`` only (duck-typed; nothing
here imports JAX) and build the port's tensors on ``device``, so the
tests can render one scene through both packages.  An inverse-rendering
run carries across too: :func:`trainable_params` and
:func:`optimizer_checkpoint`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ensem3a_openclraytracer_tpu_torch._device import DeviceLike, resolve_device
from ensem3a_openclraytracer_tpu_torch.models.optimize import (
    AdamState,
    TrainableParams,
    save_optimizer_checkpoint,
)
from ensem3a_openclraytracer_tpu_torch.ops.closest_hit import (
    SUB_TILE,
    TriFeatures,
    pack_features,
    tri_boxes,
)
from ensem3a_openclraytracer_tpu_torch.ops.traversal import BVHNodes, nodes_to
from ensem3a_openclraytracer_tpu_torch.scene.materials import (
    CameraParams,
    EnvParams,
    MaterialParams,
)
from ensem3a_openclraytracer_tpu_torch.scene.scene import GeometryPack, LightPack


def _t(x, dev, dtype=np.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(np.asarray(x), dtype), device=dev)


def bvh_nodes(nodes, device: DeviceLike = None) -> BVHNodes:
    """A JAX ``BVHNodes`` tree, with its packed copy for the kernel."""
    dev = resolve_device(device)
    host = lambda a, dt: np.array(np.asarray(a), dt)
    return nodes_to(BVHNodes(left=host(nodes.left, np.int32), right=host(nodes.right, np.int32),
                             bmin=host(nodes.bmin, np.float32), bmax=host(nodes.bmax, np.float32),
                             tri=host(nodes.tri, np.int32)), dev)


def geometry(geom, device: DeviceLike = None) -> GeometryPack:
    """A JAX ``GeometryPack`` with what it carries: its features (``None``
    for a tree-only pack) and its tree (``None`` without one), so both
    packages trace the same structure."""
    dev = resolve_device(device)
    f = geom.feats
    feats = None
    if f is not None:
        edges, plane, normal_d = _t(f.edges, dev), _t(f.plane, dev), _t(f.normal_d, dev)
        allv = np.stack([np.asarray(v, np.float32) for v in (geom.v0, geom.v1, geom.v2)])
        feats = TriFeatures(
            edges=edges, plane=plane, normal_d=normal_d, block_bounds=_t(f.block_bounds, dev),
            num_tris=int(f.num_tris), packed=pack_features(edges, plane, normal_d),
            sub_bounds=_t(tri_boxes(allv, edges.shape[-1], SUB_TILE), dev),
        )
    return GeometryPack(
        v0=_t(geom.v0, dev), v1=_t(geom.v1, dev), v2=_t(geom.v2, dev), n=_t(geom.n, dev),
        uv=_t(geom.uv, dev), mat=_t(geom.mat, dev, np.int32), feats=feats,
        bvh=None if geom.bvh is None else bvh_nodes(geom.bvh, dev),
    )


def materials(m, device: DeviceLike = None) -> MaterialParams:
    dev = resolve_device(device)
    return MaterialParams(
        mtype=_t(m.mtype, dev, np.int32), color=_t(m.color, dev),
        roughness=_t(m.roughness, dev), ior=_t(m.ior, dev),
    )


def env(e, device: DeviceLike = None) -> EnvParams:
    dev = resolve_device(device)
    return EnvParams(
        sun_angles_deg=_t(e.sun_angles_deg, dev), sun_power=_t(e.sun_power, dev),
        ibl_power=_t(e.ibl_power, dev), ibl=_t(e.ibl, dev),
    )


def camera(c, device: DeviceLike = None) -> CameraParams:
    dev = resolve_device(device)
    return CameraParams(
        position=_t(c.position, dev), rotation_deg=_t(c.rotation_deg, dev),
        fov_deg=_t(c.fov_deg, dev),
    )


def lights(lp, device: DeviceLike = None) -> Optional[LightPack]:
    if lp is None:
        return None
    dev = resolve_device(device)
    return LightPack(
        v0=_t(lp.v0, dev), v1=_t(lp.v1, dev), v2=_t(lp.v2, dev), n=_t(lp.n, dev),
        power=_t(lp.power, dev), area=_t(lp.area, dev), mat=_t(lp.mat, dev, np.int32),
    )


def scene(geom, mats, e, cam, device: DeviceLike = None):
    """``(geom, materials, env, camera)`` of a JAX ``testing.make_*`` scene."""
    return geometry(geom, device), materials(mats, device), env(e, device), camera(cam, device)


def trainable_params(p, device: DeviceLike = None) -> TrainableParams:
    """A JAX ``TrainableParams``."""
    dev = resolve_device(device)
    return TrainableParams(*(_t(x, dev) for x in (p.color, p.roughness, p.sun_power, p.ibl_power,
                                                   p.ibl)))


def optimizer_checkpoint(path_in, path_out, seed: int = 0) -> None:
    """Rewrite a JAX optimizer checkpoint (``models/optimize.py``'s
    ``save_optimizer_checkpoint`` with ``optax.adam``: leaves ``p0..p4`` of
    ``TrainableParams``, then ``o0`` = the step count, ``o1..o5`` = ``mu``
    and ``o6..o10`` = ``nu`` in flatten order, ``iteration``, ``key``) in
    the port's format, with equal parameters, moments, step count and
    iteration.  The JAX run's random key cannot carry over, since the two
    packages draw different streams (threefry there, Philox here): the
    port's checkpoint gets ``seed`` as its base seed, and a run resumed
    from it draws the port's stream for that seed."""
    with np.load(path_in) as z:
        tree = lambda prefix, first: TrainableParams(*(
            torch.as_tensor(np.array(z[f"{prefix}{first + i}"], np.float32)) for i in range(5)))
        params = tree("p", 0)
        opt_state = AdamState(count=torch.as_tensor(np.array(z["o0"], np.int32)), mu=tree("o", 1),
                              nu=tree("o", 6))
        iteration = int(z["iteration"])
    save_optimizer_checkpoint(path_out, params, opt_state, iteration, seed)
