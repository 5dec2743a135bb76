"""Carry the JAX package's scene parameters across to the port.

The JAX package keeps scenes as pytrees of arrays.  These functions read
them by attribute access and ``numpy.asarray`` only (duck-typed; nothing
here imports JAX) and build the port's tensors on ``device``, so the
tests can render one scene through both packages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ensem3a_openclraytracer_tpu_torch._device import DeviceLike, resolve_device
from ensem3a_openclraytracer_tpu_torch.ops.closest_hit import (
    TriFeatures,
    build_tri_features,
    pack_features,
)
from ensem3a_openclraytracer_tpu_torch.scene.materials import (
    CameraParams,
    EnvParams,
    MaterialParams,
)
from ensem3a_openclraytracer_tpu_torch.scene.scene import GeometryPack, LightPack


def _t(x, dev, dtype=np.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(np.asarray(x), dtype), device=dev)


def geometry(geom, device: DeviceLike = None) -> GeometryPack:
    """A JAX ``GeometryPack``; its features are carried over when it has
    them and built from the triangles otherwise (a BVH-only pack)."""
    dev = resolve_device(device)
    f = geom.feats
    if f is None:
        feats = build_tri_features(np.asarray(geom.v0), np.asarray(geom.v1),
                                   np.asarray(geom.v2), dev)
    else:
        edges, plane, normal_d = _t(f.edges, dev), _t(f.plane, dev), _t(f.normal_d, dev)
        feats = TriFeatures(
            edges=edges, plane=plane, normal_d=normal_d, block_bounds=_t(f.block_bounds, dev),
            num_tris=int(f.num_tris), packed=pack_features(edges, plane, normal_d),
        )
    return GeometryPack(
        v0=_t(geom.v0, dev), v1=_t(geom.v1, dev), v2=_t(geom.v2, dev), n=_t(geom.n, dev),
        uv=_t(geom.uv, dev), mat=_t(geom.mat, dev, np.int32), feats=feats,
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
