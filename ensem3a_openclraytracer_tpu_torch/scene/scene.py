"""Scene assembly: OBJ + ini -> SoA triangle tensors + parameters.

Counterpart of the JAX package's ``scene/scene.py`` (the reference's
``Scene``, FileManager.py:209-331).  Triangles are gathered once at load
time into ``v0/v1/v2/n/uv/mat`` arrays in Morton order, with the
closest-hit features (``ops/closest_hit.TriFeatures``) at any scene size,
or with ``use_bvh=True`` an LBVH built on the pack's device
(``accel/lbvh_device.build_lbvh_device``) and no features.  Unlike the
JAX package, the port builds no tree by itself for large scenes (its
``MXU_TRACE_MAX_TRIS`` rule is a TPU tuning): on the card the block
queues of ``ops/pairs.py`` take any scene size, and a tree beside
features would never be read (``ops/closest_hit.trace``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ensem3a_openclraytracer_tpu_torch._device import DeviceLike, resolve_device
from ensem3a_openclraytracer_tpu_torch.accel.lbvh import morton_codes
from ensem3a_openclraytracer_tpu_torch.accel.lbvh_device import build_lbvh_device
from ensem3a_openclraytracer_tpu_torch.ops.closest_hit import TriFeatures, build_tri_features
from ensem3a_openclraytracer_tpu_torch.ops.traversal import BVHNodes
from ensem3a_openclraytracer_tpu_torch.scene.config import ConfigReader
from ensem3a_openclraytracer_tpu_torch.scene.materials import (
    CameraParams,
    EnvParams,
    MaterialParams,
    default_sky,
)
from ensem3a_openclraytracer_tpu_torch.scene.objloader import ObjMesh, load_obj
from ensem3a_openclraytracer_tpu_torch.utils.profiling import span


class LightPack(NamedTuple):
    """Emissive-triangle table for next-event estimation, one row per
    emissive face."""

    v0: torch.Tensor  # [L, 3]
    v1: torch.Tensor  # [L, 3]
    v2: torch.Tensor  # [L, 3]
    n: torch.Tensor  # [L, 3] unit geometric normal
    power: torch.Tensor  # [L] emissive power snapshot (material roughness slot)
    area: torch.Tensor  # [L]
    mat: torch.Tensor  # [L] int32 material index (power is re-read from it)


class GeometryPack(NamedTuple):
    """SoA triangle soup on one device, plus its closest-hit structure:
    the triangle features, or (a tree-only pack) an LBVH.  ``bvh`` comes
    last, so positional constructions without it keep working."""

    v0: torch.Tensor  # [T, 3] float32
    v1: torch.Tensor  # [T, 3]
    v2: torch.Tensor  # [T, 3]
    n: torch.Tensor  # [T, 3] per-face shading normal (vertex a's normal)
    uv: torch.Tensor  # [T, 2] (vertex a's uv)
    mat: torch.Tensor  # [T] int32 material index
    feats: Optional[TriFeatures]  # None => a tree-only pack
    bvh: Optional[BVHNodes] = None  # the LBVH over these (Morton-ordered) triangles


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_light_pack(geom: Optional[GeometryPack], materials: MaterialParams,
                     host_arrays: Optional[tuple] = None) -> Optional[LightPack]:
    """Collect emissive faces (material type 0); None when there are none.
    ``host_arrays = (v0, v1, v2, mat)`` (numpy, Morton order) spares the
    device-to-host copies of ``geom``.  The pack lies on the materials'
    device."""
    if host_arrays is not None:
        h_v0, h_v1, h_v2, mat_ids = host_arrays
        mat_ids = np.asarray(mat_ids, np.int32)
    else:
        mat_ids = _np(geom.mat).astype(np.int32)
    mtype = _np(materials.mtype)
    power = _np(materials.roughness)
    emissive = mtype[np.clip(mat_ids, 0, mtype.shape[0] - 1)] == 0
    idx = np.nonzero(emissive)[0]
    if idx.size == 0:
        return None
    if host_arrays is not None:
        v0, v1, v2 = h_v0[idx], h_v1[idx], h_v2[idx]
    else:
        v0, v1, v2 = _np(geom.v0)[idx], _np(geom.v1)[idx], _np(geom.v2)[idx]
    nrm = np.cross(v1 - v0, v2 - v0)
    area = 0.5 * np.linalg.norm(nrm, axis=-1)
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    dev = materials.mtype.device
    t = lambda a, dt=np.float32: torch.as_tensor(np.asarray(a, dt), device=dev)
    return LightPack(
        v0=t(v0), v1=t(v1), v2=t(v2), n=t(nrm),
        power=t(power[mat_ids[idx]]), area=t(area), mat=t(mat_ids[idx], np.int32),
    )


def morton_order(v0, v1, v2) -> np.ndarray:
    """Spatial (Morton) triangle order: consecutive triangles share a
    region, which tightens the per-block AABBs the kernel culls with."""
    c = (np.asarray(v0) + np.asarray(v1) + np.asarray(v2)) / 3.0
    codes = morton_codes(c, c.min(0), c.max(0))
    return np.argsort(codes, kind="stable").astype(np.int64)


def pack_arrays(v0, v1, v2, n, uv, mat, device: torch.device,
                use_bvh: bool = False) -> GeometryPack:
    """Tensors of already-ordered host triangle arrays, with features, or
    with ``use_bvh`` the tree (built on ``device``:
    ``accel/lbvh_device.build_lbvh_device``) and no features."""
    t = lambda a, dt=np.float32: torch.as_tensor(np.asarray(a, dt), device=device)
    tris = t(v0), t(v1), t(v2)
    if use_bvh:
        feats, bvh = None, build_lbvh_device(*tris, device)
    else:
        feats, bvh = build_tri_features(v0, v1, v2, device), None
    return GeometryPack(*tris, n=t(n), uv=t(uv), mat=t(mat, np.int32), feats=feats, bvh=bvh)


def pack_geometry(mesh: ObjMesh, use_bvh: Optional[bool] = None,
                  device: DeviceLike = None) -> GeometryPack:
    """Gather indexed mesh data into Morton-ordered SoA triangles; hit
    indices use the reordered space throughout.  ``use_bvh=True`` gives a
    tree-only pack, as the JAX package's does; ``None`` and ``False`` the
    features at any size."""
    dev = resolve_device(device)
    fd = mesh.face_data
    v0 = mesh.v_p[fd[:, 7]]
    v1 = mesh.v_p[fd[:, 8]]
    v2 = mesh.v_p[fd[:, 9]]
    n = mesh.v_n[np.clip(fd[:, 4], 0, len(mesh.v_n) - 1)]
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    uv = mesh.v_uv[np.clip(fd[:, 1], 0, len(mesh.v_uv) - 1)]
    mat = fd[:, 0].astype(np.int32)
    order = morton_order(v0, v1, v2)
    return pack_arrays(v0[order], v1[order], v2[order], n[order], uv[order], mat[order], dev,
                       use_bvh=bool(use_bvh))


def load_ibl_image(path: str, fallback_dirs: tuple = ()) -> np.ndarray:
    """A lat-long environment image as float32 ``[H, W, 3]`` in [0, 1];
    the procedural sky when the file is missing."""
    candidates = [path] + [os.path.join(d, os.path.basename(path)) for d in fallback_dirs]
    for cand in candidates:
        if cand and os.path.exists(cand):
            from PIL import Image

            img = Image.open(cand).convert("RGB")
            return np.asarray(img, np.float32) / 255.0
    return default_sky()


@dataclass
class Scene:
    """Host-side scene: import arrays, ini config, and device geometry.
    Loading creates the ``.ini`` next to the ``.obj`` with defaults when
    it is missing, like the reference."""

    obj_path: str
    mesh: ObjMesh
    config: ConfigReader
    material_table: np.ndarray  # [M, 6] reference ABI
    light_faces: np.ndarray  # int32 indices of emissive faces (packed order)
    geometry: GeometryPack
    device: torch.device
    # the IBL on the device, by file name: env_params() gives the same tensor
    # on each call, which a graphed render reads in place (utils/graphs)
    ibl_cache: dict = field(default_factory=dict, repr=False, compare=False)

    @staticmethod
    def load(obj_path: str, rebuild_accel: bool = True,
             geometry: Optional[GeometryPack] = None, use_bvh: Optional[bool] = None,
             device: DeviceLike = None) -> "Scene":
        dev = resolve_device(device)
        with span("scene.load.parse"):
            mesh = load_obj(obj_path)
        config = ConfigReader(
            obj_path[: -len(".obj")] + ".ini" if obj_path.endswith(".obj") else obj_path + ".ini",
            material_count=mesh.num_materials - 1,
        )
        table = config.material_table(mesh.num_materials)
        if rebuild_accel or geometry is None:
            geom = pack_geometry(mesh, use_bvh=use_bvh, device=dev)
        else:
            geom = geometry
        fd = mesh.face_data
        order = morton_order(mesh.v_p[fd[:, 7]], mesh.v_p[fd[:, 8]], mesh.v_p[fd[:, 9]])
        mat_ids = fd[:, 0].astype(np.int32)[order]
        emissive = table[np.clip(mat_ids, 0, table.shape[0] - 1), 0] == 0
        return Scene(
            obj_path=obj_path, mesh=mesh, config=config, material_table=table,
            light_faces=np.nonzero(emissive)[0].astype(np.int32), geometry=geom, device=dev,
        )

    def material_params(self) -> MaterialParams:
        return MaterialParams.from_table(self.material_table, device=self.device)

    def env_params(self, ibl: Optional[np.ndarray] = None) -> EnvParams:
        """The ini's environment; its IBL is loaded once per file name and
        the same device tensor is returned on every call (``ibl`` replaces
        it)."""
        env = self.config.environment_settings()
        if ibl is None:
            if env.ibl_file not in self.ibl_cache:
                self.ibl_cache.clear()
                img = load_ibl_image(
                    env.ibl_file, fallback_dirs=(os.path.dirname(self.obj_path), "IBL")
                )
                self.ibl_cache[env.ibl_file] = torch.as_tensor(img, device=self.device)
            ibl = self.ibl_cache[env.ibl_file]
        return EnvParams.create(
            sun_angles_deg=env.sun_angles_deg, sun_power=env.sun_power,
            ibl_power=env.ibl_power, ibl=ibl, device=self.device,
        )

    def camera_params(self) -> CameraParams:
        cam = self.config.camera_settings()
        return CameraParams.create(cam.position, cam.rotation_deg, cam.fov_deg, device=self.device)

    def light_pack(self, materials: Optional[MaterialParams] = None) -> Optional[LightPack]:
        """Emissive-face table for NEE, built from the host mesh."""
        if materials is None:
            materials = self.material_params()
        fd = self.mesh.face_data
        v0 = self.mesh.v_p[fd[:, 7]]
        v1 = self.mesh.v_p[fd[:, 8]]
        v2 = self.mesh.v_p[fd[:, 9]]
        order = morton_order(v0, v1, v2)
        host = (v0[order], v1[order], v2[order], fd[:, 0].astype(np.int32)[order])
        return build_light_pack(None, materials, host_arrays=host)

    def reload_materials(self) -> None:
        """Re-read the material table from the config file."""
        self.material_table = self.config.material_table(self.mesh.num_materials)

    @property
    def num_tris(self) -> int:
        return self.mesh.num_faces
