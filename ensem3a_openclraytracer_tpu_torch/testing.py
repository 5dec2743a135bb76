"""Procedural test scenes built in code, and a writer that saves one as
an ``.obj`` + ``.ini`` pair for ``Scene.load``.

Counterpart of the JAX package's ``testing.py``: the same triangles,
materials, lights and cameras, as the port's tensors on a given device.
Every maker defaults to ``use_bvh=False`` (a features pack), where the JAX
package's ``make_outdoor_scene`` defaults to ``True``: the port's card
tests and ``chip_smoke.py`` drive the feature kernels through these
defaults, and a tree is asked for by name.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ensem3a_openclraytracer_tpu_torch._device import DeviceLike, resolve_device
from ensem3a_openclraytracer_tpu_torch.scene.materials import (
    CameraParams,
    EnvParams,
    MaterialParams,
    default_sky,
)
from ensem3a_openclraytracer_tpu_torch.scene.scene import (
    GeometryPack,
    morton_order,
    pack_arrays,
)


def _quad(a, b, c, d, mat):
    """Two CCW triangles for the quad a-b-c-d, tagged with material id."""
    return [(a, b, c, mat), (a, c, d, mat)]


def _cube(center, size, mat):
    cx, cy, cz = center
    sx, sy, sz = (size, size, size) if np.isscalar(size) else size
    x0, x1 = cx - sx / 2, cx + sx / 2
    y0, y1 = cy - sy / 2, cy + sy / 2
    z0, z1 = cz - sz / 2, cz + sz / 2
    tris = []
    # windings so cross(b-a, c-a) points out of the cube
    tris += _quad((x0, y1, z0), (x1, y1, z0), (x1, y0, z0), (x0, y0, z0), mat)  # -z
    tris += _quad((x1, y0, z1), (x1, y1, z1), (x0, y1, z1), (x0, y0, z1), mat)  # +z
    tris += _quad((x0, y0, z1), (x0, y1, z1), (x0, y1, z0), (x0, y0, z0), mat)  # -x
    tris += _quad((x1, y1, z0), (x1, y1, z1), (x1, y0, z1), (x1, y0, z0), mat)  # +x
    tris += _quad((x1, y0, z0), (x1, y0, z1), (x0, y0, z1), (x0, y0, z0), mat)  # -y
    tris += _quad((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0), mat)  # +y
    return tris


def _pack(tris, use_bvh: bool, device) -> GeometryPack:
    """Morton-ordered pack of the triangles: features, or with
    ``use_bvh`` a tree-only pack (``scene.pack_arrays``)."""
    v0 = np.asarray([t[0] for t in tris], np.float32)
    v1 = np.asarray([t[1] for t in tris], np.float32)
    v2 = np.asarray([t[2] for t in tris], np.float32)
    mat = np.asarray([t[3] for t in tris], np.int32)
    order = morton_order(v0, v1, v2)
    v0, v1, v2, mat = v0[order], v1[order], v2[order], mat[order]
    n = np.cross(v1 - v0, v2 - v0)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    uv = np.zeros((len(tris), 2), np.float32)
    return pack_arrays(v0, v1, v2, n, uv, mat, device, use_bvh=use_bvh)


# material ids (type codes: 0 emissive, 1 diffuse, 2 glossy-GGX, 3 glass)
M_LIGHT, M_WHITE, M_RED, M_GREEN, M_GLOSSY, M_GLASS = range(6)

_CORNELL_TABLE = np.asarray(
    [
        # type, R, G, B, roughness (emissive power for type 0), ior
        [0, 1.0, 1.0, 1.0, 12.0, 1.0],
        [1, 0.75, 0.75, 0.75, 0.8, 1.0],
        [1, 0.75, 0.15, 0.15, 0.9, 1.0],
        [1, 0.15, 0.75, 0.15, 0.9, 1.0],
        [2, 0.85, 0.85, 0.9, 0.15, 1.0],
        [3, 0.9, 0.95, 0.9, 0.0, 1.5],
    ],
    np.float32,
)


def cornell_materials(device: DeviceLike = None) -> MaterialParams:
    return MaterialParams.from_table(_CORNELL_TABLE, device=device)


def cornell_geometry(use_bvh: bool = False, device: DeviceLike = None) -> GeometryPack:
    """Cornell-style box interior along +y (the camera's forward axis):
    x in [-1, 1], z in [-1, 1], y in [0, 4]; 36 triangles."""
    tris = []
    tris += _quad((-1, 0, -1), (1, 0, -1), (1, 4, -1), (-1, 4, -1), M_WHITE)  # floor
    tris += _quad((-1, 0, 1), (-1, 4, 1), (1, 4, 1), (1, 0, 1), M_WHITE)  # ceiling
    tris += _quad((-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1), M_WHITE)  # back
    tris += _quad((-1, 0, -1), (-1, 4, -1), (-1, 4, 1), (-1, 0, 1), M_RED)  # left
    tris += _quad((1, 0, -1), (1, 0, 1), (1, 4, 1), (1, 4, -1), M_GREEN)  # right
    tris += _quad(
        (-0.4, 2.2, 0.98), (-0.4, 3.2, 0.98), (0.4, 3.2, 0.98), (0.4, 2.2, 0.98), M_LIGHT
    )
    tris += _cube((-0.45, 2.9, -0.62), (0.55, 0.55, 0.75), M_GLOSSY)
    tris += _cube((0.45, 2.2, -0.7), (0.5, 0.5, 0.6), M_GLASS)
    return _pack(tris, use_bvh, resolve_device(device))


def cornell_camera(device: DeviceLike = None) -> CameraParams:
    return CameraParams.create(
        position=(0.0, 0.35, 0.0), rotation_deg=(0.0, 0.0, 0.0), fov_deg=50.0, device=device
    )


def cornell_env(ibl_res: Tuple[int, int] = (16, 32), device: DeviceLike = None) -> EnvParams:
    return EnvParams.create(
        sun_angles_deg=(30.0, 0.0, 20.0), sun_power=0.0, ibl_power=0.0,
        ibl=default_sky(*ibl_res), device=device,
    )


def make_cornell_scene(use_bvh: bool = False, device: DeviceLike = None):
    """Returns ``(geom, materials, env, camera)`` ready for the renderer."""
    return (cornell_geometry(use_bvh, device), cornell_materials(device),
            cornell_env(device=device), cornell_camera(device))


def make_glass_light_scene(use_bvh: bool = False, device: DeviceLike = None):
    """Diffuse floor lit by an emissive panel with a wide glass pane in
    between: every floor->light path crosses the glass (the NEE edge
    case of a glass-occluded shadow ray)."""
    tris = []
    tris += _quad((-8, -4, 0), (8, -4, 0), (8, 12, 0), (-8, 12, 0), M_WHITE)
    tris += _quad((-60, -60, 1.5), (60, -60, 1.5), (60, 60, 1.5), (-60, 60, 1.5), M_GLASS)
    tris += _quad((-40, -40, 3), (40, -40, 3), (40, 40, 3), (-40, 40, 3), M_LIGHT)
    dev = resolve_device(device)
    geom = _pack(tris, use_bvh, dev)
    env = EnvParams.create(
        sun_angles_deg=(0.0, 0.0, 0.0), sun_power=0.0, ibl_power=0.0,
        ibl=default_sky(8, 16), device=dev,
    )
    cam = CameraParams.create(
        position=(0.0, 0.0, 1.0), rotation_deg=(-35.0, 0.0, 0.0), fov_deg=55.0, device=dev
    )
    table = _CORNELL_TABLE.copy()
    table[M_LIGHT, 4] = 2.0  # modest power keeps radiance O(1)
    return geom, MaterialParams.from_table(table, device=dev), env, cam


def make_outdoor_scene(n_cubes: int = 64, seed: int = 7, use_bvh: bool = False,
                       emissive_panel: bool = False, device: DeviceLike = None):
    """A ground plane and a grid of jittered cubes under the procedural
    sky, with sun and IBL: ``12 * n_cubes + 2`` triangles (+2 with
    ``emissive_panel``, a light over the cubes for NEE/MIS)."""
    rng = np.random.default_rng(seed)
    tris = []
    tris += _quad((-40, -40, 0), (40, -40, 0), (40, 40, 0), (-40, 40, 0), M_WHITE)
    if emissive_panel:
        tris += _quad((-3, 8, 6), (3, 8, 6), (3, 14, 6), (-3, 14, 6), M_LIGHT)
    side = int(np.ceil(np.sqrt(n_cubes)))
    for i in range(n_cubes):
        gx, gy = i % side, i // side
        x = (gx - side / 2) * 3.0 + rng.uniform(-0.8, 0.8)
        y = 6.0 + gy * 3.0 + rng.uniform(-0.8, 0.8)
        s = rng.uniform(0.5, 1.4)
        m = [M_WHITE, M_RED, M_GREEN, M_GLOSSY][i % 4]
        tris += _cube((x, y, s / 2), s, m)
    dev = resolve_device(device)
    geom = _pack(tris, use_bvh, dev)
    env = EnvParams.create(
        sun_angles_deg=(35.0, 0.0, 15.0), sun_power=2.0, ibl_power=0.6,
        ibl=default_sky(16, 32), device=dev,
    )
    cam = CameraParams.create(
        position=(0.0, 0.0, 2.0), rotation_deg=(-12.0, 0.0, 0.0), fov_deg=60.0, device=dev
    )
    return geom, cornell_materials(dev), env, cam


def write_scene_files(obj_path: str, geom: GeometryPack, materials: MaterialParams,
                      env: EnvParams, camera: CameraParams, *, resolution: int, spp: int,
                      max_bounce: int) -> str:
    """Save a scene as ``obj_path`` (one ``usemtl`` run per material id,
    in id order, so the loader assigns the same ids) and the ``.ini``
    beside it, with these render settings.  The IBL file named in the ini
    does not exist, so loading falls back to the procedural sky.  Returns
    the ini's path."""
    np_ = lambda x: x.detach().cpu().numpy()
    v = np.stack([np_(geom.v0), np_(geom.v1), np_(geom.v2)], axis=1)  # [T, 3, 3]
    mat = np_(geom.mat)
    table = materials.to_table()
    lines = []
    for t in range(v.shape[0]):
        for k in range(3):
            lines.append("v %r %r %r" % tuple(float(x) for x in v[t, k]))
    for m in range(table.shape[0]):
        lines.append(f"usemtl m{m}")
        for t in np.nonzero(mat == m)[0]:
            lines.append(f"f {3 * t + 1} {3 * t + 2} {3 * t + 3}")
    with open(obj_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")

    sun = np_(env.sun_angles_deg)
    pos, rot = np_(camera.position), np_(camera.rotation_deg)
    params = {
        "sceneFile": obj_path, "resolution": resolution, "spp": spp, "maxBounce": max_bounce,
        "cam_x": pos[0], "cam_y": pos[1], "cam_z": pos[2],
        "cam_rx": rot[0], "cam_ry": rot[1], "cam_rz": rot[2],
        "cam_DOF": float(camera.fov_deg),
        "IBLfile": "IBL/none.jpg", "IBL_Power": float(env.ibl_power),
        "sun_Power": float(env.sun_power), "sun_rx": sun[0], "sun_ry": sun[1], "sun_rz": sun[2],
    }
    for m, row in enumerate(table):
        for field, val in zip(("Type", "Color_R", "Color_G", "Color_B", "roughness", "ior"), row):
            params[f"M_{m}_{field}"] = int(val) if field == "Type" else float(val)
    ini_path = os.path.splitext(obj_path)[0] + ".ini"
    with open(ini_path, "w", encoding="utf-8") as f:
        f.write("".join(f"{k}={float(v) if isinstance(v, np.floating) else v}\n"
                        for k, v in params.items()))
    return ini_path


# --- rays that test a closest hit's tie-breaking ------------------------------


def _host_vertices(geom: GeometryPack) -> np.ndarray:
    return np.stack([geom.v0.detach().cpu().numpy(), geom.v1.detach().cpu().numpy(),
                     geom.v2.detach().cpu().numpy()], axis=1)  # [T, 3, 3]


def shared_edge_rays(geom: GeometryPack, n_origins: int = 8, per_edge: int = 4, seed: int = 0):
    """Rays aimed at points along every edge that two triangles of
    ``geom`` share (a quad's diagonal, the edges where walls or a cube's
    faces meet), from ``n_origins`` random points inside the scene's box
    (numpy seed): each crosses the edge within an ulp or two, where both
    triangles give about the same ``t`` (the closest hit's ties).  Returns
    ``(ray_o, ray_d)`` ``[n_origins * edges * per_edge, 3]`` f32 on the
    pack's device."""
    import torch

    v = _host_vertices(geom)
    owners = {}
    for t in range(v.shape[0]):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((tuple(v[t, a].tolist()), tuple(v[t, b].tolist()))))
            owners.setdefault(key, []).append(t)
    edges = np.asarray([k for k, ts in sorted(owners.items()) if len(ts) > 1], np.float32)
    f = ((np.arange(per_edge, dtype=np.float32) + 0.5) / per_edge)[None, :, None]
    points = (edges[:, None, 0] + f * (edges[:, None, 1] - edges[:, None, 0])).reshape(-1, 3)
    lo, hi = v.reshape(-1, 3).min(0), v.reshape(-1, 3).max(0)
    rng = np.random.default_rng(seed)
    origins = (lo + rng.uniform(0.05, 0.95, (n_origins, 3)) * (hi - lo)).astype(np.float32)
    o = np.repeat(origins, points.shape[0], axis=0)
    d = np.tile(points, (n_origins, 1)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    dev = geom.v0.device
    return torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)


def grazing_rays(geom: GeometryPack, n: int = 512, seed: int = 0):
    """Rays that skim the scene's lowest plane (the ground of
    ``make_outdoor_scene``, z = its least vertex z): origins over the
    footprint of the triangles above it, at heights from 1e-6 to 1e-1
    above the plane (one in eight on it), directions at random azimuths
    that fall by 1e-7 to 1e-2 per unit length (one in eight level).  They
    cross cube faces at their bottom edges and the ground at shallow
    angles, where a closest hit's t loses digits.  Returns ``(ray_o,
    ray_d)`` ``[n, 3]`` f32 on the pack's device (numpy seed)."""
    import torch

    v = _host_vertices(geom).reshape(-1, 3)
    ground = v[:, 2].min()
    above = v[v[:, 2] > ground]
    lo, hi = above.min(0), above.max(0)
    rng = np.random.default_rng(seed)
    o = np.empty((n, 3), np.float64)
    o[:, :2] = rng.uniform(lo[:2], hi[:2], (n, 2))
    o[:, 2] = ground + np.where(rng.random(n) < 0.125, 0.0, 10.0 ** rng.uniform(-6, -1, n))
    phi = rng.uniform(0, 2 * np.pi, n)
    fall = np.where(rng.random(n) < 0.125, 0.0, 10.0 ** rng.uniform(-7, -2, n))
    d = np.stack([np.cos(phi), np.sin(phi), -fall], axis=-1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    dev = geom.v0.device
    return (torch.as_tensor(o.astype(np.float32), device=dev),
            torch.as_tensor(d.astype(np.float32), device=dev))
