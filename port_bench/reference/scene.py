"""The scene as the reference reads it: the raw ``.obj``, ``.ini`` and sky
files that the program's ``Scene.load`` reads too, and everything the
program derives from them worked out again here.

Derived here, as the port derives it (file and line of the port's rule):
the triangle order (Morton order of the centroids,
``scene/scene.py:107-113`` with ``accel/lbvh.py:25-44``), the flat face
normals of an OBJ without ``vn`` (``scene/objloader.py:96-107``,
renormalised in ``scene/scene.py:122-124``), the material table of the
``M_<i>_*`` keys with material ids by ``usemtl`` run, the camera, sun and
IBL settings (``scene/config.py``), the IBL image (PIL, ``/255``; the
procedural sky when the file is missing, ``scene/scene.py:138-150``,
``scene/materials.py:99-106``) and the intersection features
(``ops/closest_hit.py:115-180``).  Nothing is taken from the program.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch


def _expand_bits_10(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0x3FF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
    return v


def morton_order(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Stable argsort of the centroids' 30-bit Morton codes on a 1024^3 grid
    over their bounding box."""
    c = (np.asarray(v0) + np.asarray(v1) + np.asarray(v2)) / 3.0
    lo, hi = c.min(0), c.max(0)
    q = np.clip((c - lo) / np.maximum(hi - lo, 1e-12), 0.0, 0.9999999)
    g = (q * 1024.0).astype(np.uint32)
    codes = ((_expand_bits_10(g[:, 0]) << np.uint64(2)) | (_expand_bits_10(g[:, 1]) << np.uint64(1))
             | _expand_bits_10(g[:, 2]))
    return np.argsort(codes, kind="stable").astype(np.int64)


def default_sky(height: int = 64, width: int = 128) -> np.ndarray:
    """The procedural gradient sky that stands in for a missing IBL file."""
    v = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]
    horizon = np.array([0.8, 0.85, 0.95], np.float32)
    zenith = np.array([0.2, 0.35, 0.7], np.float32)
    img = horizon * (1.0 - v) + zenith * v
    return np.broadcast_to(img, (height, width, 3)).copy()


def read_obj(path: str):
    """``(v0, v1, v2, mat)`` of a triangle OBJ (``v`` and ``f`` lines with
    positive indices, one material id per ``usemtl`` run, 0 before any)."""
    pos, faces = [], []
    mat, seen = 0, False
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                pos.append([float(x) for x in parts[1:4]])
            elif parts[0] == "usemtl":
                mat += 1 if seen else 0
                seen = True
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1], mat))
    p = np.asarray(pos, np.float64)
    fa = np.asarray(faces, np.int64)
    return p[fa[:, 0]], p[fa[:, 1]], p[fa[:, 2]], fa[:, 3]


def read_ini(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return dict(line.rstrip("\n").split("=", 1) for line in f if "=" in line)


@dataclass
class RefScene:
    """A scene on one device, in the program's triangle order."""

    v0: torch.Tensor  # [T, 3] float32
    v1: torch.Tensor
    v2: torch.Tensor
    normal: torch.Tensor  # [T, 3] unit shading normal
    mat: torch.Tensor  # [T] int64
    edges: torch.Tensor  # [3, 6, T] Plucker features [A x B, A - B] of AB, BC, CA
    plane: torch.Tensor  # [4, T] [-n, n.A]
    normal_d: torch.Tensor  # [3, T] n (unnormalised)
    mtype: torch.Tensor  # [M] int64 material type
    color: torch.Tensor  # [M, 3]
    rough: torch.Tensor  # [M] roughness, or emissive power for type 0
    resolution: int
    spp: int
    max_bounce: int
    cam_pos: torch.Tensor  # [3]
    cam_rot: torch.Tensor  # [3] degrees
    fov: torch.Tensor  # [] degrees
    sun_angles: torch.Tensor  # [3] degrees
    sun_power: torch.Tensor  # []
    ibl_power: torch.Tensor  # []
    ibl: torch.Tensor  # [H, W, 3]

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]

    @property
    def sun_enabled(self) -> bool:
        return float(self.sun_power) != 0.0

    def input_bytes(self) -> int:
        """Bytes of the scene as a render reads it once: the triangles (three
        vertices, a normal, a material id), the material table and the IBL."""
        t = self.num_tris
        return t * (4 * 12 + 4) + self.mtype.numel() * 24 + self.ibl.numel() * 4


def load(obj_path: str, device) -> RefScene:
    """The scene of ``obj_path`` and the ``.ini`` beside it."""
    dev = torch.device(device)
    p0, p1, p2, mat = read_obj(obj_path)
    ini = read_ini(obj_path[: -len(".obj")] + ".ini")
    fl = lambda k, d=0.0: float(ini.get(k, d))
    # the loader's flat normal (float64, stored as float32), renormalised in float32
    n = np.cross(p1 - p0, p2 - p0)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(ln > 0, n / np.where(ln > 0, ln, 1.0), np.array([0.0, 0.0, 1.0]))
    n = n.astype(np.float32)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    v0, v1, v2 = (x.astype(np.float32) for x in (p0, p1, p2))
    order = morton_order(v0, v1, v2)
    v0, v1, v2, n, mat = v0[order], v1[order], v2[order], n[order], mat[order]

    def edge(a, b):
        return np.concatenate([np.cross(a, b), a - b], axis=-1).T  # [6, T]

    nrm = np.cross(v1 - v0, v2 - v0)
    plane = np.concatenate([-nrm.T, np.einsum("td,td->t", nrm, v0)[None]], axis=0)
    n_mat = int(mat.max()) + 1
    table = np.asarray([[fl(f"M_{i}_{k}", d) for k, d in
                         (("Type", 1), ("Color_R", 1), ("Color_G", 1), ("Color_B", 1),
                          ("roughness", 0))] for i in range(n_mat)], np.float32)
    ibl_file = ini.get("IBLfile", "")
    sky = default_sky()
    for cand in [ibl_file] + [os.path.join(d, os.path.basename(ibl_file))
                              for d in (os.path.dirname(obj_path), "IBL")]:
        if cand and os.path.exists(cand):
            from PIL import Image

            sky = np.asarray(Image.open(cand).convert("RGB"), np.float32) / 255.0
            break
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    return RefScene(
        v0=t(v0), v1=t(v1), v2=t(v2), normal=t(n), mat=t(mat, torch.int64),
        edges=t(np.stack([edge(v0, v1), edge(v1, v2), edge(v2, v0)])), plane=t(plane),
        normal_d=t(nrm.T),
        mtype=t(np.rint(table[:, 0]), torch.int64), color=t(table[:, 1:4]), rough=t(table[:, 4]),
        resolution=int(fl("resolution", 256)), spp=int(fl("spp", 10)),
        max_bounce=int(fl("maxBounce", 4)),
        cam_pos=t([fl("cam_x"), fl("cam_y"), fl("cam_z")]),
        cam_rot=t([fl("cam_rx"), fl("cam_ry"), fl("cam_rz")]), fov=t(fl("cam_DOF", 45.0)),
        sun_angles=t([fl("sun_rx"), fl("sun_ry"), fl("sun_rz")]),
        sun_power=t(fl("sun_Power", 1.0)), ibl_power=t(fl("IBL_Power", 1.0)), ibl=t(sky),
    )
