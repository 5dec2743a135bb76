"""Wavefront OBJ importer producing the reference's flat-array ABI.

Self-contained replacement for the reference's pywavefront +
manual-reparse pipeline (FileManager.py:253-307): one pass over the file
building ``V_p/V_n/V_uv`` float32 arrays and per-face int32x10 records
``[matId, uvIdx*3, nIdx*3, pIdx*3]`` (SURVEY.md section 2.3,
FileManager.py:276-285).  Material ids are assigned by order of ``usemtl``
occurrence (each run gets the next id, names ignored - matching
FileManager.py:267-285); faces before any ``usemtl`` get id 0.

Improvements over the reference, none changing the ABI:
  * polygon faces are fan-triangulated (the reference silently truncated
    to the first three vertices);
  * negative (relative) OBJ indices are resolved;
  * missing ``vt``/``vn`` entries synthesize a zero uv / the face's
    geometric normal instead of crashing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FACE_CHUNK = 10  # ints per face record (FileManager.py:216)


@dataclass
class ObjMesh:
    """Host-side import result in the reference's buffer layout."""

    v_p: np.ndarray  # [P, 3] float32 vertex positions
    v_n: np.ndarray  # [Nn, 3] float32 normals
    v_uv: np.ndarray  # [Nu, 2] float32 uvs
    face_data: np.ndarray  # [F, 10] int32
    num_materials: int
    material_names: list[str]

    @property
    def num_faces(self) -> int:
        return self.face_data.shape[0]


def _resolve(idx: int, count: int) -> int:
    """OBJ 1-based (possibly negative/relative) index -> 0-based."""
    return idx - 1 if idx > 0 else count + idx


def load_obj(path: str) -> ObjMesh:
    positions: list[tuple] = []
    normals: list[tuple] = []
    uvs: list[tuple] = []
    faces: list[list[int]] = []
    material_names: list[str] = []
    cur_mat = 0
    seen_usemtl = False
    synth_normals: list[tuple] = []  # generated flat normals, appended after file normals
    need_normal_fix: list[int] = []  # face rows whose normal slots hold synth ids (negative)

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v" and len(parts) >= 4:
                positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vn" and len(parts) >= 4:
                normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vt" and len(parts) >= 3:
                uvs.append((float(parts[1]), float(parts[2])))
            elif tag == "usemtl":
                if seen_usemtl:
                    cur_mat += 1
                seen_usemtl = True
                material_names.append(parts[1] if len(parts) > 1 else f"mat{cur_mat}")
            elif tag == "f" and len(parts) >= 4:
                corners = []
                for spec in parts[1:]:
                    comp = spec.split("/")
                    pi = _resolve(int(comp[0]), len(positions))
                    ui = (
                        _resolve(int(comp[1]), len(uvs))
                        if len(comp) > 1 and comp[1]
                        else -1
                    )
                    ni = (
                        _resolve(int(comp[2]), len(normals))
                        if len(comp) > 2 and comp[2]
                        else -1
                    )
                    corners.append((pi, ui, ni))
                # fan triangulation
                for k in range(1, len(corners) - 1):
                    tri = [corners[0], corners[k], corners[k + 1]]
                    if any(c[2] < 0 for c in tri):
                        # synthesize one flat normal for the whole triangle
                        p = [np.asarray(positions[c[0]], np.float64) for c in tri]
                        n = np.cross(p[1] - p[0], p[2] - p[0])
                        ln = np.linalg.norm(n)
                        n = n / ln if ln > 0 else np.array([0.0, 0.0, 1.0])
                        synth_id = -(len(synth_normals) + 1)  # placeholder, fixed below
                        synth_normals.append(tuple(n))
                        tri = [
                            (pi, ui, ni if ni >= 0 else synth_id)
                            for (pi, ui, ni) in tri
                        ]
                        need_normal_fix.append(len(faces))
                    # record: [mat, uv x3, n x3, p x3] (FileManager.py:276-285)
                    row = [cur_mat]
                    row += [max(c[1], 0) for c in tri]
                    row += [c[2] for c in tri]
                    row += [c[0] for c in tri]
                    faces.append(row)

    num_file_normals = len(normals)
    face_data = np.asarray(faces, np.int64).reshape(-1, FACE_CHUNK)
    if need_normal_fix:
        # synth id -k (k >= 1) -> num_file_normals + (k - 1)
        nslots = face_data[:, 4:7]
        neg = nslots < 0
        nslots[neg] = num_file_normals + (-nslots[neg] - 1)
        normals = normals + synth_normals
    if not normals:
        normals = [(0.0, 0.0, 1.0)]
    if not uvs:
        uvs = [(0.0, 0.0)]

    return ObjMesh(
        v_p=np.asarray(positions, np.float32).reshape(-1, 3),
        v_n=np.asarray(normals, np.float32).reshape(-1, 3),
        v_uv=np.asarray(uvs, np.float32).reshape(-1, 2),
        face_data=face_data.astype(np.int32),
        num_materials=max(1, cur_mat + 1),
        material_names=material_names,
    )
