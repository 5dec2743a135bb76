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

Two parsers give the same ``ObjMesh``, array for array and bit for bit.
:func:`load_obj` decides once per file which one reads it: the array
parser takes a file whose ``v`` and ``vn`` lines hold three numbers, whose
``vt`` lines hold two, and whose ``f`` lines are triangles of positive
indices, every corner of one form (``p``, ``p/t``, ``p//n`` or ``p/t/n``)
and one space apart, each tag at the start of its line; comments, blank
lines, ``usemtl`` and tags the loader ignores may lie anywhere.  That is
what exporters, ``testing.py`` and ``port_bench/scenes/files.py`` write,
and it parses in runs of lines and array operations (~3 s for 600,002
triangles, ~34 s line by line).  Any other file (polygons, negative
indices, corners of mixed forms, extra coordinates, tags after blanks) goes
to the per-line parser, :func:`load_obj_lines`, which reads every file the
loader accepts.
"""

from __future__ import annotations

import re
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


def load_obj_lines(path: str) -> ObjMesh:
    """The per-line parser: any file the loader accepts."""
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


# A face line of each form with its indices' digits taken out: "f", then
# three corners, one blank before each.
_SKELETON = {0: "f   \n", 1: "f / / /\n", 2: "f // // //\n", 3: "f // // //\n"}
_WIDTH = (1, 2, 2, 3)  # indices a corner of each form
_NO_DIGITS = str.maketrans("", "", "0123456789")
_TAGS = ("v", "vn", "vt", "f", "usemtl")
# the newline that ends a run of consecutive lines of one tag
_RUN_END = {t: re.compile(rf"\n(?!{t}[ \t])") for t in ("v", "vn", "vt", "f")}
_STRIP = str.maketrans({"f": " ", "/": " "})  # a face line's indices, space-separated


def _form(corner: str) -> int:
    """0 for ``p``, 1 for ``p/t``, 2 for ``p//n``, 3 for ``p/t/n``."""
    comp = corner.split("/")
    return 0 if len(comp) == 1 else 1 if len(comp) == 2 else 2 if not comp[1] else 3


def _tag_at(text: str, pos: int):
    """The tag of the line at ``pos`` where it is ``v``, ``vn``, ``vt`` or
    ``f`` followed by a blank, else None."""
    head = text[pos:pos + 3]
    if head[1:2] in (" ", "\t") and head[:1] in ("v", "f"):
        return head[:1]
    if head[:2] in ("vn", "vt") and head[2:3] in (" ", "\t"):
        return head[:2]
    return None


def _numbers(runs: list, tag: str, width: int) -> np.ndarray | None:
    """``[lines, width]`` float64 of the lines ``tag x_1 .. x_width`` in
    ``runs``, or None where a line holds another count.  Each distinct line
    is parsed once (a vertex shared by several triangles is often written
    for each)."""
    lines = "".join(runs).split("\n")
    lines.pop()  # each line ends in a newline
    uniq = dict.fromkeys(lines)
    tokens = " ".join(uniq).split()
    step = width + 1
    if len(tokens) != step * len(uniq) or tokens[0::step].count(tag) != len(uniq):
        return None
    del tokens[0::step]
    try:
        values = np.array(tokens, np.float64).reshape(-1, width)
    except ValueError:  # a number only Python's float() reads
        return None
    if len(uniq) == len(lines):
        return values
    index = dict(zip(uniq, range(len(uniq))))
    return values[np.fromiter(map(index.__getitem__, lines), np.int64, count=len(lines))]


def flat_normals(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Unit geometric normals ``[F, 3]`` float64 of triangles ``tri [F, 3]``
    of positions ``p`` (float64), as the per-line parser makes one for a
    face without ``vn``: the norm is ``np.linalg.norm``'s (a BLAS dot, which
    a batch of one-by-one products also takes), ``(0, 0, 1)`` for a
    degenerate face."""
    a, b, c = p[tri[:, 0]], p[tri[:, 1]], p[tri[:, 2]]
    n = np.cross(b - a, c - a)
    ln = np.sqrt((n[:, None, :] @ n[:, :, None])[:, 0, 0])
    safe = np.where(ln > 0, ln, 1.0)[:, None]
    return np.where((ln > 0)[:, None], n / safe, np.array([0.0, 0.0, 1.0]))


def _load_arrays(text: str) -> ObjMesh | None:
    """The array parser (module docstring); None for a file it does not take."""
    if not text.endswith("\n"):
        text += "\n"
    runs = {t: [] for t in _RUN_END}  # each tag's runs of lines
    mtl = []  # (faces before it, name) of each usemtl
    faces, pos = 0, 0
    while pos < len(text):
        tag = _tag_at(text, pos)
        if tag is not None:
            end = _RUN_END[tag].search(text, pos).end()
            runs[tag].append(text[pos:end])
            faces += text.count("\n", pos, end) if tag == "f" else 0
            pos = end
            continue
        end = text.index("\n", pos)
        line, pos = text[pos:end], end + 1
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        if parts[0] == "usemtl" and line.startswith("usemtl"):
            mtl.append((faces, parts[1] if len(parts) > 1 else None))
        elif parts[0] in _TAGS:
            return None  # a tag after leading blanks
    if not faces:
        return None
    body = "".join(runs["f"])
    form = _form(body.split(None, 2)[1])
    if body.translate(_NO_DIGITS) != _SKELETON[form] * faces:
        return None  # another layout: tabs, more blanks, other corners or characters
    tokens = body.translate(_STRIP).split()
    if len(tokens) != 3 * _WIDTH[form] * faces:
        return None  # a corner with an index left out
    idx = np.array(tokens, np.int64).reshape(faces, 3, _WIDTH[form])
    if not (idx > 0).all():
        return None
    idx -= 1
    arrays = {}
    for tag, width in (("v", 3), ("vn", 3), ("vt", 2)):
        arrays[tag] = _numbers(runs[tag], tag, width) if runs[tag] else np.zeros((0, width))
        if arrays[tag] is None:
            return None
    p, f = arrays["v"], faces
    pi = idx[:, :, 0]
    ui = idx[:, :, 1] if form in (1, 3) else np.zeros((f, 3), np.int64)
    normals = arrays["vn"]
    if form in (2, 3):
        ni = idx[:, :, -1]
    else:  # one flat normal a face, after the file's normals
        ni = np.repeat(len(normals) + np.arange(f, dtype=np.int64)[:, None], 3, axis=1)
        normals = np.concatenate([normals, flat_normals(p, pi)])
    if len(normals) == 0:
        normals = np.array([[0.0, 0.0, 1.0]])
    uvs = arrays["vt"] if len(arrays["vt"]) else np.zeros((1, 2))
    # face k's material: the usemtl runs before it, less the first
    mat = np.zeros(f, np.int64)
    for at, _ in mtl[1:]:
        mat[at:] += 1
    names = [name if name is not None else f"mat{k}" for k, (_, name) in enumerate(mtl)]
    face_data = np.concatenate([mat[:, None], ui, ni, pi], axis=1)
    return ObjMesh(
        v_p=p.astype(np.float32),
        v_n=normals.astype(np.float32),
        v_uv=uvs.astype(np.float32),
        face_data=face_data.astype(np.int32),
        num_materials=max(1, len(mtl)),
        material_names=names,
    )


def load_obj(path: str) -> ObjMesh:
    """The mesh of the OBJ file ``path``: by the array parser where it
    takes the file, else by the per-line parser (module docstring)."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        text = f.read()
    mesh = _load_arrays(text)
    return mesh if mesh is not None else load_obj_lines(path)
