"""Port parity, host pipeline: packed geometry, features, light packs and
scene import equal the JAX package's exactly."""

import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (kept on the CPU by conftest)
import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu import testing as jt
from ensem3a_openclraytracer_tpu.scene.scene import Scene as JScene
from ensem3a_openclraytracer_tpu.scene.scene import build_light_pack as j_light_pack
from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.scene import objloader
from ensem3a_openclraytracer_tpu_torch.scene.objloader import load_obj
from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene, build_light_pack, pack_geometry

PORT = Path(__file__).resolve().parent.parent / "ensem3a_openclraytracer_tpu_torch"

SCENES = {
    "cornell": (lambda: jt.make_cornell_scene(use_bvh=False),
                lambda: tt.make_cornell_scene(device="cpu")),
    "glass_light": (lambda: jt.make_glass_light_scene(use_bvh=False),
                    lambda: tt.make_glass_light_scene(device="cpu")),
    "outdoor16": (lambda: jt.make_outdoor_scene(n_cubes=16, use_bvh=False),
                  lambda: tt.make_outdoor_scene(n_cubes=16, device="cpu")),
    "outdoor_panel": (lambda: jt.make_outdoor_scene(n_cubes=30, use_bvh=False, emissive_panel=True),
                      lambda: tt.make_outdoor_scene(n_cubes=30, emissive_panel=True, device="cpu")),
}


def _eq(a, b, name):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_geometry_equal(port, jax_geom):
    for f in ("v0", "v1", "v2", "n", "uv", "mat"):
        _eq(getattr(port, f), getattr(jax_geom, f), f)
    for f in ("edges", "plane", "normal_d", "block_bounds"):
        _eq(getattr(port.feats, f), getattr(jax_geom.feats, f), "feats." + f)
    assert port.feats.num_tris == jax_geom.feats.num_tris


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pack_and_lights_equal_jax(name):
    jmk, tmk = SCENES[name]
    jg, jm, je, jc = jmk()
    g, m, e, c = tmk()
    _assert_geometry_equal(g, jg)
    for f in ("mtype", "color", "roughness", "ior"):
        _eq(getattr(m, f), getattr(jm, f), "materials." + f)
    for f in ("sun_angles_deg", "sun_power", "ibl_power", "ibl"):
        _eq(getattr(e, f), getattr(je, f), "env." + f)
    for f in ("position", "rotation_deg", "fov_deg"):
        _eq(getattr(c, f), getattr(jc, f), "camera." + f)
    jl, lp = j_light_pack(jg, jm), build_light_pack(g, m)
    assert (jl is None) == (lp is None)
    if jl is not None:
        for f in lp._fields:
            _eq(getattr(lp, f), getattr(jl, f), "lights." + f)


def _write_obj(path):
    path.write_text(
        "v 0 0 0\nv 2 0 0\nv 2 2 0\nv 0 2 0\nv 0 0 3\nv 2 0 3\nv 1 1 5\n"
        "vn 0 0 1\nvt 0.5 0.5\n"
        "usemtl floor\nf 1//1 2//1 3//1 4//1\n"
        "usemtl lamp\nf 5 6 7\n"
        "usemtl wall\nf -7 -6 -2\n"
    )


def test_scene_load_equals_jax(tmp_path):
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
        _write_obj(tmp_path / sub / "tiny.obj")
        (tmp_path / sub / "tiny.ini").write_text(
            "resolution=16\nspp=3\nmaxBounce=2\ncam_y=-4\ncam_z=1\ncam_DOF=50\n"
            "IBLfile=none.jpg\nIBL_Power=0.5\nsun_Power=1.5\nsun_rx=20\n"
            "M_0_Type=1\nM_0_Color_R=0.7\nM_1_Type=0\nM_1_roughness=4\n"
            "M_2_Type=3\nM_2_ior=1.4\n"
        )
    js = JScene.load(str(tmp_path / "jax" / "tiny.obj"), use_bvh=False)
    ps = Scene.load(str(tmp_path / "port" / "tiny.obj"), device="cpu")
    jm = load_obj(str(tmp_path / "jax" / "tiny.obj"))
    for f in ("v_p", "v_n", "v_uv", "face_data"):
        _eq(getattr(ps.mesh, f), getattr(js.mesh, f), "mesh." + f)
        _eq(getattr(jm, f), getattr(js.mesh, f), "load_obj." + f)
    assert ps.mesh.num_materials == js.mesh.num_materials == 3
    _eq(ps.material_table, js.material_table, "material_table")
    _eq(ps.light_faces, js.light_faces, "light_faces")
    _assert_geometry_equal(ps.geometry, js.geometry)
    from dataclasses import astuple

    for acc in ("render_settings", "camera_settings", "environment_settings"):
        assert astuple(getattr(ps.config, acc)()) == astuple(getattr(js.config, acc)()), acc
    for pe, je in ((ps.env_params(), js.env_params()), (ps.camera_params(), js.camera_params()),
                   (ps.material_params(), js.material_params())):
        for f in pe._fields:
            _eq(getattr(pe, f), getattr(je, f), f)
    pl, jl = ps.light_pack(), js.light_pack()
    for f in pl._fields:
        _eq(getattr(pl, f), getattr(jl, f), "light_pack." + f)
    assert ps.num_tris == js.num_tris


def test_written_scene_round_trips(tmp_path):
    g, m, e, c = tt.make_outdoor_scene(n_cubes=5, device="cpu")
    obj = str(tmp_path / "outdoor.obj")
    tt.write_scene_files(obj, g, m, e, c, resolution=8, spp=2, max_bounce=1)
    s = Scene.load(obj, device="cpu")
    for f in ("v0", "v1", "v2", "mat"):
        _eq(getattr(s.geometry, f), getattr(g, f), f)
    _eq(s.material_table, m.to_table(), "material_table")
    cam = s.camera_params()
    for f in cam._fields:
        _eq(getattr(cam, f), getattr(c, f), f)
    assert s.config.render_settings().spp == 2


def _same_mesh(a, b):
    for f in ("v_p", "v_n", "v_uv", "face_data"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f
    assert a.num_materials == b.num_materials and a.material_names == b.material_names


def _bench_obj(directory, config, n_cubes=None):
    """The OBJ that ``port_bench/scenes/files.write_scene`` writes for the
    benchmark's configuration ``config`` (its sky left out), at ``n_cubes``."""
    import json

    sys.path.insert(0, str(PORT.parent))
    from port_bench.scenes import files

    cfg = json.loads((PORT.parent / "port_bench" / "configs" / f"{config}.json").read_text())
    cfg.pop("sky", None)
    if n_cubes is not None:
        cfg["params"]["n_cubes"] = n_cubes
    return files.write_scene(cfg, 2147483659, str(directory), "cpu")


def _testing_obj(directory, name):
    g, m, e, c = SCENES[name][1]()
    obj = str(directory / f"{name}.obj")
    tt.write_scene_files(obj, g, m, e, c, resolution=8, spp=1, max_bounce=1)
    return obj


OBJS = {  # name -> writer(directory) of an OBJ the array parser takes
    "bench_outdoor": lambda d: _bench_obj(d, "outdoor600k", n_cubes=40),
    "bench_closedbox": lambda d: _bench_obj(d, "closedbox15k"),
    **{f"testing_{n}": (lambda d, n=n: _testing_obj(d, n)) for n in sorted(SCENES)},
}


@pytest.mark.parametrize("name", sorted(OBJS))
def test_array_parser_equals_the_per_line_parser(tmp_path, name):
    """The benchmark's and ``testing.py``'s OBJ files (triangles, positive
    indices, one ``usemtl`` run a material) go through the array parser,
    which gives the per-line parser's mesh bit for bit."""
    obj = OBJS[name](tmp_path)
    text = Path(obj).read_text()
    arrays = objloader._load_arrays(text)
    assert arrays is not None and arrays.num_faces > 0
    _same_mesh(arrays, objloader.load_obj_lines(obj))
    _same_mesh(load_obj(obj), arrays)


CORNERS = {  # a face form -> the unit square's two triangles, with vt and vn lines
    "p": "f 1 2 3\nf 1 3 4\n",
    "p/t": "f 1/1 2/2 3/3\nf 1/1 3/3 4/4\n",
    "p//n": "f 1//1 2//1 3//2\nf 1//2 3//2 4//1\n",
    "p/t/n": "f 1/1/1 2/2/1 3/3/2\nf 1/1/2 3/3/2 4/4/1\n",
}
HEAD = ("# a unit square\nmtllib x.mtl\no square\nv 0 0 0\nv 1 0 0\nv 1 1 0.5\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\nvn 0.6 0 0.8\ns off\n")


@pytest.mark.parametrize("form", sorted(CORNERS))
def test_array_parser_takes_each_face_form(tmp_path, form):
    """Triangles of each corner form, with comments, ignored tags, a
    ``usemtl`` without a name and a degenerate face, parse bit for bit as
    the per-line parser reads them."""
    body = CORNERS[form].replace("f 1", "usemtl\nf 1", 1)
    degenerate = {"p": "f 1 1 2\n", "p/t": "f 1/1 1/1 2/2\n", "p//n": "f 1//1 1//1 2//1\n",
                  "p/t/n": "f 1/1/1 1/1/1 2/2/1\n"}[form]
    (tmp_path / "a.obj").write_text(HEAD + "usemtl red\n" + body + "usemtl\n" + degenerate)
    text = (tmp_path / "a.obj").read_text()
    arrays = objloader._load_arrays(text)
    assert arrays is not None and arrays.num_faces == 3
    lines = objloader.load_obj_lines(str(tmp_path / "a.obj"))
    _same_mesh(arrays, lines)
    assert lines.material_names == ["red", "mat1", "mat2"]


@pytest.mark.parametrize("extra", ["polygon", "negative", "mixed_forms", "vt_with_w",
                                   "v_with_w", "indented", "zero_index"])
def test_files_the_array_parser_declines_parse_as_before(tmp_path, extra):
    """Polygons, negative indices, corners of mixed forms (a ``vn`` missing
    from some), extra coordinates and tags after blanks go to the per-line
    parser, which ``load_obj`` gives unchanged."""
    body = {
        "polygon": HEAD + "f 1 2 3 4\n",
        "negative": HEAD + "f -4 -3 -2\nf 1 3 4\n",
        "mixed_forms": HEAD + "f 1//1 2//1 3//1\nf 1 3 4\n",
        "vt_with_w": HEAD + "vt 0.5 0.5 0\nf 1/1 2/2 3/5\n",
        "v_with_w": HEAD + "v 2 2 2 1\nf 1 2 5\n",
        "indented": HEAD + "  v 3 3 3\nf 1 2 5\n",
        "zero_index": HEAD.replace("v 0 0 0\n", "") + "f 1 2 3\nf 0 1 2\n",
    }[extra]
    (tmp_path / "a.obj").write_text(body)
    assert objloader._load_arrays(body) is None
    try:
        want = objloader.load_obj_lines(str(tmp_path / "a.obj"))
    except IndexError:  # an index the file does not hold
        return
    _same_mesh(load_obj(str(tmp_path / "a.obj")), want)


def test_flat_normals_take_the_norm_of_np_linalg():
    """The array parser's face normals are the per-line parser's: each
    norm equals ``np.linalg.norm`` of its row bit for bit, and a degenerate
    face gets ``(0, 0, 1)``."""
    rng = np.random.default_rng(5)
    p = rng.normal(size=(3000, 3)) * rng.uniform(0.01, 100.0, (3000, 1))
    tri = rng.integers(0, 3000, (4000, 3))
    tri[0] = [7, 7, 8]
    got = objloader.flat_normals(p, tri)
    for k in range(tri.shape[0]):
        a, b, c = p[tri[k]]
        n = np.cross(b - a, c - a)
        ln = np.linalg.norm(n)
        want = n / ln if ln > 0 else np.array([0.0, 0.0, 1.0])
        assert got[k].tobytes() == want.tobytes(), k


def test_bvh_gives_tree_only_packs_and_fused_refuses_them():
    """``use_bvh=True`` gives a tree-only pack, as the JAX package's does:
    no features, a tree of ``2T - 1`` nodes that ``validate_bvh`` passes.
    The fused engine refuses a pack without features, as JAX's does."""
    from ensem3a_openclraytracer_tpu_torch.accel import validate_bvh
    from ensem3a_openclraytracer_tpu_torch.scene.objloader import ObjMesh

    mesh_geom = tt.make_cornell_scene(device="cpu")[0]
    assert mesh_geom.feats is not None and mesh_geom.bvh is None
    tree_geom = tt.make_cornell_scene(use_bvh=True, device="cpu")[0]
    t = tree_geom.v0.shape[0]
    assert tree_geom.feats is None and tree_geom.bvh.tri.shape == (2 * t - 1,)
    assert validate_bvh(tree_geom.bvh, t)["leaves"] == t
    for f in ("v0", "v1", "v2", "n", "uv", "mat"):
        _eq(getattr(tree_geom, f), getattr(mesh_geom, f), f)

    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    fd = np.zeros((2, 10), np.int32)
    fd[:, 7:10] = [[0, 1, 2], [1, 3, 2]]
    mesh = ObjMesh(v, np.zeros((1, 3), np.float32), np.zeros((1, 2), np.float32), fd, 1, [])
    packed = pack_geometry(mesh, use_bvh=True, device="cpu")
    assert packed.feats is None and packed.bvh.tri.shape == (3,)
    assert validate_bvh(packed.bvh, 2)["max_depth"] == 1
    assert pack_geometry(mesh, device="cpu").bvh is None
    from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance

    # the fused engine is ported; it refuses what the JAX package's refuses
    with pytest.raises(ValueError, match="fused=True"):
        render_radiance(tree_geom, *tt.make_cornell_scene(device="cpu")[1:],
                        height=2, width=2, spp=1, max_bounce=0, fused=True)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.make_cornell_scene()


def test_port_imports_without_jax():
    """A fresh interpreter imports every module of the port without JAX."""
    mods = sorted(
        "ensem3a_openclraytracer_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    port_mods = ("models.pathtracer", "models.replay", "models.optimize", "ops.closest_hit",
                 "ops.fused", "ops.gathers", "ops.pairs", "ops.rng", "convert", "_build",
                 "experiments.common", "experiments.proto_grouped",
                 "experiments.proto_compact", "cli", "__main__", "models.progressive",
                 "ops.tonemap", "parallel.distributed", "parallel.mesh", "parallel.render",
                 "utils.profiling", "version")
    assert {"ensem3a_openclraytracer_tpu_torch." + m for m in port_mods} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] in ('ensem3a_openclraytracer_tpu', 'experiments')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(PORT.parent), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr


def test_port_sources_never_name_the_jax_package():
    pat = ("import ensem3a_openclraytracer_tpu\n", "import ensem3a_openclraytracer_tpu.",
           "from ensem3a_openclraytracer_tpu ", "from ensem3a_openclraytracer_tpu.", "import jax",
           "from experiments", "import experiments")
    files = list(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    for p in files:
        text = p.read_text()
        for s in pat:
            assert s not in text, f"{p} contains {s!r}"
