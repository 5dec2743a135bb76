"""The port's small modules against the JAX package's: ``ops/tonemap``
(every mode), ``ops/geometry.rotate_axis_angle``,
``ops/camera.focal_distance`` (and ``camera_rays``, which now calls it),
``utils/profiling`` (``rays_per_render``, ``StageTimer``,
``torch_trace``), ``version`` and ``scene.__all__``.
Inputs are numpy draws; float results agree to 1e-6."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ensem3a_openclraytracer_tpu as jpkg
import ensem3a_openclraytracer_tpu.scene as jscene
import ensem3a_openclraytracer_tpu_torch as tpkg
import ensem3a_openclraytracer_tpu_torch.scene as tscene
from ensem3a_openclraytracer_tpu.ops import camera as jcam
from ensem3a_openclraytracer_tpu.ops import geometry as jgeo
from ensem3a_openclraytracer_tpu.ops import tonemap as jtone
from ensem3a_openclraytracer_tpu.utils import profiling as jprof
from ensem3a_openclraytracer_tpu_torch.ops import camera as tcam
from ensem3a_openclraytracer_tpu_torch.ops import geometry as tgeo
from ensem3a_openclraytracer_tpu_torch.ops import tonemap as ttone
from ensem3a_openclraytracer_tpu_torch.utils import profiling as tprof

TOL = 1e-6


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.fixture()
def img():
    # radiance beyond [0, 1] on both sides, so the clamp bites
    return np.random.default_rng(3).uniform(-0.5, 2.0, (8, 9, 3)).astype(np.float32)


@pytest.mark.parametrize("mode", ["clamp", "gamma", "reference_gamma"])
def test_postprocess_matches_jax(img, mode):
    _close(ttone.postprocess(torch.as_tensor(img), mode=mode),
           jtone.postprocess(jnp.asarray(img), mode=mode))


@pytest.mark.parametrize("name", ["clamp01", "gamma_encode", "reference_imgprocess"])
def test_tonemap_functions_match_jax(img, name):
    _close(getattr(ttone, name)(torch.as_tensor(img)), getattr(jtone, name)(jnp.asarray(img)))


def test_postprocess_unknown_mode_raises(img):
    with pytest.raises(ValueError, match="unknown postprocess mode"):
        ttone.postprocess(torch.as_tensor(img), mode="filmic")


def test_rotate_axis_angle_matches_jax():
    rng = np.random.default_rng(5)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    axis = rng.normal(size=(64, 3)).astype(np.float32)  # not unit: normalized inside
    angle = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    got = tgeo.rotate_axis_angle(torch.as_tensor(v), torch.as_tensor(axis), torch.as_tensor(angle))
    _close(got, jgeo.rotate_axis_angle(jnp.asarray(v), jnp.asarray(axis), jnp.asarray(angle)),
           1e-5)
    # a rotation keeps lengths
    _close(torch.linalg.norm(got, dim=-1), np.linalg.norm(v, axis=-1), 1e-5)


@pytest.mark.parametrize("fov_deg", [10.0, 50.0, 90.0, 120.0])
def test_focal_distance_matches_jax(fov_deg):
    rad = np.float32(fov_deg * np.pi / 180.0)
    _close(tcam.focal_distance(torch.tensor(rad)), jcam.focal_distance(rad))
    _close(tcam.focal_distance(float(rad)), jcam.focal_distance(float(rad)))


def test_camera_rays_match_jax():
    pos, rot, fov = (0.5, -1.0, 2.0), (-12.0, 5.0, 30.0), 60.0
    o, d = tcam.camera_rays(torch.tensor(pos), torch.tensor(rot), torch.tensor(fov), 6, 10)
    jo, jd = jcam.camera_rays(jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(fov), 6, 10)
    _close(o, jo)
    _close(d, jd)


@pytest.mark.parametrize("res,spp,mb,sun", [(512, 100, 4, False), (64, 3, 2, True)])
def test_rays_per_render_matches_jax(res, spp, mb, sun):
    assert tprof.rays_per_render(res, spp, mb, sun) == jprof.rays_per_render(res, spp, mb, sun)


def test_stage_timer_accumulates():
    timer = tprof.StageTimer()
    for _ in range(2):
        with timer.stage("a", sync=torch.zeros(1)):  # a CPU tensor: nothing to wait for
            pass
    with timer.stage("b", sync=torch.device("cpu")):
        pass
    s = timer.summary()
    assert s["a"]["calls"] == 2 and s["b"]["calls"] == 1
    assert json.loads(timer.report()) == s


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with tprof.torch_trace(None):  # a no-op
        pass
    out = str(tmp_path / "prof")
    with tprof.torch_trace(out):
        torch.ones(64).sum()
    with open(os.path.join(out, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_version_and_scene_exports_match_jax():
    assert tpkg.__version__ == jpkg.__version__ == "0.1.0"
    assert tscene.__all__ == jscene.__all__
    assert all(hasattr(tscene, name) for name in tscene.__all__)


@pytest.mark.parametrize("module", ["cli", "models.progressive", "parallel.distributed",
                                    "parallel.mesh", "parallel.render", "utils.profiling"])
def test_new_module_imports_alone(module):
    """Each new module imports first in a fresh interpreter (no import
    cycle through ``models/__init__``)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-c", f"import ensem3a_openclraytracer_tpu_torch.{module}"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert run.returncode == 0, run.stderr
