"""Port parity, per-ray math: every op against its JAX twin on random
inputs made with numpy.  Tolerance ``atol = rtol = 1e-5``: the two
frameworks order f32 transcendentals and sums differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu.ops import bsdf as jb
from ensem3a_openclraytracer_tpu.ops import camera as jc
from ensem3a_openclraytracer_tpu.ops import envmap as je
from ensem3a_openclraytracer_tpu.ops import geometry as jg
from ensem3a_openclraytracer_tpu.ops import sampling as js
from ensem3a_openclraytracer_tpu_torch.ops import bsdf as tb
from ensem3a_openclraytracer_tpu_torch.ops import camera as tc
from ensem3a_openclraytracer_tpu_torch.ops import envmap as te
from ensem3a_openclraytracer_tpu_torch.ops import geometry as tg
from ensem3a_openclraytracer_tpu_torch.ops import sampling as ts

TOL = dict(atol=1e-5, rtol=1e-5)
N = 2048


def _close(port, ref, name=""):
    port = [port] if isinstance(port, torch.Tensor) else port
    ref = [ref] if not isinstance(ref, (tuple, list)) else ref
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), err_msg=name, **TOL)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _u(rng, *shape):
    return rng.random(size=shape, dtype=np.float64).astype(np.float32)


T = torch.as_tensor
J = jnp.asarray


@pytest.mark.parametrize("hw", [(24, 24), (16, 40)])
def test_camera_rays(hw):
    rng = np.random.default_rng(0)
    pos, rot = rng.normal(size=3).astype(np.float32), (rng.random(3) * 360 - 180).astype(np.float32)
    fov = np.float32(rng.uniform(20, 90))
    o, d = tc.camera_rays(T(pos), T(rot), T(fov), *hw)
    jo, jd = jc.camera_rays(J(pos), J(rot), J(fov), *hw)
    _close([o, d], [jo, jd])


@pytest.mark.parametrize("glass_mode", ["tint", "refract"])
@pytest.mark.parametrize("mtype", [0, 1, 2, 3])
def test_sample_bounce(mtype, glass_mode):
    rng = np.random.default_rng(10 + mtype)
    n = _unit(rng, N)
    in_dir = _unit(rng, N)
    color = _u(rng, N, 3)
    rough = _u(rng, N) * 0.9 + 0.05
    ior = 1.0 + _u(rng, N)
    u1, u2 = _u(rng, N), _u(rng, N)
    mt = np.full((N,), mtype, np.int32)
    args = (mt, color, rough, in_dir, n, u1, u2)
    d, f = tb.sample_bounce(*map(T, args), ior=T(ior), glass_mode=glass_mode)
    jd, jf = jb.sample_bounce(*map(J, args), ior=J(ior), glass_mode=glass_mode)
    _close([d, f], [jd, jf], f"type {mtype} {glass_mode}")


def test_eval_ggx_and_lambert():
    rng = np.random.default_rng(2)
    args = (_u(rng, N, 3), _u(rng, N), _unit(rng, N), _unit(rng, N), _unit(rng, N))
    _close(tb.eval_ggx(*map(T, args)), jb.eval_ggx(*map(J, args)))
    _close(tb.eval_lambert(T(args[0])), jb.eval_lambert(J(args[0])))


@pytest.mark.parametrize("bilinear", [True, False])
def test_sample_ibl(bilinear):
    rng = np.random.default_rng(3)
    ibl = _u(rng, 16, 32, 3)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    _close(te.sample_ibl(T(ibl), T(d), bilinear=bilinear),
           je.sample_ibl(J(ibl), J(d), bilinear=bilinear))
    _close(te.spherical_uv(T(d)), je.spherical_uv(J(d)))


def test_sun_direction_and_euler():
    rng = np.random.default_rng(4)
    for _ in range(8):
        a = (rng.random(3) * 360 - 180).astype(np.float32)
        _close(te.sun_direction(T(a)), je.sun_direction(J(a)))
        _close(tg.euler_xyz_matrix(T(a)), jg.euler_xyz_matrix(J(a)))


def test_moller_trumbore_and_slabs():
    rng = np.random.default_rng(5)
    o = rng.normal(size=(N, 3)).astype(np.float32) * 3
    d = _unit(rng, N)
    v0, v1, v2 = (rng.normal(size=(N, 3)).astype(np.float32) for _ in range(3))
    t, u, v, hit = tg.moller_trumbore(*map(T, (o, d, v0, v1, v2)))
    jt, ju, jv, jhit = jg.moller_trumbore(*map(J, (o, d, v0, v1, v2)))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert hit.any()
    _close([t, u, v], [jt, ju, jv])
    lo, hi = np.minimum(v0, v1), np.maximum(v0, v1)
    _close(tg.ray_aabb(*map(T, (o, d, lo, hi))), jg.ray_aabb(*map(J, (o, d, lo, hi))))
    np.testing.assert_array_equal(tg.aabb_hit(*map(T, (o, d, lo, hi))).numpy(),
                                  np.asarray(jg.aabb_hit(*map(J, (o, d, lo, hi)))))


def test_triangle_sampling_and_hemispheres():
    rng = np.random.default_rng(6)
    v0, v1, v2 = (rng.normal(size=(N, 3)).astype(np.float32) for _ in range(3))
    u1, u2 = _u(rng, N), _u(rng, N)
    _close(tg.sample_point_in_triangle(*map(T, (v0, v1, v2, u1, u2))),
           jg.sample_point_in_triangle(*map(J, (v0, v1, v2, u1, u2))))
    _close(tg.triangle_area(*map(T, (v0, v1, v2))), jg.triangle_area(*map(J, (v0, v1, v2))))
    n = _unit(rng, N)
    rough = _u(rng, N)
    for tf, jf, extra in ((ts.sample_hemisphere_cosine, js.sample_hemisphere_cosine, ()),
                          (ts.sample_hemisphere_uniform, js.sample_hemisphere_uniform, ()),
                          (ts.sample_ggx_half_vector, js.sample_ggx_half_vector, (rough,))):
        _close(tf(*map(T, extra + (n, u1, u2))), jf(*map(J, extra + (n, u1, u2))), tf.__name__)
