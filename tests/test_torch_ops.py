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


def test_rounded_dot_and_cross_equal_numpy_float32():
    """``dot_rn`` and ``cross_rn`` round each product, sum and difference on
    its own, in the order the CUDA kernels use: bit-equal to numpy's
    float32 ``(a0*b0 + a1*b1) + a2*b2`` and ``a1*b2 - a2*b1, ...``, with
    magnitudes spread over 2^-20..2^20 so that the order of the sums shows."""
    rng = np.random.default_rng(11)
    a, b = (rng.normal(size=(N, 3)) * 2.0 ** rng.integers(-20, 21, size=(N, 3))
            for _ in range(2))
    a, b = a.astype(np.float32), b.astype(np.float32)
    want_dot = (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]
    want_cross = np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                           a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                           a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], axis=-1)
    assert want_dot.dtype == want_cross.dtype == np.float32
    got_dot = tg.dot_rn(T(a), T(b)).numpy()
    np.testing.assert_array_equal(got_dot.view(np.int32), want_dot.view(np.int32))
    got_cross = tg.cross_rn(T(a), T(b)).numpy()
    np.testing.assert_array_equal(got_cross.view(np.int32), want_cross.view(np.int32))
    # the order matters on these inputs: another order of the sum gives other bits
    other = a[:, 0] * b[:, 0] + (a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2])
    assert (other.view(np.int32) != want_dot.view(np.int32)).any()


def _sampling_draws():
    """``(v0, v1, v2, u1, u2, n, rough)`` of the sampling test (numpy seed 6)."""
    rng = np.random.default_rng(6)
    v0, v1, v2 = (rng.normal(size=(N, 3)).astype(np.float32) for _ in range(3))
    u1, u2 = _u(rng, N), _u(rng, N)
    return v0, v1, v2, u1, u2, _unit(rng, N), _u(rng, N)


def _ndf_tolerance(h_port, h_ref, n, rough, d_ref):
    """Per-element bound on ``|d_ndf(port) - d_ndf(JAX)|``.  d_ndf = a^2 /
    (pi (1 - c^2 (1 - a^2))^2) multiplies the relative error of c = n.h by
    cond = 4 c^2 (1 - a^2) / (1 - c^2 (1 - a^2)), so the bound is twice the
    relative gap of c between the two half vectors, plus 2 ulp, times cond
    (never tighter than ``atol = rtol = 1e-5``)."""
    c = np.clip(np.sum(h_ref * n, axis=-1), 0.0, None)
    c_port = np.clip(np.sum(h_port.astype(np.float64) * n, axis=-1), 0.0, None)
    gap = np.abs(c_port - c) / np.maximum(c, 1e-30)
    a2 = rough.astype(np.float64) ** 2
    cond = 4 * c * c * (1 - a2) / (1 - c * c * (1 - a2))
    return 1e-5 + np.maximum(1e-5, 2 * cond * (gap + 2 * 2.0 ** -24)) * np.abs(d_ref)


def test_triangle_sampling_and_hemispheres():
    v0, v1, v2, u1, u2, n, rough = _sampling_draws()
    _close(tg.sample_point_in_triangle(*map(T, (v0, v1, v2, u1, u2))),
           jg.sample_point_in_triangle(*map(J, (v0, v1, v2, u1, u2))))
    _close(tg.triangle_area(*map(T, (v0, v1, v2))), jg.triangle_area(*map(J, (v0, v1, v2))))
    for tf, jf, extra in ((ts.sample_hemisphere_cosine, js.sample_hemisphere_cosine, ()),
                          (ts.sample_hemisphere_uniform, js.sample_hemisphere_uniform, ()),
                          (ts.sample_ggx_half_vector, js.sample_ggx_half_vector, (rough,))):
        port, ref = tf(*map(T, extra + (n, u1, u2))), jf(*map(J, extra + (n, u1, u2)))
        if tf is ts.sample_ggx_half_vector:
            # sin = sqrt(1 - cos^2) near cos = 1 turns one ulp of cos into ~1e-4 of sin
            h_ref, d_ref = np.asarray(ref[0]), np.asarray(ref[1])
            np.testing.assert_allclose(port[0].numpy(), h_ref, atol=1e-4, rtol=1e-5,
                                       err_msg=tf.__name__)
            tol = _ndf_tolerance(port[0].numpy(), h_ref, n, rough, d_ref)
            assert np.all(np.abs(port[1].numpy() - d_ref) <= tol), tf.__name__
            continue
        _close(port, ref, tf.__name__)


if __name__ == "__main__":
    # The reading behind the d_ndf bound (run on the CPU:
    # JAX_PLATFORMS=cpu python tests/test_torch_ops.py)
    _, _, _, u1, u2, n, rough = _sampling_draws()
    h, d = (x.numpy() for x in ts.sample_ggx_half_vector(*map(T, (rough, n, u1, u2))))
    h_ref, d_ref = (np.asarray(x) for x in js.sample_ggx_half_vector(*map(J, (rough, n, u1, u2))))
    err, mag = np.abs(d - d_ref), np.abs(d_ref)
    plain_tol = 1e-5 + 1e-5 * mag
    tol = _ndf_tolerance(h, h_ref, n, rough, d_ref)
    allow = (tol - 1e-5) / mag  # relative allowance, 1e-5 at the plain tolerance
    worst = int(np.argmax(err / mag))
    print(f"half vector: max |diff| {np.abs(h - h_ref).max():.3e}, "
          f"{int((np.abs(h - h_ref) > 1e-5 + 1e-5 * np.abs(h_ref)).sum())} of {h.size} outside 1e-5")
    print(f"d_ndf at atol = rtol = 1e-5: {int((err > plain_tol).sum())} of {N} outside; max "
          f"relative error {err[worst] / mag[worst]:.4g} (roughness {rough[worst]:.4g}), max "
          f"|diff| {err.max():.4g}")
    print(f"conditioned bound: relative allowance median {np.median(allow):.3g}, 99th percentile "
          f"{np.percentile(allow, 99):.3g}, max {allow.max():.3g}; {int((allow > 1e-4).sum())} of "
          f"{N} above 1e-4; largest error / bound {(err / tol).max():.3f}")
