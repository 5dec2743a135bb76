"""Parity of the port's path-replay engine (``models/replay.py``) with the
JAX package's: records, primal and gradients on the same scenes and the
same explicit uniform streams (bounds in ``tests/test_torch_replay.py``,
whose scenes and helpers these tests share)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu.models import replay as jrp
from ensem3a_openclraytracer_tpu.ops.camera import camera_rays as j_camera_rays
from ensem3a_openclraytracer_tpu_torch.models import replay as rp
from test_torch_replay import (  # noqa: F401  (one_torch_thread: a fixture)
    CASES,
    FIELDS,
    MB,
    RECORD_CASES,
    RES,
    SPP,
    Case,
    _forks,
    _port_grads,
    _rel,
    one_torch_thread,
)


@pytest.mark.parametrize("name", sorted(RECORD_CASES))
def test_recorder_matches_jax(name):
    cs = Case(name)
    jg, jm, je, jc = cs.j
    jo, jd = j_camera_rays(jc.position, jc.rotation_deg, jc.fov_deg, RES, RES)
    ref = jrp.record_paths(
        jg, jm, je, jo, jd, None, spp=SPP, max_bounce=MB, sun_enabled=cs.sun,
        uniforms=jnp.asarray(cs.u), glass_mode=cs.glass_mode, fused=False, nee=cs.nee,
        lights=cs.jl, light_uniforms=None if cs.lu is None else jnp.asarray(cs.lu))
    g, m, e, _ = cs.t
    o, d = cs.rays()
    rec = rp.record_paths(
        g, m, e, o, d, spp=SPP, max_bounce=MB, sun_enabled=cs.sun,
        uniforms=torch.as_tensor(cs.u), glass_mode=cs.glass_mode, fused=False, nee=cs.nee,
        lights=cs.lights, light_uniforms=None if cs.lu is None else torch.as_tensor(cs.lu))
    np.testing.assert_array_equal(rec.primary_tri.numpy(), np.asarray(ref.primary_tri))
    np.testing.assert_array_equal(rec.u.numpy(), np.asarray(ref.u))
    fields = ("tri", "sun_tri") + (("light_vis",) if cs.nee else ())
    for f in fields:
        a, b = getattr(rec, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == b.shape == (SPP, MB + 1, RES * RES)
        agree = float((a == b).mean())
        assert agree >= 0.995, f"{name} {f}: agreement {agree:.4f}"
    if cs.nee:
        np.testing.assert_allclose(rec.primary_t.numpy(), np.asarray(ref.primary_t), rtol=1e-4)
    else:
        assert rec.light_u is None and rec.t is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_primal_matches_jax(name):
    cs = Case(name, CASES)
    ref = np.asarray(jrp.render_radiance_replay(*cs.j, jax.random.PRNGKey(0), **cs.j_kw()))
    img = rp.render_radiance_replay(*cs.t, **cs.kw()).numpy()
    frac, med = _forks(img, ref)
    assert frac < 0.02 and med < 1e-5, f"{name}: forks {frac:.4f}, median {med:.2e}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_gradients_match_jax(name):
    cs = Case(name, CASES)
    jg, jm, je, jc = cs.j

    def loss(color, rough, sun_p, ibl_p, ibl):
        m2 = jm._replace(color=color, roughness=rough)
        e2 = je._replace(sun_power=sun_p, ibl_power=ibl_p, ibl=ibl)
        img = jrp.render_radiance_replay(jg, m2, e2, jc, jax.random.PRNGKey(0), **cs.j_kw())
        return jnp.mean(img ** 2)

    ref = jax.grad(loss, argnums=tuple(range(5)))(jm.color, jm.roughness, je.sun_power,
                                                 je.ibl_power, je.ibl)
    got = _port_grads(rp.render_radiance_replay, *cs.t, **cs.kw())
    for f, a, b in zip(FIELDS, got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape, f
        assert _rel(a, b) <= 1e-4, f"{name} {f}: relative difference {_rel(a, b):.2e}"
