"""Port parity, whole slice: the port's scan estimator against the JAX
package's ``render_radiance(fused=False)`` on the same scenes and the
same explicit uniform streams (made with numpy).

Paths fork where the two closest-hit scans pick different triangles on a
shared edge, and NEE visibility is a knife-edge, so the bound is on the
fraction of pixels whose channels differ by more than 1e-3 (< 2 %, as
``tests/test_oracle_parity.py`` bounds the torch oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu import testing as jt
from ensem3a_openclraytracer_tpu.models.pathtracer import render_radiance as j_render
from ensem3a_openclraytracer_tpu.scene.scene import build_light_pack as j_light_pack
from ensem3a_openclraytracer_tpu_torch import convert
from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance, render_scene
from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene
from test_torch_replay import one_torch_thread  # noqa: F401  (an autouse fixture)

RES = 24
SPP = 2
MB = 3

CASES = {
    "cornell": dict(make=lambda: jt.make_cornell_scene(use_bvh=False), sun=False),
    "outdoor16_sun_ibl": dict(make=lambda: jt.make_outdoor_scene(n_cubes=16, use_bvh=False),
                              sun=True),
    "glass_light_nee": dict(make=lambda: jt.make_glass_light_scene(use_bvh=False), sun=False,
                            nee=True),
    "outdoor_panel_mis": dict(
        make=lambda: jt.make_outdoor_scene(n_cubes=16, use_bvh=False, emissive_panel=True),
        sun=True, nee=True, mis=True),
    "cornell_refract": dict(make=lambda: jt.make_cornell_scene(use_bvh=False), sun=False,
                            glass_mode="refract"),
}


def _fork_fraction(a, b):
    return float((np.abs(a - b).max(axis=-1) > 1e-3).mean())


@pytest.mark.parametrize("name", sorted(CASES))
def test_render_radiance_matches_jax(name):
    case = CASES[name]
    jg, jm, je, jc = case["make"]()
    rng = np.random.default_rng(sorted(CASES).index(name))
    n = RES * RES
    u = rng.random(size=(SPP, MB + 1, n, 2), dtype=np.float64).astype(np.float32)
    nee, mis = case.get("nee", False), case.get("mis", False)
    ul = rng.random(size=(SPP, MB + 1, n, 3), dtype=np.float64).astype(np.float32) if nee else None
    jl = j_light_pack(jg, jm) if nee else None
    kw = dict(height=RES, width=RES, spp=SPP, max_bounce=MB, sun_enabled=case["sun"],
              nee=nee, mis=mis, glass_mode=case.get("glass_mode", "tint"))
    ref = np.asarray(j_render(
        jg, jm, je, jc, jax.random.PRNGKey(0), uniforms=jnp.asarray(u), lights=jl,
        light_uniforms=None if ul is None else jnp.asarray(ul), fused=False, **kw))

    g, m, e, c = convert.scene(jg, jm, je, jc, device="cpu")
    img = render_radiance(
        g, m, e, c, uniforms=torch.as_tensor(u), lights=convert.lights(jl, "cpu"),
        light_uniforms=None if ul is None else torch.as_tensor(ul), **kw).numpy()
    assert img.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and img.mean() > 0.0
    frac = _fork_fraction(img, ref)
    assert frac < 0.02, f"{name}: pixel forks {frac:.4f}, max diff {np.abs(img - ref).max()}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_gradients_match_jax(name):
    """The scan path's gradients of ``mean(img^2)`` w.r.t. color,
    roughness, sun power, IBL power and IBL texels equal ``jax.grad`` of
    the JAX ``render_radiance(fused=False)`` on the same uniforms to 1e-4
    relative per parameter (float order in two frameworks)."""
    case = CASES[name]
    jg, jm, je, jc = case["make"]()
    res = 16
    rng = np.random.default_rng(100 + sorted(CASES).index(name))
    n = res * res
    u = rng.random(size=(SPP, MB + 1, n, 2), dtype=np.float64).astype(np.float32)
    nee, mis = case.get("nee", False), case.get("mis", False)
    ul = rng.random(size=(SPP, MB + 1, n, 3), dtype=np.float64).astype(np.float32) if nee else None
    jl = j_light_pack(jg, jm) if nee else None
    kw = dict(height=res, width=res, spp=SPP, max_bounce=MB, sun_enabled=case["sun"],
              nee=nee, mis=mis, glass_mode=case.get("glass_mode", "tint"), fused=False)

    def j_loss(color, rough, sun_p, ibl_p, ibl):
        img = j_render(jg, jm._replace(color=color, roughness=rough),
                       je._replace(sun_power=sun_p, ibl_power=ibl_p, ibl=ibl), jc,
                       jax.random.PRNGKey(0), uniforms=jnp.asarray(u), lights=jl,
                       light_uniforms=None if ul is None else jnp.asarray(ul), **kw)
        return jnp.mean(img ** 2)

    ref = jax.grad(j_loss, argnums=tuple(range(5)))(jm.color, jm.roughness, je.sun_power,
                                                   je.ibl_power, je.ibl)
    g, m, e, c = convert.scene(jg, jm, je, jc, device="cpu")
    leaves = [x.clone().requires_grad_(True)
              for x in (m.color, m.roughness, e.sun_power, e.ibl_power, e.ibl)]
    img = render_radiance(
        g, m._replace(color=leaves[0], roughness=leaves[1]),
        e._replace(sun_power=leaves[2], ibl_power=leaves[3], ibl=leaves[4]), c,
        uniforms=torch.as_tensor(u), lights=convert.lights(jl, "cpu"),
        light_uniforms=None if ul is None else torch.as_tensor(ul), **kw)
    got = torch.autograd.grad(torch.mean(img ** 2), leaves, allow_unused=True)
    for f, a, b, x in zip(("color", "roughness", "sun_power", "ibl_power", "ibl"), got, ref,
                          leaves):
        a = np.zeros(tuple(x.shape), np.float32) if a is None else a.numpy()
        b = np.asarray(b)
        rel = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-12)
        assert rel <= 1e-4, f"{name} {f}: relative difference {rel:.2e}"
    assert float(np.abs(np.asarray(ref[0])).max()) > 0.0


def test_render_scene_from_files(tmp_path):
    """Scene.load -> render_scene on a tiny OBJ + ini, on the CPU: a
    finite image at the ini's settings, the same for the same seed."""
    g, m, e, c = tt.make_outdoor_scene(n_cubes=4, device="cpu")
    obj = str(tmp_path / "outdoor.obj")
    tt.write_scene_files(obj, g, m, e, c, resolution=12, spp=2, max_bounce=2)
    scene = Scene.load(obj, device="cpu")
    img = render_scene(scene, seed=3)
    assert img.shape == (12, 12, 3) and torch.isfinite(img).all()
    assert 0.0 < float(img.mean()) <= 1.0
    assert torch.equal(img, render_scene(scene, seed=3))
    assert not torch.equal(img, render_scene(scene, seed=4))
    nee_img = render_scene(scene, seed=3, overrides={"nee": True, "resolution": 8})
    assert nee_img.shape == (8, 8, 3)


def test_autograd_reaches_materials_and_env():
    g, m, e, c = tt.make_outdoor_scene(n_cubes=4, device="cpu")
    color = m.color.clone().requires_grad_(True)
    ibl_power = e.ibl_power.clone().requires_grad_(True)
    img = render_radiance(g, m._replace(color=color), e._replace(ibl_power=ibl_power), c,
                          height=8, width=8, spp=1, max_bounce=2)
    img.sum().backward()
    assert color.grad is not None and torch.isfinite(color.grad).all()
    assert float(color.grad.abs().sum()) > 0.0 and float(ibl_power.grad) > 0.0
