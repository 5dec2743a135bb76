"""The path-replay gradient engine (``models/replay.py``) against the
port's own scan estimator, and its records, chunks and gathers; its
parity with the JAX package's ``models/replay.py`` is in
``tests/test_torch_replay_jax.py``.

The same scenes and the same explicit uniform streams (made with numpy)
go through both packages.  The replay must be the port's scan estimator
(same primal to float32 order, on explicit uniforms and on the port's own
Philox stream; same gradients), its backward pass must trace nothing, and
its records must be the JAX recorder's.

Bounds: the two packages' closest hits pick different triangles on
knife-edge rays (a shared edge, NEE visibility), and a fork changes the
rest of that path, so records are held to >= 99.5 % agreement and images
to < 2 % pixel forks (|diff| > 1e-3) with median |diff| < 1e-5, as
``tests/test_torch_pathtracer.py`` holds renders.  Within the port the
replay and the scan estimator trace the same rays, so they are held to
rtol = atol = 2e-5 (``tests/test_replay.py``'s bound) and the gradients to
1e-5 after scaling; gradients against ``jax.grad`` to 1e-4 relative per
parameter (float order in two frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu import testing as jt
from ensem3a_openclraytracer_tpu.scene.scene import build_light_pack as j_light_pack
from ensem3a_openclraytracer_tpu_torch import convert
from ensem3a_openclraytracer_tpu_torch.models import replay as rp
from ensem3a_openclraytracer_tpu_torch.models.pathtracer import _gather_surface, render_radiance
from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
from ensem3a_openclraytracer_tpu_torch.ops import fused as fused_ops
from ensem3a_openclraytracer_tpu_torch.ops import rng
from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays

RES, SPP, MB = 16, 2, 3

CASES = {
    "cornell": dict(make=lambda: jt.make_cornell_scene(use_bvh=False), sun=False),
    "outdoor16_sun_ibl": dict(make=lambda: jt.make_outdoor_scene(n_cubes=16, use_bvh=False),
                              sun=True),
    "glass_light_nee": dict(make=lambda: jt.make_glass_light_scene(use_bvh=False), sun=False,
                            nee=True),
    "cornell_refract": dict(make=lambda: jt.make_cornell_scene(use_bvh=False), sun=False,
                            glass_mode="refract"),
}
# the recorder also on a multi-block scene (4 triangle blocks)
RECORD_CASES = {**CASES, "outdoor64_multiblock": dict(
    make=lambda: jt.make_outdoor_scene(n_cubes=64, use_bvh=False), sun=True)}
FIELDS = ("color", "roughness", "sun_power", "ibl_power", "ibl")


class Case:
    """One scene in both packages with one explicit stream (numpy seed)."""

    def __init__(self, name, cases=RECORD_CASES, spp=SPP):
        c = cases[name]
        self.sun, self.nee = c["sun"], c.get("nee", False)
        self.glass_mode = c.get("glass_mode", "tint")
        self.j = c["make"]()
        self.jl = j_light_pack(*self.j[:2]) if self.nee else None
        self.t = convert.scene(*self.j, device="cpu")
        self.lights = convert.lights(self.jl, "cpu")
        r = np.random.default_rng(sorted(cases).index(name))
        n = RES * RES
        self.u = r.random((spp, MB + 1, n, 2), dtype=np.float64).astype(np.float32)
        self.lu = (r.random((spp, MB + 1, n, 3), dtype=np.float64).astype(np.float32)
                   if self.nee else None)
        self.spp = spp

    def kw(self, stream="explicit"):
        """Keyword arguments of the port's renderers."""
        kw = dict(height=RES, width=RES, spp=self.spp, max_bounce=MB, sun_enabled=self.sun,
                  glass_mode=self.glass_mode, nee=self.nee, lights=self.lights)
        if stream == "explicit":
            kw.update(uniforms=torch.as_tensor(self.u),
                      light_uniforms=None if self.lu is None else torch.as_tensor(self.lu))
        return kw

    def j_kw(self):
        return dict(height=RES, width=RES, spp=self.spp, max_bounce=MB, sun_enabled=self.sun,
                    glass_mode=self.glass_mode, nee=self.nee, lights=self.jl,
                    uniforms=jnp.asarray(self.u),
                    light_uniforms=None if self.lu is None else jnp.asarray(self.lu))

    def rays(self):
        c = self.t[3]
        return camera_rays(c.position, c.rotation_deg, c.fov_deg, RES, RES)


def _port_grads(render, g, m, e, c, gen=None, **kw):
    """Gradients of ``mean(img^2)`` w.r.t. the five trainable leaves."""
    leaves = [x.clone().requires_grad_(True)
              for x in (m.color, m.roughness, e.sun_power, e.ibl_power, e.ibl)]
    m2 = m._replace(color=leaves[0], roughness=leaves[1])
    e2 = e._replace(sun_power=leaves[2], ibl_power=leaves[3], ibl=leaves[4])
    loss = torch.mean(render(g, m2, e2, c, gen, **kw) ** 2)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [np.zeros(x.shape, np.float32) if gx is None else gx.numpy()
            for gx, x in zip(grads, leaves)]


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-12)


def _forks(a, b):
    diff = np.abs(a - b).max(axis=-1)
    return float((diff > 1e-3).mean()), float(np.median(diff))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the machine's cores, and a thread pool spinning in every worker
    made these tests several times slower on a busy machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("stream", ["explicit", "philox"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_primal_matches_scan(name, stream):
    """The replay is the scan estimator: on the caller's uniforms, and on
    the port's own stream for the same generator seed."""
    cs = Case(name, CASES)
    g, m, e, c = cs.t
    gen = lambda: torch.Generator().manual_seed(5)
    scan = render_radiance(g, m, e, c, gen(), fused=False, **cs.kw(stream))
    rep = rp.render_radiance_replay(g, m, e, c, gen(), **cs.kw(stream))
    assert rep.shape == (RES, RES, 3) and torch.isfinite(rep).all() and float(rep.mean()) > 0
    np.testing.assert_allclose(rep.numpy(), scan.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_gradients_match_scan(name):
    cs = Case(name, CASES)
    g_scan = _port_grads(lambda *a, **k: render_radiance(*a, fused=False, **k), *cs.t, **cs.kw())
    g_rep = _port_grads(rp.render_radiance_replay, *cs.t, **cs.kw())
    for f, gs, gr in zip(FIELDS, g_scan, g_rep):
        scale = max(float(np.abs(gs).max()), 1e-6)
        np.testing.assert_allclose(gr / scale, gs / scale, atol=1e-5, err_msg=f"{name} {f}")
    assert np.abs(g_rep[0]).max() > 0.0, f"{name}: zero color gradient"


@pytest.mark.parametrize("recorder", ["scan", "scan_nee", "fused"])
def test_backward_runs_no_trace(recorder, monkeypatch):
    """Every trace (``ops/closest_hit.trace``) and fused record launch
    (``ops/fused.sample_fused``) happens in the forward pass."""
    cs = Case("glass_light_nee" if recorder == "scan_nee" else "outdoor64_multiblock")
    calls = []
    for mod, name in ((ch, "trace"), (fused_ops, "sample_fused")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=orig, _n=name, **k: calls.append(_n)
                            or _f(*a, **k))
    g, m, e, c = cs.t
    color = m.color.clone().requires_grad_(True)
    ibl = e.ibl.clone().requires_grad_(True)
    kw = cs.kw("philox")
    img = rp.render_radiance_replay(g, m._replace(color=color), e._replace(ibl=ibl), c,
                                    torch.Generator().manual_seed(2),
                                    fused=recorder == "fused", **kw)
    n_fwd = len(calls)
    assert calls.count("trace") >= 1
    if recorder == "fused":
        assert calls.count("sample_fused") == SPP and calls.count("trace") == 1
    else:
        assert "sample_fused" not in calls and calls.count("trace") > 1
    torch.mean(img ** 2).backward()
    assert len(calls) == n_fwd, f"the backward traced: {calls[n_fwd:]}"
    assert float(color.grad.abs().sum()) > 0.0


@pytest.mark.parametrize("name", ["cornell", "outdoor64_multiblock"])
def test_fused_recorder_matches_scan_recorder(name):
    """``record_paths_fused`` (the kernels' plain version on the CPU) draws
    the Philox stream in the fused engine's lane order (Morton-permuted on
    multi-block scenes), scatters its records back to pixel order, and
    then equals the scan recorder fed those uniforms."""
    cs = Case(name)
    g, m, e, _ = cs.t
    o, d = cs.rays()
    n = o.shape[0]
    key = rng.key_from_generator(torch.Generator().manual_seed(4), "cpu")
    fr = rp.record_paths(g, m, e, o, d, key, spp=SPP, max_bounce=MB, sun_enabled=cs.sun,
                         fused=True)
    hit = ch.trace(g, o, d)
    _, order = fused_ops.fused_args(g, m, e, o, d, hit, _gather_surface(g, m, o, d, hit))
    assert (order is not None) == (g.feats.block_bounds.shape[0] > 1)
    lane_u = torch.stack([rng.uniforms(key, (MB + 1, n, 2), s) for s in range(SPP)])
    want_u = lane_u if order is None else torch.empty_like(lane_u).index_copy_(2, order, lane_u)
    if order is not None:
        assert not torch.equal(order, torch.arange(n))
    assert torch.equal(fr.u, want_u)
    sr = rp.record_paths(g, m, e, o, d, spp=SPP, max_bounce=MB, sun_enabled=cs.sun,
                         uniforms=fr.u, fused=False)
    for f in ("tri", "sun_tri", "primary_tri"):
        assert torch.equal(getattr(fr, f), getattr(sr, f)), f
    assert float((fr.tri >= 0).float().mean()) > 0.1
    if cs.sun:
        assert float((fr.sun_tri >= 0).float().mean()) > 0.0


@pytest.mark.parametrize("stream", ["explicit_nee", "philox"])
def test_chunked_equals_unchunked(stream, monkeypatch):
    """Samples recorded and replayed in chunks (under checkpoint) give the
    unchunked result; explicit streams are cut along with the samples, and
    the default chunking follows the record budget."""
    cs = Case("glass_light_nee" if stream == "explicit_nee" else "outdoor16_sun_ibl", CASES,
              spp=4)
    kw = cs.kw("explicit" if stream == "explicit_nee" else "philox")
    gen = lambda: torch.Generator().manual_seed(9)
    base_img = rp.render_radiance_replay(*cs.t, gen(), **kw).detach().numpy()
    base = _port_grads(rp.render_radiance_replay, *cs.t, gen(), **kw)
    # a budget of one sample's records makes the default chunk one sample
    per_sample = RES * RES * (MB + 1) * (36 if cs.nee else 16)
    monkeypatch.setattr(rp, "record_budget_bytes", lambda device: per_sample)
    for chunk in (1, 2, None):
        img = rp.render_radiance_replay(*cs.t, gen(), spp_chunk=chunk, **kw).detach().numpy()
        assert _rel(img, base_img) <= 1e-6, f"chunk {chunk}: image {_rel(img, base_img):.2e}"
        got = _port_grads(rp.render_radiance_replay, *cs.t, gen(), spp_chunk=chunk, **kw)
        for f, a, b in zip(FIELDS, got, base):
            assert _rel(a, b) <= 1e-6, f"chunk {chunk} {f}: {_rel(a, b):.2e}"
    assert rp._chunk_divisor(100, 30) == 25 and rp._chunk_divisor(7, 3) == 1


def test_recorder_choice_and_refusals():
    cs = Case("glass_light_nee")
    g, m, e, _ = cs.t
    o, d = cs.rays()
    key = rng.key_from_generator(torch.Generator().manual_seed(1), "cpu")
    kw = dict(spp=1, max_bounce=MB, sun_enabled=False)
    with pytest.raises(ValueError, match="no NEE mode"):
        rp.record_paths(g, m, e, o, d, key, fused=True, nee=True, lights=cs.lights, **kw)
    with pytest.raises(ValueError, match="explicit uniforms"):
        rp.record_paths(g, m, e, o, d, fused=True, uniforms=torch.as_tensor(cs.u[:1]), **kw)
    with pytest.raises(ValueError, match="LightPack"):
        rp.record_paths(g, m, e, o, d, key, nee=True, **kw)
    with pytest.raises(ValueError, match="light_uniforms"):
        rp.record_paths(g, m, e, o, d, nee=True, lights=cs.lights,
                        uniforms=torch.as_tensor(cs.u[:1]), **kw)
    with pytest.raises(ValueError, match="Philox key"):
        rp.record_paths(g, m, e, o, d, **kw)
    # on the CPU fused=None records with the scan recorder: the unpermuted stream
    rec = rp.record_paths(g, m, e, o, d, key, **kw)
    assert torch.equal(rec.u[0], rng.uniforms(key, (MB + 1, o.shape[0], 2), 0))
    assert rp.record_budget_bytes("cpu") == 3 << 30


@pytest.mark.parametrize("rows", [7, 64, 300])
def test_gather_rows_backward(rows):
    """``ops/gathers.gather_rows``: the forward is ``table[idx]``; the
    backward equals autograd's of plain indexing (the one-hot product of
    small tables sums in float64, so to float32 rounding) and repeats bit
    for bit."""
    from ensem3a_openclraytracer_tpu_torch.ops.gathers import gather_rows

    r = np.random.default_rng(rows)
    table = torch.as_tensor(r.standard_normal((rows, 3)).astype(np.float32)).requires_grad_(True)
    idx = torch.as_tensor(r.integers(0, rows, (5000, 2)))
    w = torch.as_tensor(r.standard_normal((5000, 2, 3)).astype(np.float32))
    out = gather_rows(table, idx)
    assert torch.equal(out, table[idx])
    got = torch.autograd.grad((out * w).sum(), table)[0]
    again = torch.autograd.grad((gather_rows(table, idx) * w).sum(), table)[0]
    ref = torch.autograd.grad((table[idx] * w).sum(), table)[0]
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    vec = torch.as_tensor(r.standard_normal(rows).astype(np.float32)).requires_grad_(True)
    g1 = torch.autograd.grad((gather_rows(vec, idx[:, 0]) * w[:, 0, 0]).sum(), vec)[0]
    g2 = torch.autograd.grad((vec[idx[:, 0]] * w[:, 0, 0]).sum(), vec)[0]
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-5, atol=1e-5)
