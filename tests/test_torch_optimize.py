"""Inverse rendering in the port (``models/optimize.py``): the train step
against the JAX package's (``optax.adam`` on ``jax.grad`` of the same loss,
same explicit uniforms), the clamps, NEE and MIS steps, resumable runs (a
run stopped at iteration 3 and resumed gives the same losses bit for bit,
as ``tests/test_optimize_checkpoint.py`` asks of the JAX package), the
retry, a 1x1 ``mesh=`` against none, and a JAX checkpoint carried across."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ensem3a_openclraytracer_tpu import testing as jt
from ensem3a_openclraytracer_tpu.models import optimize as jopt
from ensem3a_openclraytracer_tpu.models.replay import render_radiance_replay as j_replay
from ensem3a_openclraytracer_tpu.scene.scene import build_light_pack as j_light_pack
from ensem3a_openclraytracer_tpu_torch import convert
from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.models import optimize as opt
from ensem3a_openclraytracer_tpu_torch.parallel.mesh import single_device_mesh
from ensem3a_openclraytracer_tpu_torch.scene.scene import build_light_pack
from test_torch_replay import one_torch_thread  # noqa: F401  (an autouse fixture)

RES, SPP, MB, LR = 16, 2, 2, 5e-2


def _setup(lr=LR, **kw):
    g, m, e, c = tt.make_cornell_scene(device="cpu")
    init, step = opt.make_train_step(g, m, e, c, opt.Adam(lr), height=RES, width=RES, spp=SPP,
                                     max_bounce=MB, sun_enabled=False, **kw)
    return init, step, torch.zeros((RES, RES, 3))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-12)


def test_kill_and_resume_is_bit_equal(tmp_path):
    init, step, target = _setup()
    ckpt = str(tmp_path / "opt.npz")
    full, resumed = [], []
    opt.run_optimization(init, step, target, 3, iters=6, log=lambda i, x: full.append(x))
    # stopped after 3 iterations (checkpoint_every=3 writes at i == 2) ...
    opt.run_optimization(init, step, target, 3, iters=3, checkpoint_path=ckpt,
                         checkpoint_every=3, log=lambda i, x: resumed.append((i, x)))
    # ... and resumed from the file to the end
    opt.run_optimization(init, step, target, 3, iters=6, checkpoint_path=ckpt,
                         checkpoint_every=3, log=lambda i, x: resumed.append((i, x)))
    assert [i for i, _ in resumed] == list(range(6))
    assert [x for _, x in resumed] == full
    assert full[-1] < full[0]


def test_checkpoint_round_trip_is_exact(tmp_path):
    init, step, target = _setup()
    params, state = init()
    params, state, _ = step(params, state, target, opt.iteration_generator(9, 0, "cpu"))
    path = str(tmp_path / "rt.npz")
    opt.save_optimizer_checkpoint(path, params, state, 7, 123)
    p2, s2, it, seed = opt.load_optimizer_checkpoint(path, "cpu")
    assert (it, seed) == (7, 123)
    for a, b in zip(list(params) + list(state.mu) + list(state.nu) + [state.count],
                    list(p2) + list(s2.mu) + list(s2.nu) + [s2.count]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(s2.count) == 1
    assert not list(tmp_path.glob("*.tmp"))


def test_iteration_generator_is_pure():
    draw = lambda s, i: torch.rand(4, generator=opt.iteration_generator(s, i, "cpu"))
    assert torch.equal(draw(3, 5), draw(3, 5))
    assert not torch.equal(draw(3, 5), draw(3, 6))
    assert not torch.equal(draw(3, 5), draw(4, 5))
    assert not torch.equal(draw(2 ** 40 + 3, 5), draw(3, 5))


@pytest.mark.parametrize("scene", ["cornell", "glass_light_nee"])
def test_step_matches_optax_on_jax_gradients(scene, monkeypatch):
    """One step of the port (replay gradients, its Adam, the clamps) equals
    ``optax.adam`` applied to ``jax.grad`` of the JAX replay's loss on the
    same uniforms, then the JAX package's clamps: parameters and moments
    to 1e-4 relative (set by the gradients' parity)."""
    nee = scene == "glass_light_nee"
    jg, jm, je, jc = (jt.make_glass_light_scene if nee else jt.make_cornell_scene)(use_bvh=False)
    jl = j_light_pack(jg, jm) if nee else None
    rng = np.random.default_rng(7)
    u = rng.random((SPP, MB + 1, RES * RES, 2)).astype(np.float32)
    lu = rng.random((SPP, MB + 1, RES * RES, 3)).astype(np.float32) if nee else None
    target = rng.random((RES, RES, 3)).astype(np.float32) * 0.2
    lr = 0.2  # large enough that the clamps bite

    def j_loss(p):
        m, e = p.apply(jm, je)
        img = j_replay(jg, m, e, jc, jax.random.PRNGKey(0), height=RES, width=RES, spp=SPP,
                       max_bounce=MB, sun_enabled=False, uniforms=jnp.asarray(u), nee=nee,
                       lights=jl, light_uniforms=None if lu is None else jnp.asarray(lu))
        return jopt.image_loss(img, jnp.asarray(target))

    jp = jopt.TrainableParams.from_scene_params(jm, je)
    tx = optax.adam(lr)
    j_state = tx.init(jp)
    j_lossv, j_grads = jax.value_and_grad(j_loss)(jp)
    updates, j_state = tx.update(j_grads, j_state, jp)
    jp2 = optax.apply_updates(jp, updates)
    jp2 = jp2._replace(color=jnp.clip(jp2.color, 0.0, 1.0),
                       roughness=jnp.clip(jp2.roughness, 0.0, None),
                       sun_power=jnp.clip(jp2.sun_power, 0.0, None),
                       ibl_power=jnp.clip(jp2.ibl_power, 0.0, None),
                       ibl=jnp.clip(jp2.ibl, 0.0, None))

    g, m, e, c = convert.scene(jg, jm, je, jc, device="cpu")
    lights = convert.lights(jl, "cpu")
    # the step's renderer on the same explicit uniforms
    monkeypatch.setattr(opt, "render_for_grad", functools.partial(
        opt.render_for_grad, uniforms=torch.as_tensor(u),
        light_uniforms=None if lu is None else torch.as_tensor(lu)))
    init, step = opt.make_train_step(g, m, e, c, opt.Adam(lr), height=RES, width=RES, spp=SPP,
                                     max_bounce=MB, sun_enabled=False, nee=nee, lights=lights)
    p, state = init()
    p2, state2, loss = step(p, state, torch.as_tensor(target), None)
    assert abs(float(loss) - float(j_lossv)) <= 1e-5 * float(j_lossv)
    assert int(state2.count) == int(j_state[0].count) == 1
    for f, a, b, mu, jmu, nu, jnu in zip(jopt.TrainableParams._fields, p2, jp2, state2.mu,
                                         j_state[0].mu, state2.nu, j_state[0].nu):
        assert _rel(a, b) <= 1e-4, f"{scene} {f}: params {_rel(a, b):.2e}"
        assert _rel(mu, jmu) <= 1e-4, f"{scene} {f}: mu {_rel(mu, jmu):.2e}"
        assert _rel(nu, jnu) <= 1e-4, f"{scene} {f}: nu {_rel(nu, jnu):.2e}"
    # the clamps hold, and bite: some colors reach 0 or 1
    assert float(p2.color.min()) >= 0.0 and float(p2.color.max()) <= 1.0
    assert bool(((p2.color == 0.0) | (p2.color == 1.0)).any())
    assert all(float(x.min()) >= 0.0 for x in (p2.roughness, p2.sun_power, p2.ibl_power, p2.ibl))
    assert not torch.equal(p2.color, p.color)


@pytest.mark.parametrize("kw", [{"nee": True}, {"nee": True, "mis": True}], ids=["nee", "mis"])
def test_train_step_nee_and_mis(kw):
    g, m, e, c = tt.make_cornell_scene(device="cpu")
    lights = build_light_pack(g, m)
    init, step = opt.make_train_step(g, m, e, c, opt.Adam(LR), height=RES, width=RES, spp=SPP,
                                     max_bounce=MB, sun_enabled=False, lights=lights, **kw)
    p, state = init()
    p2, state2, loss = step(p, state, torch.zeros((RES, RES, 3)), torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss)) and float(loss) > 0.0
    for mu in state2.mu[:2]:  # color, roughness: mu = 0.1 * gradient after one step
        assert torch.isfinite(mu).all() and float(mu.abs().max()) > 0.0
    assert not torch.equal(p2.color, p.color)


def test_retry_reproduces_the_step(capsys):
    init, step, target = _setup()
    clean = []
    opt.run_optimization(init, step, target, 11, iters=3, log=lambda i, x: clean.append(x))
    failed = []

    def flaky(*args):
        failed.append(len(failed))
        if len(failed) == 2:  # the second call (iteration 1's first attempt)
            raise RuntimeError("transient device failure")
        return step(*args)

    got = []
    opt.run_optimization(init, flaky, target, 11, iters=3, log=lambda i, x: got.append(x))
    assert len(failed) == 4 and got == clean
    assert "step 1 failed, retrying" in capsys.readouterr().out


def test_mesh_is_not_ported():
    """``mesh=`` is no longer refused now that sharding is ported: a 1x1
    mesh renders what ``mesh=None`` renders, bit for bit, and its train step
    takes the unsharded step's update (the loss summed over the rank's rows,
    then divided by the pixel count: 1e-6 relative to the mean)."""
    g, m, e, c = tt.make_cornell_scene(device="cpu")
    params = opt.TrainableParams.from_scene_params(m, e)
    kw = dict(height=8, width=8, spp=2, max_bounce=2, sun_enabled=False)
    gen = lambda: torch.Generator().manual_seed(4)
    mesh = single_device_mesh()
    img = opt.render_for_grad(params, g, m, e, c, gen(), **kw)
    assert torch.equal(img, opt.render_for_grad(params, g, m, e, c, gen(), mesh=mesh, **kw))
    target = torch.full((8, 8, 3), 0.1)
    out = []
    for msh in (None, mesh):
        init, step = opt.make_train_step(g, m, e, c, opt.Adam(LR), mesh=msh, **kw)
        p, state = init()
        out.append(step(p, state, target, gen()))
    (p0, _, l0), (p1, _, l1) = out
    assert abs(float(l0) - float(l1)) <= 1e-6 * float(l0)
    for a, b in zip(p0, p1):
        assert _rel(a, b) <= 1e-6


def test_convert_jax_optimizer_checkpoint(tmp_path):
    """A JAX run's checkpoint loads into the port with equal parameters,
    moments, step count and iteration, and the port's run resumes from it."""
    jg, jm, je, jc = jt.make_cornell_scene(use_bvh=False)
    tx = optax.adam(LR)
    j_init, j_step = jopt.make_train_step(jg, jm, je, jc, tx, height=RES, width=RES, spp=SPP,
                                          max_bounce=MB, sun_enabled=False)
    jp, js = j_init()
    target = jnp.zeros((RES, RES, 3), jnp.float32)
    for i in range(2):
        jp, js, _ = j_step(jp, js, target, jax.random.PRNGKey(i))
    j_path, path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jopt.save_optimizer_checkpoint(j_path, jp, js, 2, jax.random.PRNGKey(5))
    convert.optimizer_checkpoint(j_path, path, seed=5)
    p, state, it, seed = opt.load_optimizer_checkpoint(path, "cpu")
    assert (it, seed, int(state.count)) == (2, 5, 2)
    adam = js[0]
    for a, b in zip(list(p) + list(state.mu) + list(state.nu),
                    list(jp) + list(adam.mu) + list(adam.nu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tp = convert.trainable_params(jp, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tp, p))
    init, step, target_t = _setup()
    losses = []
    opt.run_optimization(init, step, target_t, 0, iters=3, checkpoint_path=path,
                         log=lambda i, x: losses.append((i, x)))
    assert [i for i, _ in losses] == [2]
