"""Sharded rendering and training of the port (``parallel/``) on ranks
spawned with ``torch.multiprocessing`` over ``gloo`` on the CPU: 2 ranks
as dp2 and as sp2, 4 ranks as dp2 x sp2, Cornell 16^2, 4 spp, 2 bounces, on
explicit uniforms made with numpy.

Bounds: the sharded image equals the unsharded port image to 1e-6 (only
the order of the sum over samples differs) and the JAX package's
``render_radiance`` on the same uniforms within PERF.md's image bounds
(< 2 % pixel forks, median |diff| < 1e-5); sharded gradients equal
unsharded ones to 1e-5 relative per parameter, and every rank holds the
same loss, gradients and updated parameters bit for bit, in two runs.

Every rank is joined with a timeout and the test fails if one is still
alive.  The worker function imports no JAX (the spawned ranks import this
module), so the JAX reference is imported inside its test."""

import contextlib
import io
import json
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.models import optimize as opt
from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance
from ensem3a_openclraytracer_tpu_torch.parallel import distributed as pdist
from ensem3a_openclraytracer_tpu_torch.parallel.mesh import Mesh, make_mesh, single_device_mesh
from ensem3a_openclraytracer_tpu_torch.parallel.render import (
    make_sharded_renderer,
    render_radiance_sharded,
    shard_target_image,
)
from ensem3a_openclraytracer_tpu_torch.scene.scene import build_light_pack

RES, SPP, MB = 16, 4, 2
JOIN_S = 300  # per rank; a hang fails the test instead of eating the suite's limit
SHAPES = [(2, 1), (1, 2), (2, 2)]


def _streams():
    rng = np.random.default_rng(11)
    n = RES * RES
    u = rng.random((SPP, MB + 1, n, 2)).astype(np.float32)
    ul = rng.random((SPP, MB + 1, n, 3)).astype(np.float32)
    target = (rng.random((RES, RES, 3)) * 0.3).astype(np.float32)
    return torch.as_tensor(u), torch.as_tensor(ul), torch.as_tensor(target)


def _grad_kw(lights):
    return dict(height=RES, width=RES, spp=SPP, max_bounce=MB, sun_enabled=False, nee=True,
                lights=lights)


def _worker(rank, world, sp, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(sp=sp)
        g, m, e, c = tt.make_cornell_scene(device="cpu")
        lights = build_light_pack(g, m)
        u, ul, target = _streams()
        kw = dict(height=RES, width=RES, spp=SPP, max_bounce=MB, sun_enabled=False)
        out = {"mesh": (mesh.dp, mesh.sp, mesh.dp_idx, mesh.sp_idx)}
        out["image"] = render_radiance_sharded(mesh, g, m, e, c, uniforms=u, gather=True, **kw)
        out["rows"] = render_radiance_sharded(mesh, g, m, e, c, uniforms=u, **kw)
        out["nee_image"] = render_radiance_sharded(mesh, g, m, e, c, uniforms=u,
                                                   light_uniforms=ul, nee=True, lights=lights,
                                                   gather=True, **kw)
        params = opt.TrainableParams.from_scene_params(m, e)
        rows = shard_target_image(mesh, target)
        out["grads"] = [opt.value_and_grad(params, rows, g, m, e, c, mesh=mesh, uniforms=u,
                                           light_uniforms=ul, **_grad_kw(lights))
                        for _ in range(2)]
        init, step = opt.make_train_step(g, m, e, c, opt.Adam(5e-2), mesh=mesh, **kw)
        p, state = init()
        out["steps"] = [step(p, state, rows, opt.iteration_generator(3, 0, "cpu"))
                        for _ in range(2)]
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _cli_worker(rank, world, port, workdir, scene, out_dir):
    """``cli.main`` as one of ``torchrun``'s ranks: the process group comes
    from the environment it reads."""
    from ensem3a_openclraytracer_tpu_torch.cli import main

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    os.chdir(workdir)
    cpu = ["--device", "cpu"]
    buf, rcs = io.StringIO(), []
    try:
        with contextlib.redirect_stdout(buf):
            rcs.append(main(["render", scene, "--mesh", "2,1", "--chunk-spp", "2",
                             "--checkpoint", "r.npz", "--out", "r/out.png", *cpu]))
            rcs.append(main(["optimize", scene, "--target", "t.png", "--iters", "2", "--spp", "2",
                             "--max-bounce", "1", "--mesh", "1,2", "--checkpoint", "o.npz",
                             "--checkpoint-every", "1", "--dry-run", *cpu]))
            rcs.append(main(["bench", "--scaling", "--resolution", "16", "--spp", "2", *cpu]))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rcs": rcs, "out": buf.getvalue()}, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(procs, world):
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.terminate()
        p.join(10)
    assert not alive, f"{len(alive)} of {world} ranks still alive after {JOIN_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


def _spawn(world, sp, out_dir):
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, world, sp, port, str(out_dir)))
             for r in range(world)]
    _join(procs, world)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"dp{s[0]}_sp{s[1]}")
def run(request, tmp_path_factory):
    dp, sp = request.param
    return dp, sp, _spawn(dp * sp, sp, tmp_path_factory.mktemp(f"dp{dp}sp{sp}"))


@pytest.fixture(scope="module")
def reference():
    """The unsharded port on the same streams: images, loss, gradients."""
    torch.set_num_threads(1)
    g, m, e, c = tt.make_cornell_scene(device="cpu")
    lights = build_light_pack(g, m)
    u, ul, target = _streams()
    kw = dict(height=RES, width=RES, spp=SPP, max_bounce=MB, sun_enabled=False)
    params = opt.TrainableParams.from_scene_params(m, e)
    return {
        "image": render_radiance(g, m, e, c, uniforms=u, **kw),
        "nee_image": render_radiance(g, m, e, c, uniforms=u, light_uniforms=ul, nee=True,
                                     lights=lights, **kw),
        "grads": opt.value_and_grad(params, target, g, m, e, c, uniforms=u, light_uniforms=ul,
                                    **_grad_kw(lights)),
    }


def test_ranks_sit_on_the_mesh(run):
    dp, sp, outs = run
    assert [o["mesh"] for o in outs] == [(dp, sp, r // sp, r % sp) for r in range(dp * sp)]
    for r, o in enumerate(outs):
        assert o["rows"].shape == (RES // dp, RES, 3)
        assert torch.equal(o["rows"], o["image"][(r // sp) * RES // dp:(r // sp + 1) * RES // dp])


@pytest.mark.parametrize("which", ["image", "nee_image"])
def test_sharded_image_equals_unsharded(run, reference, which):
    _, _, outs = run
    ref = reference[which]
    for o in outs:
        assert o[which].shape == ref.shape
        assert float((o[which] - ref).abs().max()) <= 1e-6
        assert torch.equal(o[which], outs[0][which])


def test_sharded_image_matches_jax(run):
    import jax
    import jax.numpy as jnp

    from ensem3a_openclraytracer_tpu import testing as jt
    from ensem3a_openclraytracer_tpu.models.pathtracer import render_radiance as j_render

    _, _, outs = run
    u, _, _ = _streams()
    jg, jm, je, jc = jt.make_cornell_scene(use_bvh=False)
    ref = np.asarray(j_render(jg, jm, je, jc, jax.random.PRNGKey(0), uniforms=jnp.asarray(u.numpy()),
                              height=RES, width=RES, spp=SPP, max_bounce=MB, sun_enabled=False,
                              fused=False))
    diff = np.abs(outs[0]["image"].numpy() - ref).max(axis=-1)
    assert float((diff > 1e-3).mean()) < 0.02 and float(np.median(diff)) < 1e-5


def test_sharded_gradients_equal_unsharded(run, reference):
    _, _, outs = run
    loss_ref, grads_ref = reference["grads"]
    loss, grads = outs[0]["grads"][0]
    assert abs(float(loss) - float(loss_ref)) <= 1e-6 * float(loss_ref)
    for f, a, b in zip(opt.TrainableParams._fields, grads, grads_ref):
        scale = max(float(b.abs().max()), 1e-12)
        assert float((a - b).abs().max()) <= 1e-5 * scale, f


def test_every_rank_holds_the_same_loss_gradients_and_update(run):
    _, _, outs = run
    loss0, grads0 = outs[0]["grads"][0]
    p0, _, l0 = outs[0]["steps"][0]
    for o in outs:
        loss, grads = o["grads"][0]
        assert torch.equal(loss, loss0)
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0))
        p, _, l = o["steps"][0]
        assert torch.equal(l, l0) and all(torch.equal(a, b) for a, b in zip(p, p0))


def test_two_sharded_runs_are_bit_equal(run):
    _, _, outs = run
    for o in outs:
        (la, ga), (lb, gb) = o["grads"]
        assert torch.equal(la, lb) and all(torch.equal(a, b) for a, b in zip(ga, gb))
        (pa, sa, _), (pb, sb, _) = o["steps"]
        assert all(torch.equal(a, b) for a, b in zip(list(pa) + list(sa.mu),
                                                       list(pb) + list(sb.mu)))


@pytest.mark.parametrize("height,spp,msg", [(15, 4, "height 15 not divisible by dp=2"),
                                            (16, 3, "spp 3 not divisible by sp=2")])
def test_indivisible_shapes_raise(height, spp, msg):
    g, m, e, c = tt.make_cornell_scene(device="cpu")
    mesh = Mesh(dp=2, sp=2, dp_idx=0, sp_idx=0)  # raises before any collective
    with pytest.raises(ValueError, match=msg):
        render_radiance_sharded(mesh, g, m, e, c, 0, height=height, width=16, spp=spp,
                                max_bounce=1)


def test_initialize_without_environment_does_nothing(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    pdist.initialize(device="cpu")
    assert not dist.is_initialized()
    assert make_mesh(sp=1) == single_device_mesh()
    assert pdist.global_mesh() == single_device_mesh()
    info = pdist.process_info()
    assert (info["process_index"], info["process_count"], info["global_device_count"]) == (0, 1, 1)
    assert info["local_devices"]


def test_initialize_explicit_single_rank_group():
    """Explicit arguments reach ``init_process_group`` (gloo on the CPU);
    a one-rank group gives a 1x1 mesh with real groups."""
    pdist.initialize(init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0,
                     device="cpu")
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        mesh = pdist.global_mesh()
        assert (mesh.dp, mesh.sp, mesh.dp_idx, mesh.sp_idx) == (1, 1, 0, 0)
        assert mesh.group is not None
        assert pdist.process_info()["process_count"] == 1
        with pytest.raises(ValueError):
            make_mesh(sp=2)
    finally:
        dist.destroy_process_group()


def test_single_device_mesh_renders_the_unsharded_image():
    """A 1x1 mesh renders with the caller's generator: the image of
    ``render_radiance`` bit for bit; ``make_sharded_renderer`` likewise."""
    g, m, e, c = tt.make_cornell_scene(device="cpu")
    kw = dict(height=8, width=8, spp=2, max_bounce=2, sun_enabled=False)
    gen = lambda: torch.Generator().manual_seed(9)
    ref = render_radiance(g, m, e, c, gen(), **kw)
    mesh = single_device_mesh()
    assert torch.equal(render_radiance_sharded(mesh, g, m, e, c, gen(), **kw), ref)
    assert torch.equal(render_radiance_sharded(mesh, g, m, e, c, 9, **kw), ref)
    fn = make_sharded_renderer(mesh, **kw)
    assert torch.equal(fn(g, m, e, c, 9), ref)
    assert torch.equal(shard_target_image(mesh, ref), ref)


def test_cli_on_two_ranks(tmp_path):
    """``render --mesh 2,1``, ``optimize --mesh 1,2`` and ``bench --scaling``
    on two ranks that join from ``torchrun``'s environment: rank 0 alone
    prints and writes, and the scaling sweep covers 1 and 2 ranks and both
    mesh shapes."""
    from ensem3a_openclraytracer_tpu_torch.models.progressive import ProgressiveState
    from ensem3a_openclraytracer_tpu_torch.utils.image import save_png

    g, m, e, c = tt.make_cornell_scene(device="cpu")
    scene = str(tmp_path / "cornell.obj")
    tt.write_scene_files(scene, g, m, e, c, resolution=RES, spp=SPP, max_bounce=MB)
    save_png(np.full((RES, RES, 3), 0.3, np.float32), str(tmp_path / "t.png"))
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_cli_worker, args=(r, 2, port, str(tmp_path), scene,
                                                   str(tmp_path))) for r in range(2)]
    _join(procs, 2)
    runs = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            runs.append(json.load(f))
    assert [x["rcs"] for x in runs] == [[0, 0, 0], [0, 0, 0]]
    text = runs[0]["out"]
    assert f"rendered {RES}x{RES} @ {SPP} spp" in text and runs[1]["out"] == ""
    st = ProgressiveState.load(str(tmp_path / "r.npz"))
    assert st.spp_done == SPP and np.isfinite(st.accum).all() and st.image.mean() > 0.0
    assert os.path.exists(tmp_path / "r" / "src.png")
    assert [line.split()[1] for line in text.splitlines() if line.startswith("iter")] == ["0", "1"]
    with np.load(tmp_path / "o.npz") as z:
        assert int(z["iteration"]) == 2
    metrics = [json.loads(x)["metric"] for x in text.splitlines() if x.startswith("{")]
    assert metrics == ["scaling_nranks1_mrays_per_s", "scaling_nranks2_mrays_per_s",
                       "scaling_dp2_sp1_mrays_per_s", "scaling_dp1_sp2_mrays_per_s"]
