"""The texel-gradient step on a scene of several triangle blocks, held
against the benchmark's plain reference on the lanes the recorder takes
(``port_bench/reference/optimize_lanes``), and the counter records of the
deployment (``"scatter"``, ``"graphs"``).

The scene is the benchmark's ``texel8k`` configuration at test size: a
ground and 22 cubes (266 triangles, 2 blocks) under the sun and a seeded
64 x 32 sky, written as OBJ + ini + JPEG and read by both sides, at
16^2, 2 spp, 3 bounces.  The scan recorder (the CPU's default) takes pixel
lanes; the fused recorder's route (``fused=True``: its plain versions on
the CPU, as on the card its kernels) takes the Morton order of the
primary hits.  Each is compared with the reference on its own lanes, and
fails the same tolerances on the other."""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ensem3a_openclraytracer_tpu_torch.models import optimize as opt
from ensem3a_openclraytracer_tpu_torch.ops import gathers
from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene
from ensem3a_openclraytracer_tpu_torch.utils import graphs, profiling
from port_bench.harness.compare import grads_of_moments
from port_bench.reference import optimize_lanes
from port_bench.reference import scene as ref_scene
from port_bench.scenes import files
from test_torch_graphs import StubGraphs, stub_graphs  # noqa: F401  (a fixture)
from test_torch_replay import one_torch_thread  # noqa: F401  (an autouse fixture)

RES, SPP, MB, LR, SEED, STEPS = 16, 2, 3, 1e-2, 2147483903, 2
LEAVES = {"color": "color", "roughness": "rough", "sun_power": "sun_power",
          "ibl_power": "ibl_power", "ibl": "ibl"}  # the program's leaf -> the reference's

# Float32 on both sides, the same paths, but each computes its shading in
# its own order of operations (the replay's per-face table and
# checkpointed samples; the reference's per-pass arithmetic), and the
# program sums gradients in fixed point: a few float32 ulps a lane, ~1e-6
# of a leaf's norm.  A path that took another triangle or another random
# number reads ~1 on its leaf.
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
# Adam turns a gradient into a step of about lr per value whatever its
# size, so the values after a step are held to a thousandth of a step.
VALUE_ATOL = LR * 1e-3


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    config = {"name": "texel_small", "generator": "outdoor",
              "params": {"n_cubes": 22, "geometry_seed": 7},
              "ini": {"resolution": RES, "spp": SPP, "maxBounce": MB,
                      "cam_x": 0.0, "cam_y": 0.0, "cam_z": 2.0, "cam_rx": -12.0, "cam_ry": 0.0,
                      "cam_rz": 0.0, "cam_DOF": 60.0, "IBL_Power": 1.0, "sun_Power": 1.0,
                      "sun_rx": 35.0, "sun_ry": 0.0, "sun_rz": 15.0},
              "materials": [[0, 1.0, 1.0, 1.0, 12.0, 1.0], [1, 0.75, 0.75, 0.75, 0.8, 1.0],
                            [1, 0.75, 0.15, 0.15, 0.9, 1.0], [1, 0.15, 0.75, 0.15, 0.9, 1.0],
                            [2, 0.85, 0.85, 0.9, 0.15, 1.0]],
              "sky": {"width": 64, "height": 32, "quality": 90}}
    d = tmp_path_factory.mktemp("texel")
    return files.write_scene(config, SEED, str(d), "cpu")


def _target():
    gen = torch.Generator().manual_seed(SEED)
    return torch.rand((RES, RES, 3), generator=gen)


def program_steps(obj):
    """The port's first ``STEPS`` steps: losses, gradients (from Adam's
    first moment, as the benchmark takes them) and the values after each
    step, keyed by the reference's leaf names."""
    scene = Scene.load(obj, device="cpu")
    assert scene.geometry.feats.block_bounds.shape[0] == 2
    env, mats = scene.env_params(), scene.material_params()
    assert tuple(env.ibl.shape) == (32, 64, 3)
    init, step = opt.make_train_step(scene.geometry, mats, env, scene.camera_params(),
                                     opt.Adam(LR), height=RES, width=RES, spp=SPP,
                                     max_bounce=MB, sun_enabled=True)
    params, state = init()
    losses, moments, values = [], [], []
    named = lambda tup: {LEAVES[k]: v.detach().clone() for k, v in tup._asdict().items()}
    for i in range(STEPS):
        gen = opt.iteration_generator(SEED, i, "cpu")
        params, state, loss = step(params, state, _target(), gen)
        losses.append(float(loss))
        moments.append(named(state.mu))
        values.append(named(params))
    return losses, grads_of_moments(moments, 0.9), values


def reference_steps(obj, morton: bool):
    return optimize_lanes.train_steps(ref_scene.load(obj, "cpu"), _target(), SEED, STEPS,
                                      resolution=RES, spp=SPP, max_bounce=MB, lr=LR,
                                      morton=morton)


@pytest.fixture(scope="module")
def runs(scene_files):
    """The program on each recorder, and the reference on each lane order."""
    from ensem3a_openclraytracer_tpu_torch.models import replay

    out = {"scan": program_steps(scene_files)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(opt, "radiance_for_rays_replay",
                   functools.partial(replay.radiance_for_rays_replay, fused=True))
        out["fused"] = program_steps(scene_files)
    out["pixel"] = reference_steps(scene_files, morton=False)
    out["morton"] = reference_steps(scene_files, morton=True)
    return out


def _leaf_gaps(prog, ref):
    """Each leaf's ``|a - b| / |b|``."""
    return {k: float((prog[k] - r).norm()) / max(float(r.norm()), 1e-30) for k, r in ref.items()}


def _compare(prog, ref):
    """The largest loss, gradient and value gaps of the program's steps
    against the reference's."""
    losses, grads, values = prog
    loss = max(abs(a - r["loss"]) / abs(r["loss"]) for a, r in zip(losses, ref))
    grad = max(max(_leaf_gaps(g, r["grads"]).values()) for g, r in zip(grads, ref))
    value = 0.0
    for v, r in zip(values, ref):
        for k, rv in r["params"].items():
            value = max(value, float((v[k] - rv).abs().max()))
    return loss, grad, value


@pytest.mark.parametrize("recorder, lanes", [("scan", "pixel"), ("fused", "morton")])
def test_step_equals_the_reference_on_its_lanes(runs, recorder, lanes):
    """The loss, every leaf's gradient (the 6,144 texel channels included:
    each leaf's norm of the difference) and every value after Adam."""
    loss, grad, value = _compare(runs[recorder], runs[lanes])
    assert loss <= LOSS_RTOL and grad <= GRAD_RTOL and value <= VALUE_ATOL
    texels = runs[recorder][1][0]["ibl"]
    assert 0 < int(torch.count_nonzero(texels)) < texels.numel()  # escapes reach some texels


@pytest.mark.parametrize("recorder, lanes", [("scan", "morton"), ("fused", "pixel")])
def test_the_other_lane_order_fails(runs, recorder, lanes):
    """On the other lane order the paths are another stream's: the
    texel gradient alone is off by far more than its tolerance."""
    loss, grad, value = _compare(runs[recorder], runs[lanes])
    assert grad > 100 * GRAD_RTOL and value > VALUE_ATOL
    texel = _leaf_gaps(runs[recorder][1][0], runs[lanes][0]["grads"])["ibl"]
    assert texel > 0.1


def test_the_lane_orders_differ(runs):
    """The two recorders take different lanes on this scene (else the two
    tests above would say nothing)."""
    assert runs["scan"][0] != runs["fused"][0]


def _profiled(fn):
    profiling.clear_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out


def test_scatter_counts_lanes_and_entries():
    """``scatter_rows`` counts one call, its index entries and every entry
    of its table under ``"scatter"`` while a profiler records; nothing
    without one; into a :func:`profiling.tallied` block's tally inside it."""
    grad = torch.arange(30.0).reshape(5, 2, 3)
    idx = torch.tensor([[0, 6], [2, 2], [6, 1], [3, 3], [0, 0]])
    profiling.clear_counters()
    gathers.scatter_rows(grad[:, 0], idx[:, 0], 7)
    assert profiling.counter_totals("scatter") is None
    _profiled(lambda: (gathers.scatter_rows(grad, idx, 7),
                       gathers.scatter_rows(grad[:, 0, 0], idx[:, 0], 9)))
    assert profiling.counter_totals("scatter") == {"calls": 2, "lanes": 10 + 5,
                                                   "entries": 7 * 3 + 9}
    table = torch.rand(7, 3, requires_grad=True)
    _profiled(lambda: gathers.gather_rows(table, idx).sum().backward())
    assert profiling.counter_totals("scatter") == {"calls": 1, "lanes": 10, "entries": 21}
    with profiling.tallied() as tally:
        _profiled(lambda: gathers.scatter_rows(grad, idx, 7))
    assert tally == {"scatter": {"calls": 1, "lanes": 10, "entries": 21}}
    assert profiling.counter_totals("scatter") is None
    profiling.clear_counters()


def _texel_grad(table, idx):
    """A function a graph captures: the gradient of a gathered sum."""
    with torch.enable_grad():
        t = table.detach().requires_grad_(True)
        (g,) = torch.autograd.grad((gathers.gather_rows(t, idx) ** 2).sum(), [t])
    return g, g.sum()


def test_graphed_counts_bytes_and_the_captured_scatters_per_replay():
    """Through the stand-in backend: the first call (warm-up and capture)
    copies its inputs in and its outputs out, the later ones too; each
    profiled replay records those bytes under ``"graphs"`` and the
    capture's scatter counts under ``"scatter"`` (the stand-in's replay
    runs the function again; its own counts are not kept)."""
    f = graphs.Graphed(_texel_grad, backend=StubGraphs())
    table, idx = torch.rand(11, 3), torch.tensor([1, 4, 4, 9, 1, 0])
    copy_in = table.nbytes + idx.nbytes
    clone_out = table.nbytes + 4
    _profiled(lambda: f(table, idx))  # the warm-up records its scatter; the capture tallies one
    assert f.captures == 1 and f.last_capture["counts"] == {
        "scatter": {"calls": 1, "lanes": 6, "entries": 33}}
    assert profiling.counter_totals("graphs") == {"calls": 1, "copy_in_bytes": copy_in,
                                                  "clone_out_bytes": clone_out}
    assert profiling.counter_totals("scatter") == {"calls": 1, "lanes": 6, "entries": 33}

    def three():
        return [f(table * k, idx) for k in (1.0, 2.0, 3.0)]

    outs = _profiled(three)
    assert f.captures == 1 and f.backend.replays == 3
    assert torch.allclose(outs[2][0], _texel_grad(table * 3.0, idx)[0])
    assert profiling.counter_totals("graphs") == {"calls": 3, "copy_in_bytes": 3 * copy_in,
                                                  "clone_out_bytes": 3 * clone_out}
    assert profiling.counter_totals("scatter") == {"calls": 3, "lanes": 18, "entries": 99}
    profiling.clear_counters()
    f(table, idx)  # no profiler: no record
    assert profiling.counter_totals("graphs") is None
    assert profiling.counter_totals("scatter") is None


def test_graphed_train_step_counts_its_state(stub_graphs, scene_files):  # noqa: F811
    """The texel step's graph copies in and clones out the parameters and
    Adam's state (three sky-sized tensors each way), the target, the key
    and the loss; each replay records its capture's scatters, a dense
    table each."""
    scene = Scene.load(scene_files, device="cpu")
    env = scene.env_params()
    init, step = opt.make_train_step(scene.geometry, scene.material_params(), env,
                                     scene.camera_params(), opt.Adam(LR), height=8, width=8,
                                     spp=1, max_bounce=1, sun_enabled=True)
    params, state = init()
    target = torch.rand(8, 8, 3)
    out = step(params, state, target, opt.iteration_generator(SEED, 0, "cpu"))
    captured = step.graph.last_capture["counts"]["scatter"]
    state_bytes = sum(t.nbytes for t in graphs.flatten((params, state))[0])
    key_bytes = 2 * 4  # two int32 key words
    profiling.clear_counters()
    _profiled(lambda: [step(*out[:2], target, opt.iteration_generator(SEED, i, "cpu"))
                       for i in (1, 2)])
    totals = profiling.counter_totals("graphs")
    assert totals["calls"] == 2
    assert totals["copy_in_bytes"] == 2 * (state_bytes + target.nbytes + key_bytes)
    assert totals["clone_out_bytes"] == 2 * (state_bytes + 4)
    assert 3 * env.ibl.nbytes <= state_bytes
    scatter = profiling.counter_totals("scatter")
    assert scatter == {k: 2 * v for k, v in captured.items()}
    assert scatter["entries"] >= 2 * 2 * env.ibl.numel()  # two sky-sized sums a step
    assert np.isfinite(float(out[2]))
    profiling.clear_counters()
