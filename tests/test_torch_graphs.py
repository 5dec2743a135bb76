"""The port's compiled entry points (``utils/graphs.Graphed``) on the CPU.

Graphs exist only on the card, so here (1) the port's ``render_radiance_jit``
runs eagerly and is held against the JAX package's ``render_radiance_jit``
on the same explicit uniform streams, at the oracle tests' size and fork
bound (``tests/test_oracle_parity.py``); (2) ``Graphed``'s rules are
checked through a stand-in capture backend that takes CPU tensors: its
"capture" runs the function once and its "replay" runs it again on the
graph's own input buffers and writes into the captured outputs, with the
launch counters put back, as a graph replay runs no wrapper; (3)
the entry points that replay graphs on the card (``render_radiance_jit``,
the progressive chunk function, ``make_train_step``'s step,
``make_sharded_renderer``) run through that backend bit-equal to their
eager forms, and ``render_scene(seed=s)`` equals ``render_radiance`` with
a generator seeded ``s``.  The card's own checks are in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 14."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu import testing as jt
from ensem3a_openclraytracer_tpu.models.pathtracer import render_radiance_jit as j_render_jit
from ensem3a_openclraytracer_tpu.scene.scene import build_light_pack as j_light_pack
from ensem3a_openclraytracer_tpu_torch import convert
from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.models import optimize as opt
from ensem3a_openclraytracer_tpu_torch.models import pathtracer as pt
from ensem3a_openclraytracer_tpu_torch.models.progressive import ProgressiveRenderer
from ensem3a_openclraytracer_tpu_torch.ops import launches, rng
from ensem3a_openclraytracer_tpu_torch.parallel.mesh import single_device_mesh
from ensem3a_openclraytracer_tpu_torch.parallel.render import make_sharded_renderer
from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene
from ensem3a_openclraytracer_tpu_torch.utils import graphs
from test_torch_replay import one_torch_thread  # noqa: F401  (an autouse fixture)

RES = 24
SPP = 2
MB = 3

JAX_CASES = {
    "cornell": dict(make=lambda: jt.make_cornell_scene(use_bvh=False), sun=False, spp=2),
    "outdoor30_two_blocks": dict(make=lambda: jt.make_outdoor_scene(n_cubes=30, use_bvh=False),
                                 sun=True, spp=3, res=16),
    "glass_light_nee": dict(make=lambda: jt.make_glass_light_scene(use_bvh=False), sun=False,
                            nee=True, spp=1),
}


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_render_radiance_jit_matches_jax(name):
    """The port's ``render_radiance_jit`` (eager on CPU tensors) against the
    JAX package's on the same scene and explicit streams: pixel forks
    (a channel off by more than 1e-3) below 2 %."""
    case = JAX_CASES[name]
    res, spp = case.get("res", RES), case["spp"]
    jg, jm, je, jc = case["make"]()
    if name.startswith("outdoor"):
        assert jg.feats.block_bounds.shape[0] >= 2
    r = np.random.default_rng(sorted(JAX_CASES).index(name) + 40)
    n = res * res
    nee = case.get("nee", False)
    u = r.random(size=(spp, MB + 1, n, 2), dtype=np.float64).astype(np.float32)
    ul = r.random(size=(spp, MB + 1, n, 3), dtype=np.float64).astype(np.float32) if nee else None
    jl = j_light_pack(jg, jm) if nee else None
    kw = dict(height=res, width=res, spp=spp, max_bounce=MB, sun_enabled=case["sun"], nee=nee)
    ref = np.asarray(j_render_jit(
        jg, jm, je, jc, jax.random.PRNGKey(0), uniforms=jnp.asarray(u), lights=jl,
        light_uniforms=None if ul is None else jnp.asarray(ul), fused=False, **kw))
    g, m, e, c = convert.scene(jg, jm, je, jc, device="cpu")
    img = pt.render_radiance_jit(
        g, m, e, c, uniforms=torch.as_tensor(u), lights=convert.lights(jl, "cpu"),
        light_uniforms=None if ul is None else torch.as_tensor(ul), fused=False, **kw).numpy()
    assert img.shape == ref.shape == (res, res, 3)
    assert np.isfinite(img).all() and img.mean() > 0.0
    frac = float((np.abs(img - ref).max(axis=-1) > 1e-3).mean())
    assert frac < 0.02, f"{name}: pixel forks {frac:.4f}, max diff {np.abs(img - ref).max()}"


# --- Graphed's rules through a stand-in backend --------------------------------------------


class StubGraphs:
    """A capture backend for CPU tensors: ``capture`` runs the function once,
    ``replay`` runs it again on the same (buffer) arguments, writes the
    results into the captured outputs and puts the launch counters back."""

    def __init__(self, fail: bool = False):
        self.fail = fail
        self.warm_ups = self.replays = 0

    @staticmethod
    def takes(device):
        return device.type == "cpu"

    def warm_up(self, run, device):
        self.warm_ups += 1
        return run()

    def capture(self, run, device):
        if self.fail:
            raise RuntimeError("capture refused")
        out = run()
        return (run, out), out, dict(capture_s=0.0, instantiate_s=0.0, pool_bytes=0)

    def replay(self, graph, device):
        run, out = graph
        saved = launches.read()
        new = run()
        launches.restore(saved)
        for dst, src in zip(graphs.flatten(out)[0], graphs.flatten(new)[0]):
            dst.copy_(src)
        self.replays += 1


def _affine(table, x, *, scale: float, bias=None):
    """A function of tensors that counts one launch of the RNG kernel."""
    rng.LAUNCHES["uniforms"] += 1
    out = x * scale + table.sum()
    return (out, {"sum": out.sum()}) if bias is None else (out + bias, {"sum": out.sum()})


def _graphed(**kw):
    backend = StubGraphs(**kw)
    return graphs.Graphed(_affine, in_place=("table",), backend=backend), backend


def test_the_cache_key():
    """Python values and tensor shapes and dtypes key the cache; an in-place
    argument's address does too, a copied argument's values do not."""
    f, _ = _graphed()
    table, x = torch.ones(4), torch.arange(3.0)
    f(table, x, scale=2.0)
    f(table, x + 1, scale=2.0)  # other values in a copied tensor: a replay
    f(table, x.clone(), scale=2.0)  # another copied tensor object: a replay
    assert f.captures == 1
    f(table, x, scale=3.0)  # a new Python value
    assert f.captures == 2
    f(table, torch.arange(5.0), scale=2.0)  # a new shape
    assert f.captures == 3
    f(table, x.double(), scale=2.0)  # a new dtype
    assert f.captures == 4
    f(table.clone(), x, scale=2.0)  # the in-place argument at another address
    assert f.captures == 5
    f(table, x, scale=2.0, bias=torch.zeros(3))  # an optional tensor given
    assert f.captures == 6
    f(table, x + 5, scale=2.0)
    assert f.captures == 6


def test_copies_into_the_graph_buffers_and_reads_in_place():
    """A replay sees the caller's new values of a copied argument, and the
    current contents of an in-place argument's memory."""
    f, backend = _graphed()
    table, x = torch.ones(4), torch.arange(3.0)
    f(table, x, scale=2.0)
    out, extra = f(table, torch.tensor([5.0, 6.0, 7.0]), scale=2.0)
    assert backend.replays == 1
    assert torch.equal(out, torch.tensor([14.0, 16.0, 18.0]))
    assert torch.equal(extra["sum"], torch.tensor(48.0))
    table.fill_(2.0)  # in place: the graph reads this memory itself
    out, _ = f(table, x, scale=2.0)
    assert torch.equal(out, x * 2.0 + 8.0)


def test_outputs_are_clones():
    """The caller never holds the graph's output buffers: a later replay
    leaves an earlier result alone, and so does the first call."""
    f, _ = _graphed()
    table = torch.ones(4)
    first, _ = f(table, torch.zeros(3), scale=1.0)
    second, _ = f(table, torch.ones(3), scale=1.0)
    third, _ = f(table, torch.full((3,), 2.0), scale=1.0)
    assert torch.equal(first, torch.full((3,), 4.0))
    assert torch.equal(second, torch.full((3,), 5.0))
    assert torch.equal(third, torch.full((3,), 6.0))
    entry = next(iter(f._graphs.values()))
    assert all(t.data_ptr() != o.data_ptr() for o in entry.outputs for t in (first, second, third))


def test_launch_counters_advance_on_each_replay():
    """The counters advance where a wrapper launches: the warm-up counts its
    launches, the capture none (it runs no kernel) and a replay none (it
    runs no wrapper; a profiler trace counts its kernels);
    ``last_capture["launches"]`` holds what the graph recorded."""
    f, backend = _graphed()
    table, x = torch.ones(4), torch.arange(3.0)
    before = rng.LAUNCHES["uniforms"]
    f(table, x, scale=1.0)
    assert rng.LAUNCHES["uniforms"] == before + 1
    assert f.last_capture["launches"] == {"uniforms": 1}
    for i in range(3):
        f(table, x, scale=1.0)
        assert rng.LAUNCHES["uniforms"] == before + 1 and backend.replays == i + 1


def test_a_capture_error_propagates():
    """A capture that fails raises from the call, caches nothing and leaves
    the counters as the warm-up set them; the next call tries again."""
    f, backend = _graphed(fail=True)
    table, x = torch.ones(4), torch.arange(3.0)
    before = rng.LAUNCHES["uniforms"]
    with pytest.raises(RuntimeError, match="capture refused"):
        f(table, x, scale=1.0)
    assert f.captures == 0 and not f._graphs
    assert rng.LAUNCHES["uniforms"] == before + 1
    with pytest.raises(RuntimeError, match="capture refused"):
        f(table, x, scale=1.0)
    assert backend.warm_ups == 2


def test_cpu_tensors_run_eagerly_on_the_card_backend():
    """With the default (card) backend, CPU tensors run the function itself:
    no warm-up, no capture, every call counts once."""
    f = graphs.Graphed(_affine, in_place=("table",))
    table, x = torch.ones(4), torch.arange(3.0)
    before = rng.LAUNCHES["uniforms"]
    out, _ = f(table, x, scale=2.0)
    f(table, x, scale=2.0)
    assert f.captures == 0 and not f._graphs
    assert rng.LAUNCHES["uniforms"] == before + 2
    assert torch.equal(out, x * 2.0 + 4.0)


def test_refusals_and_the_graph_bound():
    """A tensor that needs a gradient, tensors on two devices and a value
    that is not a tensor tree raise; at most ``MAX_GRAPHS`` graphs stay."""
    f, _ = _graphed()
    table = torch.ones(4)
    with pytest.raises(ValueError, match="requires grad"):
        f(table, torch.zeros(3, requires_grad=True), scale=1.0)
    with pytest.raises(TypeError, match="not object"):
        f(table, torch.zeros(3), scale=1.0, bias=object())
    with pytest.raises(ValueError, match="one device"):
        f(table, torch.zeros(3, device="meta"), scale=1.0)
    for k in range(graphs.MAX_GRAPHS + 3):
        f(table, torch.zeros(k + 1), scale=1.0)
    assert f.captures == graphs.MAX_GRAPHS + 3 and len(f._graphs) == graphs.MAX_GRAPHS


def _scaled(env, x):
    """A function of a NamedTuple argument whose ``ibl`` field is read in
    place."""
    return x * env.sun_power + env.ibl.sum()


def test_a_named_tuple_field_read_in_place():
    """``in_place=("env.ibl",)``: that field is read where it lies (its
    address keys the cache, its contents are not copied) and the other
    fields are copied."""
    from ensem3a_openclraytracer_tpu_torch.scene.materials import EnvParams

    f = graphs.Graphed(_scaled, in_place=("env.ibl",), backend=StubGraphs())
    env = EnvParams.create(sun_power=2.0, ibl=np.ones((2, 4, 3), np.float32), device="cpu")
    x = torch.ones(3)
    assert torch.equal(f(env, x), torch.full((3,), 26.0))
    entry = next(iter(f._graphs.values()))
    assert len(entry.inputs) == 4  # sun angles, sun power, IBL power, x: not the IBL
    env.ibl.fill_(2.0)  # in place: the replay reads it
    assert torch.equal(f(env._replace(sun_power=torch.tensor(3.0)), x), torch.full((3,), 51.0))
    assert f.captures == 1
    f(env._replace(ibl=env.ibl.clone()), x)  # another IBL: another graph
    assert f.captures == 2


class NullGraphs(StubGraphs):
    """A stand-in whose graph holds nothing of the call's arguments, as a
    CUDA graph holds only their addresses."""

    def capture(self, run, device):
        return None, run(), dict(capture_s=0.0, instantiate_s=0.0, pool_bytes=0)

    def replay(self, graph, device):
        self.replays += 1


def test_a_graph_goes_with_its_in_place_tensors():
    """A graph is dropped, with its memory, when a tensor it reads in place
    is freed; ``clear()`` drops every graph."""
    import gc

    f = graphs.Graphed(_affine, in_place=("table",), backend=NullGraphs())
    keep, x = torch.ones(4), torch.arange(3.0)
    f(keep, x, scale=1.0)
    table = torch.ones(5)
    f(table, x, scale=1.0)
    assert len(f._graphs) == 2
    del table
    gc.collect()
    assert len(f._graphs) == 1
    f(keep, x, scale=1.0)
    assert f.captures == 2 and f.backend.replays == 1
    f.clear()
    assert not f._graphs
    f(keep, x, scale=1.0)
    assert f.captures == 3


def test_the_launch_registry():
    """Every wrapper's ``LAUNCHES`` is in ``ops/launches``; ``reset``,
    ``read`` and ``restore`` act on all of them, and ``count_kernels``
    counts a profiler's device kernel names by counter."""
    from ensem3a_openclraytracer_tpu_torch.experiments import proto_compact, proto_grouped
    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit, fused, pairs, traversal

    mods = (closest_hit, pairs, fused, rng, traversal, proto_grouped, proto_compact)
    assert all(any(m.LAUNCHES is c for c in launches.COUNTERS) for m in mods)
    saved = launches.read()
    assert set(saved) == {"closest_hit", "pairs", "sample_fused", "sample_fused_queue",
                          "uniforms", "bvh_trace", "grouped_pairs", "pair_compact"}
    try:
        launches.reset()
        assert not any(launches.read().values())
        pairs.LAUNCHES["pairs"] += 2
        assert launches.read()["pairs"] == 2
    finally:
        launches.restore(saved)
    assert launches.read() == saved
    names = ["void (anonymous namespace)::pairs_kernel<8>((anonymous namespace)::Params)",
             "grouped_pairs_kernel(float const*, int)",
             "resident_hit_kernel(float const*, float const*, int)",
             "(anonymous namespace)::fused_render_kernel(Params)", "fused_sample_kernel(Params)",
             "void fq::fused_queue_kernel(fq::Params)", "uniforms_kernel(unsigned const*)",
             "bvh_trace_kernel(float const*)", "pair_compact_kernel(float const*)",
             "void at::native::elementwise_kernel<128, 2>(int)", "Memset (Device)",
             "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>(int)"]
    assert launches.count_kernels(names + ["pq::pairs_kernel(pq::Params)"]) == dict(
        closest_hit=1, pairs=2, sample_fused=2, sample_fused_queue=1, uniforms=1, bvh_trace=1,
        grouped_pairs=1, pair_compact=1)
    assert launches.counter_of("pairs_kernel_helper(int)") is None
    assert launches.counter_of("void at::native::elementwise_kernel<128, 2, "
                               "at::native::gpu_kernel_impl<float>(int)::{lambda(int)#1}>"
                               "(int, float)") is None


def test_scene_env_params_keeps_one_ibl(tmp_path):
    """``Scene.env_params()`` gives the same IBL tensor on every call (a
    graphed render reads it in place), and ``EnvParams.create`` keeps a
    float32 tensor on the device as it is."""
    from ensem3a_openclraytracer_tpu_torch.scene.materials import EnvParams

    obj = str(tmp_path / "cornell.obj")
    tt.write_scene_files(obj, *tt.make_cornell_scene(device="cpu"), resolution=8, spp=1,
                         max_bounce=1)
    scene = Scene.load(obj, device="cpu")
    a, b = scene.env_params(), scene.env_params()
    assert a.ibl is b.ibl and a.sun_power is not b.sun_power
    own = scene.env_params(ibl=np.zeros((2, 4, 3), np.float32))
    assert own.ibl.shape == (2, 4, 3) and scene.env_params().ibl is a.ibl
    ibl = torch.zeros((2, 4, 3))
    assert EnvParams.create(ibl=ibl, device="cpu").ibl is ibl


def test_flatten_round_trip():
    """``unflatten(spec, tensors)`` rebuilds what ``flatten`` took apart."""
    g = tt.make_cornell_scene(device="cpu")[0]
    value = (g, [torch.zeros(2), None], {"a": 3, "b": torch.ones(1)}, "tint")
    leaves, spec = graphs.flatten(value)
    back = graphs.unflatten(spec, leaves)
    assert graphs.flatten(back)[1] == spec
    assert back[0].feats.num_tris == g.feats.num_tris and back[3] == "tint"
    assert all(a is b for a, b in zip(graphs.flatten(back)[0], leaves))


# --- the entry points, graphed through the stand-in backend --------------------------------


@pytest.fixture()
def stub_graphs(monkeypatch):
    """Every ``Graphed`` made from now on, and ``render_radiance_jit``'s, on
    the stand-in backend: the entry points take their graph route on the
    CPU."""
    monkeypatch.setattr(graphs, "CudaGraphs", StubGraphs)
    monkeypatch.setattr(pt._RENDER_GRAPHS, "backend", StubGraphs())
    monkeypatch.setattr(pt._RENDER_GRAPHS, "_graphs", type(pt._RENDER_GRAPHS._graphs)())
    monkeypatch.setattr(pt._RENDER_GRAPHS, "captures", 0)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("scene", ["cornell", "outdoor30_nee"])
def test_render_radiance_jit_graph_route_equals_eager(stub_graphs, scene):
    """``render_radiance_jit`` through a capture and two replays (the same
    generator seed, then a new one) equals ``render_radiance`` bit for bit."""
    if scene == "cornell":
        g, m, e, c = tt.make_cornell_scene(device="cpu")
        kw = dict(height=12, width=12, spp=2, max_bounce=2, sun_enabled=False)
    else:
        g, m, e, c = tt.make_outdoor_scene(n_cubes=30, emissive_panel=True, device="cpu")
        from ensem3a_openclraytracer_tpu_torch.scene.scene import build_light_pack
        kw = dict(height=10, width=10, spp=2, max_bounce=2, sun_enabled=True, nee=True,
                  lights=build_light_pack(g, m))
    graph = pt.render_radiance_jit.graph
    for seed in (1, 1, 2):
        img = pt.render_radiance_jit(g, m, e, c, _gen(seed), **kw)
        assert torch.equal(img, pt.render_radiance(g, m, e, c, _gen(seed), **kw))
    assert graph.captures == 1 and graph.backend.replays == 2


def test_render_scene_equals_render_radiance_with_its_seed(tmp_path, stub_graphs):
    """``render_scene(seed=s)`` (now through ``render_radiance_jit``, its key
    drawn before the render) is ``render_radiance`` with a generator seeded
    ``s``, clamped; on a second call it replays."""
    g, m, e, c = tt.make_cornell_scene(device="cpu")
    obj = str(tmp_path / "cornell.obj")
    tt.write_scene_files(obj, g, m, e, c, resolution=10, spp=2, max_bounce=2)
    scene = Scene.load(obj, device="cpu")
    for seed in (4, 5):
        img = pt.render_scene(scene, seed=seed)
        ref = pt.render_radiance(scene.geometry, scene.material_params(), scene.env_params(),
                                 scene.camera_params(), _gen(seed), height=10, width=10, spp=2,
                                 max_bounce=2, sun_enabled=False)
        assert torch.equal(img, torch.clamp(ref, 0.0, 1.0))
    assert pt.render_radiance_jit.graph.captures == 1


def test_render_scene_on_the_cpu_is_eager(tmp_path):
    """Without a stand-in, CPU renders capture nothing."""
    g, m, e, c = tt.make_cornell_scene(device="cpu")
    obj = str(tmp_path / "cornell.obj")
    tt.write_scene_files(obj, g, m, e, c, resolution=8, spp=1, max_bounce=1)
    captures = pt.render_radiance_jit.graph.captures
    img = pt.render_scene(Scene.load(obj, device="cpu"), seed=3)
    assert img.shape == (8, 8, 3) and pt.render_radiance_jit.graph.captures == captures


def test_progressive_graph_route_equals_eager_fold(stub_graphs, tmp_path):
    """A progressive render through the graphed chunk function (captured at
    its first chunk), stopped after two chunks and resumed, equals the
    float64 fold of eager ``render_radiance`` chunks bit for bit."""
    g, m, e, c = tt.make_cornell_scene(device="cpu")
    kw = dict(height=8, width=8, max_bounce=2, chunk_spp=2, sun_enabled=False)
    ckpt = str(tmp_path / "p.npz")
    first = ProgressiveRenderer(g, m, e, c, base_seed=3, **kw)
    first.render(4, checkpoint_path=ckpt)
    assert first._render.graph.captures == 1 and first._render.graph.backend.replays == 1
    resumed = ProgressiveRenderer.resume(ckpt, g, m, e, c, **kw)
    resumed.render(8)
    acc = np.zeros((8, 8, 3))
    for i in range(4):
        chunk = pt.render_radiance(g, m, e, c, opt.iteration_generator(3, i, "cpu"), height=8, width=8,
                                   spp=2, max_bounce=2, sun_enabled=False)
        acc = acc + chunk.numpy().astype(np.float64) * 2
    assert np.array_equal(resumed.state.accum, acc)


def test_train_step_graph_route_equals_eager(stub_graphs):
    """Three chained steps of ``make_train_step``'s step (one capture, then
    replays with each step's inputs copied in) equal ``step.eager``'s bit
    for bit: parameters, Adam state and losses."""
    g, m, e, c = tt.make_cornell_scene(device="cpu")
    init, step = opt.make_train_step(g, m, e, c, opt.Adam(5e-2), height=8, width=8, spp=2,
                                     max_bounce=2, sun_enabled=False)
    target = torch.full((8, 8, 3), 0.2)
    runs = {}
    for label, fn in (("graph", step), ("eager", step.eager)):
        p, st = init()
        out = []
        for i in range(3):
            p, st, loss = fn(p, st, target, opt.iteration_generator(11, i, "cpu"))
            out.append((p, st, loss))
        runs[label] = out
    for a, b in zip(runs["graph"], runs["eager"]):
        la, sa = graphs.flatten(a)
        lb, sb = graphs.flatten(b)
        assert sa == sb and all(torch.equal(x, y) for x, y in zip(la, lb))
    assert step.graph.captures == 1 and step.graph.backend.replays == 2


def test_sharded_renderer_graph_route_equals_eager(stub_graphs):
    """``make_sharded_renderer`` on a 1x1 mesh through its graph equals its
    eager form and ``render_radiance`` with the same seed."""
    g, m, e, c = tt.make_cornell_scene(device="cpu")
    kw = dict(height=8, width=8, spp=2, max_bounce=2, sun_enabled=False)
    fn = make_sharded_renderer(single_device_mesh(), **kw)
    for seed in (9, 9, 10):
        img = fn(g, m, e, c, seed)
        assert torch.equal(img, fn.eager(g, m, e, c, seed))
        assert torch.equal(img, pt.render_radiance(g, m, e, c, _gen(seed), **kw))
    assert fn.graph.captures == 1 and fn.graph.backend.replays == 2


def test_key_stands_in_for_the_generator():
    """``key=`` is the generator's key words: the same image and the same
    replay radiance; a key beside a generator raises."""
    from ensem3a_openclraytracer_tpu_torch.models.replay import radiance_for_rays_replay
    from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays

    g, m, e, c = tt.make_cornell_scene(device="cpu")
    o, d = camera_rays(c.position, c.rotation_deg, c.fov_deg, 8, 8)
    kw = dict(spp=2, max_bounce=2, sun_enabled=False)
    key = rng.key_from_generator(_gen(6), "cpu")
    assert torch.equal(pt.radiance_for_rays(g, m, e, o, d, key=key, **kw),
                       pt.radiance_for_rays(g, m, e, o, d, _gen(6), **kw))
    assert torch.equal(radiance_for_rays_replay(g, m, e, o, d, key=key, **kw),
                       radiance_for_rays_replay(g, m, e, o, d, _gen(6), **kw))
    assert torch.equal(rng.key_from_generator(None, "cpu"), rng.key_from_generator(_gen(0), "cpu"))
    with pytest.raises(ValueError, match="one random source"):
        pt.radiance_for_rays(g, m, e, o, d, _gen(6), key=key, **kw)
    with pytest.raises(ValueError, match="one random source"):
        radiance_for_rays_replay(g, m, e, o, d, _gen(6), key=key, **kw)
