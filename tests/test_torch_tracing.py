"""Spans and counters inside the port (``utils/profiling``) on the CPU.

A span is a ``torch.profiler.record_function`` while a profiler records and
the one shared no-op context otherwise; the entry points (``render_scene``,
``render_radiance_jit``) and ``utils/graphs.Graphed`` open theirs around
the code that runs on every call, nested by the parent link.  2b's counter
buffer (``ops/fused.render_stats``) is counted here by its plain version,
``sample_fused_plain``: segments traced and the segments of each bounce.
The card's counts and cycles are checked in ``chip_smoke.py`` phase 5."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.models import pathtracer as pt
from ensem3a_openclraytracer_tpu_torch.ops import fused as tf
from ensem3a_openclraytracer_tpu_torch.scene.scene import Scene
from ensem3a_openclraytracer_tpu_torch.utils import graphs, profiling
from test_torch_fused import _port_args
from test_torch_graphs import StubGraphs, stub_graphs  # noqa: F401  (a fixture)
from test_torch_replay import one_torch_thread  # noqa: F401  (an autouse fixture)

MB = 2
GRAPH_SPANS = ("graphs.key", "graphs.copy_in", "graphs.replay", "graphs.clone_out",
               "graphs.warm_up", "graphs.capture", "graphs.eager")


@pytest.fixture(autouse=True)
def empty_record():
    profiling.clear_counters()
    yield
    profiling.clear_counters()


def _profiled(fn):
    """``fn()``'s result and the profiler's events (``FunctionEvent``s,
    each with its parent) while it runs."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, list(prof.events())


def _named(events, name):
    return [e for e in events if e.name == name]


def _parent(event, name):
    """Whether an enclosing span of ``event`` is named ``name``."""
    p = event.cpu_parent
    while p is not None:
        if p.name == name:
            return True
        p = p.cpu_parent
    return False


def _scene(tmp_path, name="cornell"):
    if name == "cornell":
        g, m, e, c = tt.make_cornell_scene(device="cpu")
    else:
        g, m, e, c = tt.make_outdoor_scene(n_cubes=24, device="cpu")
    obj = str(tmp_path / f"{name}.obj")
    tt.write_scene_files(obj, g, m, e, c, resolution=8, spp=1, max_bounce=MB)
    return Scene.load(obj, device="cpu")


def test_no_profiler_no_span_and_no_record(tmp_path):
    """With no profiler a span is the shared no-op (no object made), and a
    CPU ``render_scene`` keeps no counters."""
    assert not profiling.recording()
    assert profiling.span("render_scene") is profiling.NO_SPAN
    assert profiling.span("graphs.replay") is profiling.NO_SPAN
    with profiling.span("x") as inside:
        assert inside is None
    pt.render_scene(_scene(tmp_path, "outdoor"), seed=1, overrides={"fused": True})
    assert profiling.counter_totals("fused_queue") is None


def test_render_scene_spans_nest(tmp_path):
    """Under the profiler a CPU ``render_scene`` gives ``render_scene`` ⊃
    ``render_scene.settings``, and ``render_scene`` ⊃ ``render_radiance_jit``
    ⊃ ``graphs.call`` ⊃ ``graphs.key``, ``graphs.eager``."""
    scene = _scene(tmp_path)
    img, events = _profiled(lambda: pt.render_scene(scene, seed=2))
    assert torch.equal(img, pt.render_scene(scene, seed=2))  # tracing changes nothing
    (top,) = _named(events, "render_scene")
    (settings,) = _named(events, "render_scene.settings")
    (entry,) = _named(events, "render_radiance_jit")
    (call,) = _named(events, "graphs.call")
    assert settings.cpu_parent is top and entry.cpu_parent is top and call.cpu_parent is entry
    for name in ("graphs.key", "graphs.eager"):
        (ev,) = _named(events, name)
        assert ev.cpu_parent is call
    assert not any(_named(events, n) for n in GRAPH_SPANS[1:6])  # nothing captured on the CPU


def test_scene_load_opens_the_parse_span(tmp_path):
    """Under the profiler ``Scene.load`` names its OBJ parse
    ``scene.load.parse``, once, outside any other span."""
    _scene(tmp_path, "outdoor")
    obj = str(tmp_path / "outdoor.obj")
    scene, events = _profiled(lambda: Scene.load(obj, device="cpu"))
    (parse,) = _named(events, "scene.load.parse")
    assert parse.cpu_parent is None and scene.num_tris == 12 * 24 + 2


def test_graphed_spans_capture_then_replay(monkeypatch):
    """Through the stand-in backend the first call gives ``graphs.warm_up``
    then ``graphs.capture``, a later one ``graphs.key``, ``graphs.copy_in``,
    ``graphs.replay``, ``graphs.clone_out`` in that order, each inside
    ``graphs.call``; a profiled call captures nothing new, and with no
    profiler no span is made at all."""
    f = graphs.Graphed(lambda x, *, k: x * k + 1.0, backend=StubGraphs())
    x = torch.arange(4.0)
    _, first = _profiled(lambda: f(x, k=2))
    assert f.captures == 1
    order = [e.name for e in first if e.name.startswith("graphs.")]
    assert order == ["graphs.call", "graphs.key", "graphs.warm_up", "graphs.capture"]
    out, again = _profiled(lambda: f(x + 1.0, k=2))
    assert torch.equal(out, (x + 1.0) * 2 + 1.0) and f.captures == 1
    spans = [e for e in again if e.name.startswith("graphs.") and e.name != "graphs.call"]
    assert [e.name for e in spans] == list(GRAPH_SPANS[:4])
    (call,) = _named(again, "graphs.call")
    assert all(e.cpu_parent is call for e in spans)
    assert [e.time_range.start for e in spans] == sorted(e.time_range.start for e in spans)

    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda n: made.append(n) or real(n))
    assert torch.equal(f(x, k=2), x * 2 + 1.0) and f.captures == 1
    assert made == []


def test_stage_timer_opens_its_span():
    """``StageTimer.stage`` is a span too: the CLI's stages appear in
    ``cli --profile`` traces, the stage's work inside them."""
    timer = profiling.StageTimer()

    def staged():
        with timer.stage("scene_load"):
            return torch.ones(2).sum()

    _, events = _profiled(staged)
    assert len(_named(events, "scene_load")) == 1
    assert any(_parent(e, "scene_load") for e in _named(events, "aten::sum"))
    assert timer.counts["scene_load"] == 1


@pytest.mark.parametrize("nee", [False, True])
def test_plain_sample_counts_segments_by_bounce(nee):
    """On two blocks ``sample_fused_plain`` counts as segments the lanes it
    traces (the rays of each trace loop: bounce and NEE rays, then sun
    rays), by bounce, the slots summing to the total; the syncs and cycles,
    the kernel's alone, stay 0."""
    g, m, e, c = tt.make_outdoor_scene(n_cubes=24, emissive_panel=nee, device="cpu")
    assert g.feats.block_bounds.shape[0] == 2
    args, _, _ = _port_args(g, m, e, c, res=8, permute=True)
    from ensem3a_openclraytracer_tpu_torch.scene.scene import build_light_pack

    kw = dict(max_bounce=MB, sun_enabled=True, nee=nee,
              lights=build_light_pack(g, m) if nee else None,
              uniforms=torch.rand((MB + 1, 64, 5 if nee else 2),
                                  generator=torch.Generator().manual_seed(7)))
    stats, traces = torch.zeros(tf.queue_stats_len(MB), dtype=torch.int64), []
    tf.sample_fused_plain(*args, stats=stats, traces=traces, **kw)
    named = dict(zip(tf.queue_stats_fields(MB), stats.tolist()))
    lanes = [o.shape[0] for o, _, _ in traces]
    assert len(lanes) == 2 * (MB + 1)  # bounce (+ NEE), then sun, per bounce
    per_bounce = [named[f"lanes.{b}"] for b in range(MB + 1)]
    assert per_bounce == [lanes[2 * b] + lanes[2 * b + 1] for b in range(MB + 1)]
    assert named["segments"] == sum(lanes) == sum(per_bounce) > 0
    assert per_bounce[0] >= per_bounce[-1]  # lanes only die
    assert named["pairs"] > 0 and named["syncs"] == 0
    assert all(v == 0 for k, v in named.items() if k.endswith("cycles"))
    with pytest.raises(ValueError, match="stats"):
        tf.sample_fused_plain(*args, stats=torch.zeros(5, dtype=torch.int64), **kw)


def test_counter_record_sums_clones_by_field():
    """``record_counters`` keeps clones (later writes to the buffer do not
    reach them); ``counter_totals`` sums them field by field, fields of
    other records included; ``clear_counters`` empties the record."""
    buf = torch.tensor([1, 2, 3])
    profiling.record_counters("k", buf, ("a", "b", "lanes.0"))
    buf += 10
    profiling.record_counters("k", torch.tensor([5, 6, 7, 8]), ("a", "b", "lanes.0", "lanes.1"))
    assert profiling.counter_totals("k") == {"a": 6, "b": 8, "lanes.0": 10, "lanes.1": 8}
    assert profiling.counter_totals("other") is None
    with pytest.raises(ValueError):
        profiling.record_counters("k", buf, ("a", "b"))
    profiling.clear_counters()
    assert profiling.counter_totals("k") is None


def test_render_records_2b_counters_only_when_traced(stub_graphs):
    """A multi-block fused render through ``render_radiance_jit`` (the
    stand-in graphs) writes ``render_stats``; a profiled replay keeps a
    clone under ``"fused_queue"`` equal to what the eager render counted,
    captures nothing, and keeps the graph; unprofiled calls keep none."""
    g, m, e, c = tt.make_outdoor_scene(n_cubes=24, device="cpu")
    kw = dict(height=6, width=6, spp=2, max_bounce=MB, sun_enabled=True, fused=True)
    gen = lambda: torch.Generator().manual_seed(5)
    pt.render_radiance(g, m, e, c, gen(), **kw)
    eager = tf.render_stats("cpu", MB).tolist()
    graph = pt.render_radiance_jit.graph
    for _ in range(2):
        pt.render_radiance_jit(g, m, e, c, gen(), **kw)
    assert graph.captures == 1 and profiling.counter_totals("fused_queue") is None
    tf.render_stats("cpu", MB).fill_(-1)
    img, _ = _profiled(lambda: pt.render_radiance_jit(g, m, e, c, gen(), **kw))
    assert graph.captures == 1 and graph.backend.replays == 2
    assert torch.equal(img, pt.render_radiance(g, m, e, c, gen(), **kw))
    totals = profiling.counter_totals("fused_queue")
    assert list(totals) == list(tf.queue_stats_fields(MB))
    assert list(totals.values()) == eager and totals["segments"] > 0
    pt.render_radiance_jit(g, m, e, c, gen(), **{**kw, "fused": False})  # the scan estimator
    _profiled(lambda: pt.render_radiance_jit(g, m, e, c, gen(), **{**kw, "fused": False}))
    assert profiling.counter_totals("fused_queue") == totals
