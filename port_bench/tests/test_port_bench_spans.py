"""The readers of the program's own spans and counters, on a synthetic
trace and a filled counter record: ``grid_sync_share.render`` and
``pairs_per_segment.render`` read the record ``"fused_queue"``
(``utils/profiling``), ``prelaunch_ms.render.host`` and ``prelaunch_ms.opt``
the spans ``render_scene`` / ``train_step`` and ``graphs.replay`` inside
each traced call.  Each reads nothing where there is nothing."""

import types

import pytest
import torch

from port_bench.harness.cells import Cell
from port_bench.harness.trace import Span, TraceRead


@pytest.fixture
def record():
    from ensem3a_openclraytracer_tpu_torch.utils import profiling

    profiling.clear_counters()
    yield profiling
    profiling.clear_counters()


def _run(trace):
    return types.SimpleNamespace(trace=trace)


def _trace(root: str, offsets_ms) -> TraceRead:
    """Calls 1 s apart; in call j the span ``root`` starts 2 ms in and
    ``graphs.replay`` ``offsets_ms[j]`` later, with other host spans."""
    calls, host = [], []
    for j, off in enumerate(offsets_ms):
        t = 10.0 + j
        calls.append(Span("port_bench.call", t, t + 0.5))
        host += [Span(root, t + 0.002, t + 0.4), Span("graphs.call", t + 0.003, t + 0.39),
                 Span("graphs.replay", t + 0.002 + off * 1e-3, t + 0.38),
                 Span("aten::copy_", t + 0.0025, t + 0.0026)]
    host.append(Span(root, 30.0, 30.1))  # outside every call: not read
    return TraceRead(calls=calls, device=[], host=host)


@pytest.mark.parametrize("cell,metric,root", [
    ("cornell.render", "prelaunch_ms.render.host", "render_scene"),
    ("outdoor15k.tree", "prelaunch_ms.render.host", "render_scene"),
    ("cornell.optimize", "prelaunch_ms.opt", "train_step"),
])
def test_prelaunch_is_the_mean_start_gap_inside_each_call(cell, metric, root):
    read = Cell(cell).reader(metric)
    assert read(_run(_trace(root, [0.5, 1.0, 1.5]))) == pytest.approx(1.0, abs=1e-6)
    other = "train_step" if root == "render_scene" else "render_scene"
    assert read(_run(_trace(other, [0.5]))) is None  # the other entry's spans
    eager = _trace(root, [0.5])
    eager.host = [h for h in eager.host if h.name != "graphs.replay"]  # the CPU: no replay
    assert read(_run(eager)) is None
    assert read(_run(None)) is None


def test_counter_readers_read_the_fused_queue_record(record):
    sync = Cell("outdoor15k.render").reader("grid_sync_share.render")
    pairs = Cell("outdoor15k.render").reader("pairs_per_segment.render")
    run = _run(TraceRead(calls=[Span("port_bench.call", 0.0, 1.0)], device=[], host=[]))
    assert sync(run) is None and pairs(run) is None  # nothing recorded
    from ensem3a_openclraytracer_tpu_torch.ops.fused import queue_stats_fields

    fields = queue_stats_fields(1)
    for pairs_tested, segments, sync_c, kernel_c in ((900, 10, 30, 100), (1500, 20, 10, 100)):
        named = dict.fromkeys(fields, 0)
        named.update(pairs=pairs_tested, segments=segments, sync_cycles=sync_c,
                     kernel_cycles=kernel_c)
        record.record_counters("fused_queue", torch.tensor([named[f] for f in fields]), fields)
    assert sync(run) == pytest.approx(20.0)
    assert pairs(run) == pytest.approx(80.0)
    assert sync(_run(None)) is None and pairs(_run(None)) is None


NEW = {"cornell.render": {"prelaunch_ms.render.host"},
       "outdoor15k.tree": {"prelaunch_ms.render.host"},
       "outdoor15k.render": {"grid_sync_share.render", "pairs_per_segment.render"},
       "cornell.optimize": {"prelaunch_ms.opt"}}


@pytest.mark.parametrize("name", sorted(NEW))
def test_the_span_metrics_are_reported_in_their_cells_alone(name):
    cell = Cell(name)
    traced = {m["name"] for m in cell.metrics(True)}
    assert NEW[name] <= traced
    assert not (set().union(*NEW.values()) - NEW[name]) & traced
    for m in NEW[name]:
        assert callable(cell.reader(m))
