"""The reader of ``select_share.render`` on filled counter records: 100 x
``select_cycles`` / ``kernel_cycles`` over the record ``"fused_queue"``
(``utils/profiling``); nothing where nothing is recorded, where the record
has no ``select_cycles`` slot (a program that does not time its selects),
where it counts no kernel cycles, or where no trace was taken.  The metric
is reported in the three render cells of 2b."""

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


def _run(traced=True):
    trace = TraceRead(calls=[Span("port_bench.call", 0.0, 1.0)], device=[], host=[])
    return types.SimpleNamespace(trace=trace if traced else None)


def _keep(record, fields, **counts):
    named = dict.fromkeys(fields, 0)
    named.update(counts)
    record.record_counters("fused_queue", torch.tensor([named[f] for f in fields]), fields)


def test_select_share_reads_the_fused_queue_record(record):
    from ensem3a_openclraytracer_tpu_torch.ops.fused import queue_stats_fields

    read = Cell("outdoor600k.render").reader("select_share.render")
    assert read(_run()) is None  # nothing recorded
    fields = queue_stats_fields(4)
    _keep(record, fields, select_cycles=300, kernel_cycles=1000, sync_cycles=500)
    _keep(record, fields, select_cycles=100, kernel_cycles=1000, sync_cycles=200)
    assert read(_run()) == pytest.approx(20.0)
    assert read(_run(traced=False)) is None


def test_select_share_reads_nothing_without_the_slot_or_cycles(record):
    read = Cell("outdoor15k.render").reader("select_share.render")
    old = ("pairs", "stagings", "rounds", "slabs", "syncs", "segments", "sync_cycles",
           "kernel_cycles", "shade_cycles", "bounce_trace_cycles", "resolve_cycles",
           "sun_trace_cycles", "finish_cycles", "split_rounds", "items", "coop_select_rounds",
           "nee_rays", "subtiles_offered", "subtiles_tested", "escape_lookups")  # the parent's
    _keep(record, old, rounds=22, kernel_cycles=1000, sync_cycles=500)
    assert read(_run()) is None
    record.clear_counters()
    _keep(record, old + ("select_cycles",), rounds=3)  # the plain version's: no cycles
    assert read(_run()) is None


@pytest.mark.parametrize("name", ["outdoor15k.render", "closedbox15k.nee", "outdoor600k.render",
                                  "cornell.render", "cornell.optimize", "outdoor15k.tree",
                                  "texel8k.grad"])
def test_select_share_is_reported_in_the_render_cells_of_2b(name):
    traced = {m["name"] for m in Cell(name).metrics(True)}
    assert ("select_share.render" in traced) == (name in ("outdoor15k.render",
                                                          "closedbox15k.nee",
                                                          "outdoor600k.render"))
