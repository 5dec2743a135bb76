"""The reader of ``subtile_share.render`` on filled counter records:
100 x ``subtiles_tested`` / ``subtiles_offered`` over the record
``"fused_queue"`` (``utils/profiling``); nothing where nothing is recorded,
where the record has no such slots (a program whose test phase tests every
triangle of a queued block), where it offers no entry, or where no trace
was taken.  The metric is reported in the two render cells of 2b."""

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


def test_subtile_share_reads_the_fused_queue_record(record):
    from ensem3a_openclraytracer_tpu_torch.ops.fused import queue_stats_fields

    read = Cell("closedbox15k.nee").reader("subtile_share.render")
    assert read(_run()) is None  # nothing recorded
    fields = queue_stats_fields(4)
    _keep(record, fields, subtiles_offered=800, subtiles_tested=150, pairs=4800)
    _keep(record, fields, subtiles_offered=200, subtiles_tested=50, pairs=1600)
    assert read(_run()) == pytest.approx(20.0)
    assert read(_run(traced=False)) is None


def test_subtile_share_reads_nothing_without_the_slots_or_entries(record):
    read = Cell("outdoor15k.render").reader("subtile_share.render")
    old = ("pairs", "stagings", "rounds", "slabs", "syncs", "segments", "split_rounds",
           "items", "coop_select_rounds", "nee_rays", "escape_lookups")  # the parent's slots
    _keep(record, old, rounds=22, pairs=100, segments=10)
    assert read(_run()) is None
    record.clear_counters()
    _keep(record, old + ("subtiles_offered", "subtiles_tested"), rounds=3)
    assert read(_run()) is None


@pytest.mark.parametrize("name", ["outdoor15k.render", "closedbox15k.nee", "cornell.render",
                                  "cornell.optimize", "outdoor15k.tree", "texel8k.grad"])
def test_subtile_share_is_reported_in_the_render_cells_of_2b(name):
    traced = {m["name"] for m in Cell(name).metrics(True)}
    assert ("subtile_share.render" in traced) == (name in ("outdoor15k.render",
                                                           "closedbox15k.nee"))
