"""The reader of ``coop_select_share.render`` on filled counter records:
100 x ``coop_select_rounds`` / ``rounds`` over the record ``"fused_queue"``
(``utils/profiling``); nothing where nothing is recorded, where the
record has no ``coop_select_rounds`` slot (a program that selects with one
thread a ray), where it holds no rounds, or where no trace was taken.  The
metric is reported in ``outdoor15k.render`` alone."""

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


def test_coop_select_share_reads_the_fused_queue_record(record):
    from ensem3a_openclraytracer_tpu_torch.ops.fused import queue_stats_fields

    read = Cell("outdoor15k.render").reader("coop_select_share.render")
    assert read(_run()) is None  # nothing recorded
    fields = queue_stats_fields(4)
    _keep(record, fields, rounds=23, coop_select_rounds=21, split_rounds=20)
    _keep(record, fields, rounds=17, coop_select_rounds=9, split_rounds=10)
    assert read(_run()) == pytest.approx(75.0)
    assert read(_run(traced=False)) is None


def test_coop_select_share_reads_nothing_without_the_slot_or_rounds(record):
    read = Cell("outdoor15k.render").reader("coop_select_share.render")
    old = ("pairs", "stagings", "rounds", "slabs", "syncs", "segments", "split_rounds",
           "items")  # the parent's slots: no coop_select_rounds
    _keep(record, old, rounds=22, split_rounds=20, pairs=100)
    assert read(_run()) is None
    record.clear_counters()
    _keep(record, old + ("coop_select_rounds",), rounds=0)
    assert read(_run()) is None


@pytest.mark.parametrize("name", ["outdoor15k.render", "cornell.render", "cornell.optimize",
                                  "outdoor15k.tree", "texel8k.grad"])
def test_coop_select_share_is_reported_in_the_queue_cell_alone(name):
    traced = {m["name"] for m in Cell(name).metrics(True)}
    assert ("coop_select_share.render" in traced) == (name == "outdoor15k.render")
