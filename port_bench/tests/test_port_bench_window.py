"""The window's arithmetic: a rate over the whole window, a percentile over
every call, the device's idle share as the union of its spans, and a stall
that moves all three."""

import pytest

from port_bench.harness import trace
from port_bench.harness.window import Reservoir, Window, closed_loop


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def run_calls(durations, seconds):
    clock = FakeClock()
    it = iter(durations)

    def call(i):
        clock.t += next(it)
        return i

    return closed_loop(call, seconds, clock=clock)


def test_rate_is_all_the_work_over_all_the_time():
    w = run_calls([0.125] * 20, 1.0)
    assert w.calls == 8 and w.seconds == pytest.approx(1.0)
    assert w.rate(50.0) == pytest.approx(400.0)
    assert w.per_call() == pytest.approx(0.125)


def test_p95_is_over_every_call():
    lat = [0.01] * 95 + [0.5] * 5
    w = Window(latencies=lat, start=0.0, end=sum(lat))
    assert 0.01 < w.percentile(95) <= 0.5
    assert w.percentile(50) == pytest.approx(0.01)


def synthetic(calls, kernels, host=()):
    return trace.TraceRead(
        calls=[trace.Span(trace.CALL, a, b) for a, b in calls],
        device=[trace.Span("k", a, b) for a, b in kernels],
        host=[trace.Span(n, a, b) for n, a, b in host],
        kernels=[trace.Span("k", a, b) for a, b in kernels])


def test_idle_is_the_window_less_the_union_of_device_spans():
    # overlapping kernels count once; a kernel outside the window is left out
    tr = synthetic([(0.0, 1.0), (1.0, 2.0)],
                   [(0.1, 0.5), (0.3, 0.9), (1.2, 1.8), (2.5, 3.0)],
                   [("cudaGraphLaunch", 0.9, 1.2)])
    assert tr.window_s == pytest.approx(2.0)
    assert tr.busy_s == pytest.approx(0.8 + 0.6)
    assert tr.idle_share == pytest.approx(0.3)
    assert len(tr.kernels_in_window()) == 3
    gaps = tr.breakdown()["idle_gaps"]
    assert gaps[0] == ["cudaGraphLaunch", pytest.approx(0.3)]
    assert sum(g for _, g in gaps) == pytest.approx(0.6)


def test_a_stall_moves_rate_tail_and_idle_share():
    steady = run_calls([0.125] * 40, 2.0)
    stalled = run_calls([0.125] * 10 + [0.625] + [0.125] * 40, 2.0)
    assert stalled.rate(1.0) < steady.rate(1.0)
    assert stalled.percentile(95) > steady.percentile(95)
    busy = [(0.02 + 0.1 * i, 0.1 * (i + 1)) for i in range(20)]
    quiet = synthetic([(0.0, 1.0), (1.0, 2.0)], busy)
    late = [(a + 0.5, b + 0.5) if a > 1 else (a, b) for a, b in busy]  # the device waits 0.5 s
    gap = synthetic([(0.0, 1.0), (1.0, 2.5)], late)
    assert gap.idle_share > quiet.idle_share


def test_reservoir_keeps_k_answers_drawn_from_the_seed():
    picks = []
    for _ in range(2):
        r = Reservoir(3, seed=9)
        for i in range(100):
            r.offer(i)
        picks.append(sorted(r.items))
    assert picks[0] == picks[1] and len(picks[0]) == 3
