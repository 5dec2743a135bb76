"""The arithmetic of the metrics, shared by the readers in
``port_bench/metrics/`` (one file per metric name, found by
``harness/cells.Cell.reader``).  Each takes the run (window, set-up, mix,
trace) and returns nothing where it has nothing to read."""

from __future__ import annotations

from port_bench.harness.counts import least_seconds


def mrays_per_s(run):
    """Ray segments of every call in the window over its seconds, in millions."""
    return run.window.rate(run.mix.work_per_call) / 1e6


def p95_ms(run):
    """The 95th percentile of every call's latency in the window."""
    return run.window.percentile(95) * 1e3


def idle_share(run):
    """The device's idle share of the traced calls' span, in percent."""
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * run.trace.idle_share


def kernels_per_call(run):
    """Device kernels per traced call."""
    if run.trace is None or not run.trace.kernels:
        return None
    return len(run.trace.kernels_in_window()) / len(run.trace.calls)


def roofline(run):
    """The least time of a render's work over device-busy time per traced
    render, in percent (``harness/counts.least_seconds``)."""
    c = run.mix.counts
    if run.trace is None or c is None or run.trace.busy_s <= 0:
        return None
    busy_per_call = run.trace.busy_s / len(run.trace.calls)
    return 100.0 * least_seconds(c["segments"], c["lanes"], c["sun"], c["bytes"]) / busy_per_call
