"""kernels_per_call.render.host: device kernels per traced render, counted in the
profiler's trace: what a graph replay dispatches, at about 1.35 us a node."""

from port_bench.harness.readers import kernels_per_call as read  # noqa: F401
