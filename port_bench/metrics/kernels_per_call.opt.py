"""kernels_per_call.opt: device kernels per traced step, counted in the
profiler's trace: the step's graph replay and its input copies and clones."""

from port_bench.harness.readers import kernels_per_call as read  # noqa: F401
