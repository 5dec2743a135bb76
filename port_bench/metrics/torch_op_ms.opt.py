"""torch_op_ms.opt: device milliseconds per traced step in kernels that the
registry of the program's launch counters (``ops/launches.KERNELS``) does
not name as the port's own: the replay's forward and backward, the
fixed-point gradient sums, Adam and the clamps."""

from port_bench.harness.trace import kernel_function


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    other = sum(k.seconds for k in run.trace.kernels_in_window()
                if kernel_function(k.name) not in run.program_kernels)
    return 1e3 * other / len(run.trace.calls)
