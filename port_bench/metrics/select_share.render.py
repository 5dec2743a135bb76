"""select_share.render: the share of 2b's cycles (``csrc/fused_queue.cu``)
spent in its trace rounds' selects over the traced renders, in percent: 100
x the sum of ``select_cycles`` over the sum of ``kernel_cycles`` in the
program's counter record ``"fused_queue"`` (``utils/profiling.counter_totals``),
which ``render_radiance_jit`` fills with a device clone of 2b's stats after
each multi-block render made while the profiler records.  Both are sums over
CUDA blocks of thread 0's clock: ``select_cycles`` from each round's start,
the block bounds' staging included, to the end of the grid sync that ends
its select (one thread a ray, or groups of lanes), so that a block with few
rays counts its wait for the slowest and each block's sum is the selects'
wall time; ``kernel_cycles`` from the kernel's entry to its exit.  The
ratio is the share of 2b's wall time spent selecting.  Nothing where the record is empty, counts no kernel
cycles, or has no ``select_cycles`` slot (a program that does not time its
selects)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from ensem3a_openclraytracer_tpu_torch.utils.profiling import counter_totals
    except ImportError:
        return None
    totals = counter_totals("fused_queue")
    if not totals or "select_cycles" not in totals or not totals.get("kernel_cycles"):
        return None
    return 100.0 * totals["select_cycles"] / totals["kernel_cycles"]
