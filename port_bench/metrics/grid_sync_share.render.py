"""grid_sync_share.render: the share of 2b's time (``csrc/fused_queue.cu``)
that its CUDA blocks spend in grid syncs over the traced renders, in
percent: 100 x the sum of ``sync_cycles`` over the sum of ``kernel_cycles``
in the program's counter record ``"fused_queue"``
(``utils/profiling.counter_totals``), which ``render_radiance_jit`` fills
with a device clone of 2b's stats after each multi-block render made while
the profiler records.  Both are thread 0's ``clock64`` cycles of each CUDA
block, inside ``bq::sync`` and from the kernel's entry to its exit: a ratio
on one SM's clock.  Nothing where the record is empty or the program keeps
none."""


def read(run):
    if run.trace is None:
        return None
    try:
        from ensem3a_openclraytracer_tpu_torch.utils.profiling import counter_totals
    except ImportError:
        return None
    totals = counter_totals("fused_queue")
    if not totals or not totals.get("kernel_cycles"):
        return None
    return 100.0 * totals["sync_cycles"] / totals["kernel_cycles"]
