"""state_copy_gb.opt: gigabytes per traced step that the graph dispatch
(``utils/graphs.Graphed``) copies into its graph's input buffers and
clones out of its outputs: the sum of ``copy_in_bytes`` and
``clone_out_bytes`` in the program's counter record ``"graphs"``
(``utils/profiling.counter_totals``), which ``Graphed`` adds to on each
call made while the profiler records, over the traced calls.  On the
texel step that is the parameters and Adam's two moments in and out, a
sky-sized copy each.  Nothing where the record is empty or the program
keeps none."""


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    try:
        from ensem3a_openclraytracer_tpu_torch.utils.profiling import counter_totals
    except ImportError:
        return None
    totals = counter_totals("graphs")
    if not totals or "copy_in_bytes" not in totals:
        return None
    return (totals["copy_in_bytes"] + totals["clone_out_bytes"]) / 1e9 / len(run.trace.calls)
