"""split_round_share.render: the share of 2b's trace rounds
(``csrc/fused_queue.cu``) that split their work items into more than one
triangle slice over the traced renders, in percent: 100 x the sum of
``split_rounds`` over the sum of ``rounds`` in the program's counter record
``"fused_queue"`` (``utils/profiling.counter_totals``), which
``render_radiance_jit`` fills with a device clone of 2b's stats after each
multi-block render made while the profiler records.  A round splits when
its (block, chunk) work items are too few to fill the grid
(``ops/pairs.slices``).  Nothing where the record is empty, holds no
rounds, or has no ``split_rounds`` slot (a program that does not slice)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from ensem3a_openclraytracer_tpu_torch.utils.profiling import counter_totals
    except ImportError:
        return None
    totals = counter_totals("fused_queue")
    if not totals or "split_rounds" not in totals or not totals.get("rounds"):
        return None
    return 100.0 * totals["split_rounds"] / totals["rounds"]
