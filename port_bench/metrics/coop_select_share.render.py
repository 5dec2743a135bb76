"""coop_select_share.render: the share of 2b's trace rounds
(``csrc/fused_queue.cu``) whose select gave each live ray a group of more
than one lane over the traced renders, in percent: 100 x the sum of
``coop_select_rounds`` over the sum of ``rounds`` in the program's counter
record ``"fused_queue"`` (``utils/profiling.counter_totals``), which
``render_radiance_jit`` fills with a device clone of 2b's stats after each
multi-block render made while the profiler records.  A round's select is
grouped when its live rays are too few to fill the grid's threads
(``ops/pairs.select_lanes``).  Nothing where the record is empty, holds no
rounds, or has no ``coop_select_rounds`` slot (a program that selects with
one thread a ray)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from ensem3a_openclraytracer_tpu_torch.utils.profiling import counter_totals
    except ImportError:
        return None
    totals = counter_totals("fused_queue")
    if not totals or "coop_select_rounds" not in totals or not totals.get("rounds"):
        return None
    return 100.0 * totals["coop_select_rounds"] / totals["rounds"]
