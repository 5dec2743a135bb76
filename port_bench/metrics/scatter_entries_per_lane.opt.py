"""scatter_entries_per_lane.opt: the table entries the gradient's
fixed-point sums write per lane they add (``ops/gathers.scatter_rows``):
``entries`` over ``lanes`` in the program's counter record ``"scatter"``
(``utils/profiling.counter_totals``), over the traced steps.  A sum
writes every entry of its dense table however few lanes reach it, so on
a sky-sized table this is the sweep each scattered lane pays for.  A
captured step's sums run their Python only at the capture;
``utils/graphs.Graphed`` records the capture's counts again at each
replay.  Nothing where the record is empty or the program keeps none."""


def read(run):
    if run.trace is None:
        return None
    try:
        from ensem3a_openclraytracer_tpu_torch.utils.profiling import counter_totals
    except ImportError:
        return None
    totals = counter_totals("scatter")
    if not totals or not totals.get("lanes"):
        return None
    return totals["entries"] / totals["lanes"]
