"""pairs_per_segment.render: the (ray, triangle) pairs that 2b
(``csrc/fused_queue.cu``) tested per segment it traced in the traced
renders: the sum of ``pairs`` over the sum of ``segments`` in the program's
counter record ``"fused_queue"`` (``utils/profiling.counter_totals``), which
``render_radiance_jit`` fills with a device clone of 2b's stats after each
multi-block render made while the profiler records.  A segment is a ray
listed for one of a sample's traces (bounce rays with their NEE shadow
rays, sun rays).  Nothing where the record is empty or the program keeps
none."""


def read(run):
    if run.trace is None:
        return None
    try:
        from ensem3a_openclraytracer_tpu_torch.utils.profiling import counter_totals
    except ImportError:
        return None
    totals = counter_totals("fused_queue")
    if not totals or not totals.get("segments"):
        return None
    return totals["pairs"] / totals["segments"]
