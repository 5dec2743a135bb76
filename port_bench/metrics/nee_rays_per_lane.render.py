"""nee_rays_per_lane.render: the NEE shadow rays that 2b
(``csrc/fused_queue.cu``) listed per bounce lane it traced over the traced
renders: the sum of ``nee_rays`` over the sum of ``lanes.<b>`` (every
bounce ``b``) in the program's counter record ``"fused_queue"``
(``utils/profiling.counter_totals``), which ``render_radiance_jit`` fills
with a device clone of 2b's stats after each multi-block render made
while the profiler records.  A lane lists a NEE ray where its vertex
samples the light and faces the light point; ``lanes.<b>`` counts every
ray listed for bounce ``b``'s traces, NEE rays among them.  A change can
lower it only by listing fewer rays whose contribution is exactly zero.
Nothing where the record is empty, holds no lanes, or has no ``nee_rays``
slot (a program that does not count them)."""


def read(run):
    if run.trace is None:
        return None
    try:
        from ensem3a_openclraytracer_tpu_torch.utils.profiling import counter_totals
    except ImportError:
        return None
    totals = counter_totals("fused_queue")
    if not totals or "nee_rays" not in totals:
        return None
    lanes = sum(v for k, v in totals.items() if k.startswith("lanes."))
    if not lanes:
        return None
    return totals["nee_rays"] / lanes
