"""lights_ms.render: the host milliseconds a traced render spends building
its NEE light table: the mean over the traced calls (``port_bench.call``)
of the summed length of the program's span ``render_scene.lights`` inside
the call (``utils/profiling.span``, on the profiler's clock), which
``render_scene`` opens around ``Scene.light_pack`` (the emissive faces
found by a Morton sort of every face on the host, then copied to the
card).  The profiler's callbacks inflate the host's time: an upper end.
Nothing where no call holds the span (a render without NEE, a program
without it)."""

SPAN = "render_scene.lights"


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    per_call = []
    for call in run.trace.calls:
        inside = [h.seconds for h in run.trace.host
                  if h.name == SPAN and call.start <= h.start <= call.end]
        if inside:
            per_call.append(sum(inside))
    return 1e3 * sum(per_call) / len(per_call) if per_call else None
