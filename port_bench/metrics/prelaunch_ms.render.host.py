"""prelaunch_ms.render.host: the host milliseconds from a traced render's
start to its graph's launch: the mean over the traced calls
(``port_bench.call``) of the start of the program's span ``graphs.replay``
less the start of its span ``render_scene`` inside the call
(``utils/profiling.span``, on the profiler's clock).  The previous call
ended synchronised, so the card holds none of this call's work meanwhile.
The profiler's callbacks inflate the host's time: an upper end.  Nothing
where no call holds both spans (the CPU's eager renders, a program
without them)."""

ROOT = "render_scene"


def read(run):
    if run.trace is None:
        return None
    gaps = []
    for call in run.trace.calls:
        inside = [h for h in run.trace.host if call.start <= h.start <= call.end]
        roots = [h.start for h in inside if h.name == ROOT]
        replays = [h.start for h in inside if h.name == "graphs.replay"]
        if roots and replays:
            gaps.append(min(replays) - min(roots))
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
