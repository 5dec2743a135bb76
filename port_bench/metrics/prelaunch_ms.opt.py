"""prelaunch_ms.opt: the host milliseconds from a traced step's start to
its graph's launch: the mean over the traced calls (``port_bench.call``) of
the start of the program's span ``graphs.replay`` less the start of its
span ``train_step`` (``make_train_step``'s step, its key draw included)
inside the call (``utils/profiling.span``, on the profiler's clock).  The
previous step ended synchronised, so the card holds none of this step's
work meanwhile.  The profiler's callbacks inflate the host's time: an upper
end.  Nothing where no call holds both spans (the CPU's eager steps, a
program without them)."""

ROOT = "train_step"


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
