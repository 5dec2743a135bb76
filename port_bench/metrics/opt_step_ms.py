"""opt_step_ms: the window's seconds over the steps it completed, each
step ending with its loss on the host (host clock)."""


def read(run):
    return run.window.per_call() * 1e3
