"""setup_s: seconds from the start of the run to its first timed call
(host clock): imports, the scene files written and loaded, the kernel
libraries built or loaded, the warm-up and the graph capture."""


def read(run):
    return run.setup_s
