"""A traffic kind, found by name, and what every kind's mix shares.

A traffic mix's data file (``port_bench/traffic/<mix>.json``) names its
``kind``; the kind is the module ``port_bench/kinds/<kind>.py``, which owns
everything that differs between kinds: its ``Mix`` (a subclass of
:class:`Mix`: the set-up, one timed call, what is kept for the comparison
and the comparison itself) and ``readings(cell, seed, device)``, the
control's and the planted faults' numbers at the cell's own size
(``harness/control``).  ``Cell.kind`` finds it by its path in the
checkout, so a kind is added as a new file, with no edit to the harness.
"""

from __future__ import annotations

import gc
import tempfile
import time

import torch

from port_bench.reference import scene as ref_scene
from port_bench.scenes import files


def reference_scene(cell, seed: int, device):
    """The reference's scene of the cell's configuration and seed, from
    scene files written to a temporary directory."""
    with tempfile.TemporaryDirectory(prefix="port_bench_") as d:
        return ref_scene.load(files.write_scene(cell.config, seed, d, device), device)


class Mix:
    """A closed-loop mix of one cell: ``call(i)`` is the ``i``-th timed
    call, ``keep(i, answer)`` sees its answer outside the timed span,
    ``free()`` drops the program's state once the window has closed and
    ``compare()`` returns the numbers that decide ``correct``.

    The base writes the cell's scene files (``self.obj``) and keeps the
    set-up's phases (``phases``: ``(name, host clock)``, printed by the
    run); a kind loads and warms up its program after it."""

    counts = None  # the reference's work per call, where a roofline reads it

    def __init__(self, cell, seed: int, device, directory: str):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.phases = [("start", time.perf_counter())]
        self.obj = files.write_scene(cell.config, seed, directory, device)
        self.mark("files")

    def mark(self, phase: str) -> None:
        self.phases.append((phase, time.perf_counter()))

    def call(self, i: int):
        raise NotImplementedError

    def keep(self, i: int, answer) -> None:
        pass

    def release(self) -> None:
        """Drops the kind's references to the program's state."""

    def free(self) -> None:
        self.release()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_scene(self):
        """The reference's scene, read from the same files as the program's."""
        return ref_scene.load(self.obj, self.device)

    def compare(self) -> dict:
        raise NotImplementedError
