"""The readings that set the upper end of each limit: the control and the
faults, at a cell's own size, with no program in the loop.

The control is the reference computed in bfloat16, the precision below
the configuration's float32, put in the program's place.  The faults are
planted in the reference put in the program's place; which ones a cell
reads is its traffic kind's (``port_bench/kinds/<kind>.py``, ``readings``).
The four-chip fault, an exchange left out, does not apply: every cell
takes one chip.

    python3 -m port_bench.harness.control <cell> <seed> [<seed> ...]

prints one JSON line of readings per seed; no benchmark run calls it.
"""

from __future__ import annotations

import json
import sys

from port_bench.harness.cells import Cell


def readings(cell: Cell, seed: int, device="cuda") -> dict:
    """The control's and the faults' numbers for one seed."""
    return cell.kind().readings(cell, seed, device)


if __name__ == "__main__":
    for s in sys.argv[2:]:
        numbers = readings(Cell(sys.argv[1]), int(s))
        print(json.dumps({"cell": sys.argv[1], "seed": int(s), **numbers}), flush=True)
