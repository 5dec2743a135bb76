"""The control, the reference computed in bfloat16 in the program's place,
and the faults planted in the reference, come out over each cell's limits:
on the CPU at 16^2, and on the card at the cell's own size."""

import pytest

from port_bench.harness import control
from port_bench.harness.cells import Cell

CELLS = ["cornell.render", "outdoor15k.render", "cornell.optimize", "outdoor15k.tree"]


def fails(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_at_a_small_size(tiny_root, name):
    cell = Cell(name, tiny_root)
    for kind, numbers in control.readings(cell, 2147483653, "cpu").items():
        assert fails(numbers, cell.settings["limits"]), (kind, numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    cell = Cell(name)
    for kind, numbers in control.readings(cell, 2147483655, card).items():
        assert fails(numbers, cell.settings["limits"]), (kind, numbers)
