"""The control comes out not correct: the solver with its own TF32 path
switched on (the caller's float32 matmuls, which the canonicalization
follows), at a size a test run can hold, on the card.  The solver as the
configuration states it comes out correct at the same size.
``benchmark/control.py`` takes the same readings at a cell's own size."""
import pytest

import control
from harness import spec
from harness.port import Port

CELLS = [w['name'] for w in spec.benchmark()['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_control_is_not_correct(name, card):
    cell = spec.Cell(name)
    port = Port(cell, card)
    for seed in (1, 2, 3):
        r = control.control_reading(cell, port, seed, card, batch=256)
        assert not r['correct'], r


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_program_is_correct_at_the_same_size(name, card):
    cell = spec.Cell(name)
    port = Port(cell, card)
    for seed in (1, 2, 3):
        r = control.program_reading(cell, port, seed, card, batch=256)
        assert r['correct'], r


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_neighbour_variables_are_not_correct(name, card):
    cell = spec.Cell(name)
    port = Port(cell, card)
    for seed in (1, 2, 3):
        r = control.fault_reading(cell, port, seed, card, batch=256)
        assert not r['correct'] and r['var_gap'] > cell.limits()['var_gap']
