"""The check of the check, at tiny sizes on the CPU with each cell's own
limits: the program comes out correct; the control (the reference in TF32
in the program's place) and each fault planted under the timed path do
not."""
import pytest

from qem_bench import faults
from helpers import TINY, tiny_run

CELLS = sorted(TINY)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell):
    res = tiny_run(cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = tiny_run(cell, "control")
    assert not res["correct"], res["checks"]
    assert res["checks"]["ideal_max_err"]["value"] > \
        res["checks"]["ideal_max_err"]["limit"]


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in faults.FAULTS])
def test_fault_is_not_correct(cell, fault):
    res = tiny_run(cell, fault)
    assert not res["correct"], res["checks"]
