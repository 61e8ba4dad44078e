"""A run with the timed path broken underneath must come out not
``correct``: each fault a cell can have (``harness/faults.py``), planted
in the program, at smoke size on the CPU (the harness's look for a card
skipped)."""
import pytest

from portbench.harness import faults, runtime
from portbench.tests.pb_smoke import run_smoke

CASES = [(w["name"], f) for w in runtime.benchmark()["workloads"]
         for f in faults.names(w["name"])]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails_the_check(cell, fault):
    undo = faults.plant(fault, cell)
    try:
        result, checks = run_smoke(cell)
    finally:
        undo()
    assert not result["correct"], checks
