"""The control, the reference computed in the precision below the
configuration's (fp8 for bf16), put in the program's place at the smoke
sizes, fails the cell's limits. portbench/calibrate.py reads the same on
the card at the cells' own sizes."""

import pytest
import torch

from conftest import CELLS
from portbench import calibrate, check
from portbench.harness import Cell


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    torch.set_num_threads(1)
    c = Cell(cell, smoke=True)
    read = calibrate.train_readings if c.traffic["entry"] == "train" \
        else calibrate.serve_readings
    values = read(c, 4000000001, torch.device("cpu"), "control")
    assert set(c.limits) <= set(values)
    assert not check.judge(values, c.limits), values
