"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have (portbench/faults.py), planted in the program,
with the rest of the run driven as the benchmark drives it."""

import pytest

from portbench import faults

CASES = [("unet_train_b128", "unchanged"), ("unet_train_b128", "half_batch"),
         ("cyclegan_train_b16", "unchanged"),
         ("cyclegan_train_b16", "half_batch"),
         ("cyclegan_train_b16", "pool_noswap"),
         ("unet_serve_b512", "altered"), ("cyclegan_serve_b128", "altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(run, cell, fault):
    with faults.planted(fault):
        rc, res, _ = run(cell)
    assert rc == 0
    assert res["correct"] is False
