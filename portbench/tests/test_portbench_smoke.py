"""Every cell's CPU smoke run: the result line's keys in order, no device
metric from a CPU run, and in fp32 (the smoke configurations' dtype) the
plain reference following the program to rounding."""

import pytest

from conftest import CELLS

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_smoke_run_prints_the_result_line(run, cell, trace):
    rc, res, err = run(cell, trace)
    assert rc == 0
    assert list(res) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert res["metrics"] == {}
    assert res["device"]["platform"] == "cpu"
    assert "busy_s" not in res["device"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace:
        assert res["breakdown"] == {"device_ops": [], "idle_gaps": []}
    # the numbers compared are the last lines of standard error
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [ln.split()[1] for ln in tail] == list(res["checks"])
    # fp32 against fp32: the reference follows the program to rounding
    assert res["correct"] is True
    for name, c in res["checks"].items():
        assert c["value"] < 2e-3, name
