"""Shared helpers of the benchmark's tests: a cell's CPU smoke run in this
process, its result line parsed."""

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

CELLS = ("unet_train_b128", "cyclegan_train_b16", "unet_serve_b512",
         "cyclegan_serve_b128")


def smoke_run(capsys, cell, trace=0, seed=3000000001, seconds=0.3):
    """(exit code, the result line's object or None, standard error) of a
    CPU smoke run of ``cell``."""
    from portbench.harness import main
    capsys.readouterr()
    rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(trace), "--smoke", "1"],
              time.perf_counter())
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err


@pytest.fixture
def run(capsys):
    return lambda *a, **kw: smoke_run(capsys, *a, **kw)
