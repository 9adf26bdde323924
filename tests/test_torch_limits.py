"""tests/torch_limits.py's limits: a hung child process, or a hung process
that a block spawns, is killed at the limit and fails the test by name;
``one_thread`` holds torch and BLAS to one thread and gives them back."""

import multiprocessing
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from torch_limits import (  # noqa: E402
    child_env, one_thread, spawn_within, watched,
)


def test_watched_kills_a_hung_child_and_names_the_case():
    proc = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(600)"],
        env=child_env(), start_new_session=True)
    t0 = time.time()
    with pytest.raises(pytest.fail.Exception, match="hung child: not done "
                       "within 1 s; killed"):
        with watched(proc, 1, "hung child"):
            proc.wait()
    assert time.time() - t0 < 30
    assert proc.returncode is not None


def test_watched_passes_a_child_that_ends():
    proc = subprocess.Popen([sys.executable, "-c", "pass"], env=child_env(),
                            start_new_session=True)
    with watched(proc, 60, "quick child"):
        assert proc.wait() == 0


def test_spawn_within_kills_a_hung_process_and_names_the_case():
    ctx = multiprocessing.get_context("spawn")
    t0 = time.time()
    with pytest.raises(pytest.fail.Exception, match="hung rank: ranks: not "
                       "done within 2 s; killed"):
        with spawn_within(2, "hung rank"):
            p = ctx.Process(target=time.sleep, args=(600,))
            p.start()
            p.join()
    assert time.time() - t0 < 60
    assert not p.is_alive()


def test_one_thread_holds_torch_and_blas_to_one():
    assert torch.get_num_threads() == 1
    threadpoolctl = pytest.importorskip("threadpoolctl")
    blas = [p for p in threadpoolctl.threadpool_info()
            if p["user_api"] == "blas"]
    assert blas and all(p["num_threads"] == 1 for p in blas)
    assert one_thread  # the module's autouse fixture
