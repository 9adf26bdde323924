"""CPU threads and wall-clock limits for the port's tests.

* ``one_thread``: a module-scoped autouse fixture (import it into a test
  module by name) that runs the module on one torch thread and one OpenBLAS
  thread, numpy's and scipy's, and restores both after it. Six xdist
  workers share the host's cores; a worker's tiny nets and 2048-d
  ``scipy.linalg.sqrtm`` gain nothing from eight threads each and
  oversubscribe the host with them. Without threadpoolctl the BLAS limit
  is left out, never the test.
* ``child_env()``: the environment for a child interpreter, one thread each.
* ``watched(proc, limit, name)`` and ``spawn_within(limit, name)``: a child
  process, or the ranks that the block spawns, killed when the limit runs
  out, and the test failed with the case's name, so that a hung child
  cannot stall the run.
"""

import contextlib
import multiprocessing
import os
import signal
import threading

import pytest
import torch

try:
    import scipy.linalg  # noqa: F401  (loads scipy's OpenBLAS, to limit it)
except ImportError:
    pass

try:
    from threadpoolctl import threadpool_limits
except ImportError:
    threadpool_limits = None

ONE_THREAD = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
              "MKL_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread and one BLAS thread for the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    blas = (threadpool_limits(1, user_api="blas") if threadpool_limits
            else contextlib.nullcontext())
    try:
        with blas:
            yield
    finally:
        torch.set_num_threads(n)


def child_env(**extra) -> dict:
    """os.environ with one thread for torch and BLAS, and ``extra``."""
    return {**os.environ, **ONE_THREAD, **extra}


@contextlib.contextmanager
def _limit(limit: float, kill, what: str):
    """``kill()`` once ``limit`` seconds have passed in the block; the test
    then fails with ``what``, whatever the block raised."""
    fired = threading.Event()

    def fire():
        fired.set()
        kill()

    timer = threading.Timer(limit, fire)
    timer.daemon = True
    timer.start()
    try:
        yield
    except BaseException:
        if not fired.is_set():
            raise
    finally:
        timer.cancel()
    if fired.is_set():
        pytest.fail(f"{what}: not done within {limit:.0f} s; killed")


@contextlib.contextmanager
def watched(proc, limit: float, name: str):
    """``proc`` (a ``subprocess.Popen`` started with
    ``start_new_session=True``) and everything in its process group killed
    once ``limit`` seconds have passed; the test then fails with ``name``.
    The group is killed after the block in any case."""

    def kill():
        with contextlib.suppress(ProcessLookupError, PermissionError):
            os.killpg(proc.pid, signal.SIGKILL)

    try:
        with _limit(limit, kill, name):
            yield
    finally:
        if proc.poll() is None:
            kill()
        proc.wait(timeout=30)


@contextlib.contextmanager
def spawn_within(limit: float, name: str):
    """The processes that the block starts (``parallel.spawn``'s ranks,
    in-process CLI runs on a mesh) killed once ``limit`` seconds have
    passed; the test then fails with ``name``."""
    before = {p.pid for p in multiprocessing.active_children()}

    def kill():
        for p in multiprocessing.active_children():
            if p.pid not in before:
                p.kill()

    with _limit(limit, kill, f"{name}: ranks"):
        yield
