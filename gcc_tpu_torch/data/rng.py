"""Thread-safe RandomState for datasets under the per-item Loader pool (copy
of gcc_tpu/data/rng.py).

Loader submits one decode task per image (loader.py), so a dataset's
`self.rng` is hit from num_threads workers concurrently. Mersenne-twister
state updates are not atomic — unlocked concurrent draws can return
duplicate values or garble the state. This wrapper serializes ALL public
method calls (every draw mutates the shared Mersenne state, so locking a
fixed allowlist would let any newly-used method — choice, normal,
random_sample, ... — bypass the lock unnoticed) while the heavy decode
work stays parallel; the lock is held only for the nanoseconds of the draw.

Draw ORDER across threads is scheduling-dependent either way (true of the
previous per-batch pool too); what this guarantees is state integrity and
distinct draws. Tests needing exact reproducibility use num_threads=1.
"""

from __future__ import annotations

import threading

import numpy as np


class LockedRandomState(np.random.RandomState):
    def __init__(self, seed=None):
        # set the lock BEFORE the C-level init in case it touches self
        object.__setattr__(self, "_lock", threading.RLock())
        super().__init__(seed)

    def __getattribute__(self, name):
        attr = super().__getattribute__(name)
        if name.startswith("_") or not callable(attr):
            return attr
        lock = super().__getattribute__("_lock")

        def locked(*args, **kw):
            with lock:
                return attr(*args, **kw)

        locked.__name__ = getattr(attr, "__name__", name)
        return locked
