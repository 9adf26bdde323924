"""bn_calls_per_iter.unet: launches of the bf16 BatchNorm statistics kernel
(``gcc_bn_stats_bf16``, one a train-mode BatchNorm forward) in the unet
training cell's traced slice, an iteration: how many of the iteration's
BatchNorms take the kernels. None where the slice holds none (a program
without them) or no device operation."""

import re

STATS = re.compile(r"\bgcc_bn_stats_bf16\b")


def read(r):
    s = r.slice
    if r.entry != "train" or s is None or not s.device:
        return None
    n = sum(1 for name, _, _ in s.kernels if STATS.search(name))
    return n / s.units if n else None
