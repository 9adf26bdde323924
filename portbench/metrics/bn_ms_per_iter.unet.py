"""bn_ms_per_iter.unet: device ms of the bf16 BatchNorm kernels (names that
hold ``gcc_bn_``: statistics, normalisation and their backward) in the unet
training cell's traced slice, an iteration. None where the slice holds none
(a program without them) or no device operation."""

MARK = "gcc_bn_"


def read(r):
    s = r.slice
    if r.entry != "train" or s is None or not s.device:
        return None
    ns = [e - b for name, b, e in s.kernels if MARK in name]
    return sum(ns) * 1e-6 / s.units if ns else None
