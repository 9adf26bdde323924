"""The BatchNorm kernels' metrics (``metrics/bn_calls_per_iter.unet.py``,
``metrics/bn_ms_per_iter.unet.py``) on a slice built from known device
kernels: the statistics kernel counted by its whole name (not the
backward's ``gcc_bn_grad_stats_bf16``), every ``gcc_bn_`` kernel's time
summed, and nothing read from a slice without them (a program that lacks
the kernels), without device operations or outside training."""

import types

import torch

from portbench import trace
from portbench.harness import read_metric

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, start, end, device=CUDA):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d


STATS = "void (anonymous namespace)::gcc_bn_stats_bf16(__nv_bfloat16 const*)"
APPLY = "void (anonymous namespace)::gcc_bn_apply_bf16(__nv_bfloat16 const*)"
GRAD = ("void (anonymous namespace)::gcc_bn_grad_stats_bf16("
        "__nv_bfloat16 const*)")
OTHER = "void at::native::vectorized_elementwise_kernel<4>"


def _readings(device, entry="train", units=2):
    events = [Event(trace.SLICE, 0, 10_000_000, CPU)] + device
    return types.SimpleNamespace(entry=entry,
                                 slice=trace.Slice(events, units))


SLICE = [Event(STATS, 0, 1_000_000), Event(APPLY, 1_000_000, 3_000_000),
         Event(GRAD, 3_000_000, 4_000_000), Event(STATS, 5_000_000, 5_500_000),
         Event(OTHER, 6_000_000, 9_000_000),
         Event("Memcpy DtoD", 9_000_000, 9_100_000)]


def test_calls_count_the_statistics_kernel_an_iteration():
    assert read_metric("bn_calls_per_iter.unet", _readings(SLICE)) == 1.0


def test_ms_sum_every_batch_norm_kernel_an_iteration():
    # (1 + 2 + 1 + 0.5) ms over 2 iterations
    assert read_metric("bn_ms_per_iter.unet", _readings(SLICE)) == 2.25


def test_nothing_to_read_is_none():
    for name in ("bn_calls_per_iter.unet", "bn_ms_per_iter.unet"):
        assert read_metric(name, _readings(SLICE[-2:])) is None
        assert read_metric(name, _readings([])) is None
        assert read_metric(name, _readings(SLICE, entry="serve")) is None
        assert read_metric(name, types.SimpleNamespace(
            entry="train", slice=None)) is None
