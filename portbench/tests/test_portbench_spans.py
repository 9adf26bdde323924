"""The readers of the program's spans (``portbench/spans.py``) on a slice
built from known host spans, launch calls and device intervals: their
arithmetic, the idle overlap exact at span edges, the None cases, the
metric files bound to them, and every span name they read being one the
program opens (``gcc_tpu_torch.utils.tracing.SPANS``)."""

import ast
import json
import re
import types

import pytest
import torch

from conftest import ROOT
from portbench import spans, trace
from portbench.harness import read_metric

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, start, end, device=CPU):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d


def _call(name, t):
    return Event(name, t, t + 3)


# two iterations in [0, 1000); the device busy over [30, 70), [80, 120) and
# [590, 700), its last kernel running past the closing sync at 1000
HOST = [
    Event(trace.SLICE, 0, 1000),
    Event("gcc.step", 0, 450), Event("gcc.step", 500, 950),
    Event("gcc.teacher_d", 10, 100), Event("gcc.teacher_d", 510, 600),
    Event("gcc.adam", 50, 90),
    Event("gcc.arch", 900, 1100),
    Event("aten::mul", 55, 58),
    _call("cudaLaunchKernel", 10),   # at teacher_d's start: inside
    _call("cudaLaunchKernel", 20), _call("cudaLaunchKernel", 60),
    _call("cudaLaunchKernel", 99),
    _call("cudaLaunchKernel", 100),  # at its end: outside
    _call("cuLaunchKernel", 520), _call("cudaLaunchKernelExC", 530),
    _call("cudaMemcpyAsync", 540), _call("cudaLaunchHostFunc", 545),
    _call("cudaLaunchKernel", 960),
]
DEVICE = [Event("k0", 30, 70, CUDA), Event("k1", 80, 120, CUDA),
          Event("k2", 590, 700, CUDA), Event("k3", 990, 1200, CUDA)]


def _readings(events=HOST + DEVICE, entry="train", units=2):
    sl = trace.Slice(events, units) if events is not None else None
    return types.SimpleNamespace(entry=entry, slice=sl)


def test_step_host_ms_sums_the_step_spans():
    assert spans.step_host_ms(_readings()) == pytest.approx(900e-6 / 2)


def test_launches_count_the_launch_calls_that_start_inside():
    r = _readings()
    assert spans.launches_teacher_d(r) == 6 / 2
    assert spans.adam_launches(r) == 1 / 2
    assert spans.launches_arch(r) == 1 / 2
    assert spans.launches("gcc.step", r) == 7 / 2


def test_idle_overlap_is_exact_at_span_edges():
    r = _readings()
    # [10, 100): busy 40 + 20 of 90; [510, 600): busy 10 of 90
    assert spans.idle_ms_teacher_d(r) == pytest.approx((30 + 80) * 1e-6 / 2)
    # [50, 90) holds [50, 70) and [80, 90) busy
    assert spans.idle_ms("gcc.adam", r) == pytest.approx(10 * 1e-6 / 2)
    # [900, 1100) clipped to the slice's [900, 1000), busy from 990
    assert spans.idle_ms_arch(r) == pytest.approx(90 * 1e-6 / 2)
    # a span that ends where a busy interval starts, another that starts
    # where one ends
    edge = HOST + DEVICE + [Event("gcc.student_d", 20, 30),
                            Event("gcc.student_g", 120, 130)]
    r = _readings(edge)
    assert spans.idle_ms_student_d(r) == pytest.approx(10e-6 / 2)
    assert spans.idle_ms_student_g(r) == pytest.approx(10e-6 / 2)
    assert spans.launches_student_g(r) == 0


def test_idle_of_spans_that_tile_the_slice_is_the_slice_idle():
    tiles = [Event(trace.SLICE, 0, 1000), Event("gcc.student_g", 0, 400),
             Event("gcc.student_d", 400, 1000)]
    r = _readings(tiles + DEVICE)
    sl = r.slice
    idle = (sl.window_s - sl.busy_s) * 1e3 / sl.units
    assert spans.idle_ms_student_g(r) + spans.idle_ms_student_d(r) == \
        pytest.approx(idle)


def test_none_without_spans_device_slice_or_training():
    no_spans = [e for e in HOST + DEVICE if not e.name().startswith("gcc.")]
    no_device = HOST
    for r in (_readings(no_spans), _readings(no_device),
              _readings(events=None), _readings(entry="serve")):
        for fn in (spans.step_host_ms, spans.launches_teacher_g,
                   spans.idle_ms_teacher_g, spans.adam_launches):
            assert fn(r) is None


def test_the_gaps_under_a_span_and_no_operator_are_named_by_the_span():
    gaps = dict(_readings().slice.idle_gaps(20))
    assert "gcc.teacher_d" in gaps and "gcc.step" in gaps


def test_every_span_metric_file_reads_its_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    named = [m for m in bench["per_layer"] if m["source"] == "program_span"]
    assert len(named) == 24
    r = _readings()
    for m in named:
        base, cfg = m["name"].rsplit(".", 1)
        assert m["workloads"] == [{"unet": "unet_train_b128",
                                   "cyclegan": "cyclegan_train_b16"}[cfg]]
        fn = getattr(spans, base.replace(".", "_"))
        assert read_metric(m["name"], r) == fn(r), m["name"]


def test_every_span_the_readers_name_is_one_the_program_opens():
    from gcc_tpu_torch.utils.tracing import SPANS
    tree = ast.parse((ROOT / "portbench" / "spans.py").read_text())
    names = {n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
             and isinstance(n.value, str)
             and re.fullmatch(r"gcc\.\w+", n.value)}
    assert names == {"gcc.step", "gcc.teacher_d", "gcc.teacher_g",
                     "gcc.student_d", "gcc.student_g", "gcc.arch",
                     "gcc.adam"}
    assert names <= set(SPANS)
