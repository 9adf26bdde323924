"""What the per-layer metrics of the program's own spans read: the host
ranges that ``gcc_tpu_torch/utils/tracing.py`` opens around the cooperative
iteration's parts (``gcc.step``, its sub-updates, ``gcc.adam``), set
against the CUDA launch calls and the device's busy intervals of the same
traced slice (``trace.Slice``: the spans are host events on the profiler's
clock). The names are written out here as the program writes them. A
program that opens no such span (an older one) reads None, as does a slice
with no device operation (smoke runs, the CPU). Every value is per
iteration of the slice."""

from __future__ import annotations

import bisect
import functools
from typing import List, Optional, Tuple

# the host's kernel launches: cudaLaunchKernel, cudaLaunchKernelExC and the
# lower-level cuLaunchKernel, cuLaunchKernelEx (their count equals the
# slice's kernels in both train cells on the H100)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")

Ranges = List[Tuple[int, int]]


def _slice(r):
    s = r.slice
    return s if r.entry == "train" and s is not None and s.device else None


def _ranges(s, name: str) -> Optional[Ranges]:
    """The slice's host spans named ``name`` in order (spans of one name
    never nest); None where the slice holds none."""
    return sorted((a, b) for n, a, b in s.host if n == name) or None


def _launches_in(s, ranges: Ranges) -> int:
    """Launch calls whose start lies in [a, b) of one of ``ranges``."""
    starts = sorted(a for n, a, _ in s.host if n.startswith(LAUNCH_CALLS))
    return sum(bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
               for a, b in ranges)


def _idle_ns(s, ranges: Ranges) -> int:
    """The length of ``ranges`` within the slice's span in which no device
    operation ran."""
    busy = s.busy_intervals()
    ends = [e for _, e in busy]
    total = 0
    for a, b in ranges:
        a, b = max(a, s.t0), min(b, s.t1)
        if b <= a:
            continue
        total += b - a
        # from the first busy interval that ends after a
        i = bisect.bisect_right(ends, a)
        while i < len(busy) and busy[i][0] < b:
            total -= min(b, busy[i][1]) - max(a, busy[i][0])
            i += 1
    return total


def step_host_ms(r):
    """Host ms inside ``gcc.step`` an iteration: the host's time to
    dispatch one ``train_arch_step``."""
    s = _slice(r)
    ranges = None if s is None else _ranges(s, "gcc.step")
    return None if not ranges else \
        sum(b - a for a, b in ranges) * 1e-6 / s.units


def launches(span: str, r):
    """Launch calls the host made inside ``span`` an iteration."""
    s = _slice(r)
    ranges = None if s is None else _ranges(s, span)
    return None if not ranges else _launches_in(s, ranges) / s.units


def idle_ms(span: str, r):
    """Device-idle ms while the host was inside ``span``, an iteration."""
    s = _slice(r)
    ranges = None if s is None else _ranges(s, span)
    return None if not ranges else _idle_ns(s, ranges) * 1e-6 / s.units


launches_teacher_d = functools.partial(launches, "gcc.teacher_d")
launches_teacher_g = functools.partial(launches, "gcc.teacher_g")
launches_student_d = functools.partial(launches, "gcc.student_d")
launches_student_g = functools.partial(launches, "gcc.student_g")
launches_arch = functools.partial(launches, "gcc.arch")
adam_launches = functools.partial(launches, "gcc.adam")
idle_ms_teacher_d = functools.partial(idle_ms, "gcc.teacher_d")
idle_ms_teacher_g = functools.partial(idle_ms, "gcc.teacher_g")
idle_ms_student_d = functools.partial(idle_ms, "gcc.student_d")
idle_ms_student_g = functools.partial(idle_ms, "gcc.student_g")
idle_ms_arch = functools.partial(idle_ms, "gcc.arch")
