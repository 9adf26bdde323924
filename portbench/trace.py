"""The traced slice of a window: ``torch.profiler`` (CPU and CUDA) over a
few iterations or requests, reduced to device intervals, kernel time by
group, launches, the device's busy share, and the idle gaps named by what
the host was doing (the innermost host operation under the gap's middle).
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench.reference import bounds

SLICE = "portbench.slice"
# events that are no work of the program: the slice's annotation (on the
# host and mirrored on the device's timeline) and the profiler's own
OWN = ("portbench.", "ProfilerStep", "Activity Buffer Request")


class Slice:
    """What the profiler saw over ``units`` iterations (or requests)."""

    def __init__(self, events, units: int):
        self.units = units
        span = next(e for e in events if e.name() == SLICE and
                    e.device_type() != torch.autograd.DeviceType.CUDA)
        self.t0, self.t1 = span.start_ns(), span.end_ns()
        self.device: List[Tuple[str, int, int]] = []
        self.host: List[Tuple[str, int, int]] = []
        for e in events:
            if e.name().startswith(OWN):
                continue  # the harness's and the profiler's own
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                self.device.append((e.name(), e.start_ns(), e.end_ns()))
            else:
                self.host.append((e.name(), e.start_ns(), e.end_ns()))
        self.device.sort(key=lambda r: r[1])
        self.kernels = [r for r in self.device
                        if not r[0].startswith(("Memcpy", "Memset"))]

    @property
    def window_s(self) -> float:
        """The slice's span: its first dispatch to its closing sync."""
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of every device operation's interval, in order."""
        out: List[List[int]] = []
        for _, s, e in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def ms_by_group(self) -> Dict[str, float]:
        out = defaultdict(float)
        for name, s, e in self.device:
            out[bounds.group(name)] += (e - s) * 1e-6
        return dict(out)

    def top_ops(self, n: int = 10) -> List[list]:
        total = defaultdict(int)
        for name, s, e in self.device:
            total[name] += e - s
        return [[k[:200], v * 1e-9]
                for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time between device operations, summed by the host
        operation under each gap's middle (the shortest one that spans
        it), in one sweep over the gaps in order."""
        edges = [self.t0] + [t for iv in self.busy_intervals()
                             for t in iv] + [self.t1]
        gaps = sorted(((s + e) // 2, e - s) for s, e in
                      zip(edges[0::2], edges[1::2]) if e > s)
        host = sorted(self.host, key=lambda r: r[1])
        total, live, k = defaultdict(int), [], 0
        for mid, width in gaps:
            while k < len(host) and host[k][1] <= mid:
                name, hs, he = host[k]
                heapq.heappush(live, (he - hs, he, name))
                k += 1
            # the shortest op on top ended before this gap, and so before
            # every later one: drop it
            while live and live[0][1] < mid:
                heapq.heappop(live)
            total[live[0][2] if live else "python (no operation)"] += width
        return [[k[:200], v * 1e-9]
                for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def run_slice(step: Callable[[int], None], units: int, sync) -> Slice:
    """``step(i)`` for i in range(units) under the profiler, from a synced
    device to a synced device."""
    sync()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SLICE):
            for i in range(units):
                step(i)
            sync()
    return Slice(list(prof.profiler.kineto_results.events()), units)
