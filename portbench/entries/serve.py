"""The ``serve`` entry: the pruned student exported as the program ships
it (``utils/serve_export.export_generator``). Set-up exports it and warms
it up; the window offers requests of the mix's batch in an open loop at
the mix's fixed rate, below the system's capacity, each timed from when
it was due to its synchronised output: ``serve_ms_p95``."""

from __future__ import annotations

import sys
import time
import types

import numpy as np
import torch

from portbench import cells as C
from portbench import check, family, trace
from portbench.reference import flops
from portbench.run_cells import (_exact_fp32, _finish, _peak, _sync,
                                 arrivals, open_loop)


def run(cell, args, device, t_start):
    fam = family.load(cell.cfg["family"])
    sync, tr = _sync(device), cell.traffic
    sc = C.ServeCell(fam, cell.cfg, tr, args.seed, device)
    for i in range(tr["warmup_requests"]):
        sc.request(i)
    sync()
    setup_s = time.perf_counter() - t_start
    print(f"setup: {setup_s:.6f} s", file=sys.stderr, flush=True)

    due = arrivals(tr["rate"], args.seconds)
    lat, window_s, kept = open_loop(sc.request, sync, due, tr["sample"],
                                    args.seed)
    p95 = 1e3 * float(np.percentile(lat, 95))
    print(f"window: {len(due)} requests of {sc.batch} images offered at "
          f"{tr['rate']:g}/s in {window_s:.6f} s; latency ms p50 "
          f"{1e3 * float(np.percentile(lat, 50)):.4f} p95 {p95:.4f} max "
          f"{1e3 * max(lat):.4f}", file=sys.stderr, flush=True)
    sl = None
    if args.trace:
        def one(j):
            sc.request(j)
            sync()
        sl = trace.run_slice(one, tr["trace_requests"], sync)
    peak = _peak(device)
    sc.module = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _exact_fp32()
    values = {"image_gap": max(check.image_gap(y, sc.reference(k))
                               for k, y in kept)}

    readings = types.SimpleNamespace(
        entry="serve", batch=sc.batch, units=len(due), window_s=window_s,
        slice=sl, flops_per_iter=None, flops_per_image=None, b2_calls=None)
    if args.trace:
        readings.flops_per_image = flops.student_flops(
            fam.reference, cell.cfg, sc.size)
    out = {"end_to_end": {"serve_ms_p95": p95, "setup_s": setup_s},
           "readings": readings, "attempted": len(due),
           "memory_peak_bytes": peak}
    return _finish(cell, values, 0, out)
