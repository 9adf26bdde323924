"""The ``train`` entry: the program's cooperative iteration
(``engine.train_arch_step``). Set-up builds the program's training state
and drives its first ``check_steps`` iterations through the window's call
(they are the warm-up and what the reference follows); the window
dispatches iterations back to back with no host sync and ends in a
``torch.cuda.synchronize()``: ``train_images_per_s`` is every image of
every iteration over that wall time."""

from __future__ import annotations

import json
import sys
import time
import types

import torch

from portbench import cells as C
from portbench import family, trace
from portbench.reference import flops, precision
from portbench.run_cells import (_b2_launches, _exact_fp32, _finish, _peak,
                                 _sync, train_numbers, worst_leaves)


def run(cell, args, device, t_start):
    fam = family.load(cell.cfg["family"])
    sync = _sync(device)
    tc = C.TrainCell(fam, cell.cfg, cell.traffic, args.seed, device)
    n0 = C.check_steps(cell.traffic)
    rec = tc.first_steps(n0)
    sync()
    setup_s = time.perf_counter() - t_start
    print(f"setup: {setup_s:.6f} s", file=sys.stderr, flush=True)

    losses, i = [], n0
    b2_before = _b2_launches()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        losses.append(tc.step(i))
        i += 1
    sync()
    window_s = time.perf_counter() - t0
    iters = i - n0
    b2 = (_b2_launches() - b2_before) / max(iters, 1)
    print(f"window: {iters} iterations of {tc.batch} images in "
          f"{window_s:.6f} s; B2 calls an iteration {b2:g}",
          file=sys.stderr, flush=True)
    sl = None
    if args.trace:
        units = cell.traffic["trace_iters"]
        sl = trace.run_slice(lambda j: tc.step(i + j), units, sync)
    peak = _peak(device)
    finite = torch.stack([torch.stack([v.float() for v in m.values()])
                          for m in losses]).isfinite().all(1) \
        if losses else torch.ones(0, dtype=torch.bool)
    failed = int((~finite).sum())
    prog = C.to_host(rec)
    tc.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _exact_fp32()
    ref = C.to_host(tc.reference(precision.Exact(), n0))
    values = train_numbers(prog, ref)
    print("widest leaves: " + json.dumps(worst_leaves(prog, ref)),
          file=sys.stderr, flush=True)

    readings = types.SimpleNamespace(
        entry="train", batch=tc.batch, units=iters, window_s=window_s,
        images_per_s=iters * tc.batch / window_s, slice=sl,
        flops_per_iter=None, flops_per_image=None,
        b2_calls=fam.b2_calls(cell.cfg, tc.batch, tc.size))
    if args.trace:
        readings.flops_per_iter = flops.iteration_flops(
            fam.reference, cell.cfg, tc.batch, tc.size)
    out = {"end_to_end": {"train_images_per_s": readings.images_per_s,
                          "setup_s": setup_s},
           "readings": readings, "attempted": iters,
           "memory_peak_bytes": peak}
    return _finish(cell, values, failed, out)
