"""What the entries of portbench/entries/ share: the clock's sync, the
memory peak, the reference's precision, the training numbers, the open
loop, and the end of a run (its numbers judged against the cell's
limits)."""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from portbench import check


def _sync(device):
    return (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def _exact_fp32() -> None:
    """The reference's products in fp32: TF32 off (it runs after the
    program, which it cannot affect)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _b2_launches():
    from gcc_tpu_torch.ops import mobile_block
    return sum(mobile_block.LAUNCHES.values())


def train_numbers(prog: dict, ref: dict) -> dict:
    moved = check.moved_leaves(ref["grads"])
    pools = {"pool_gap": check.pool_gap(prog["pools"], ref["pools"]),
             "pool_slots": check.pool_slots(prog["pools"], ref["pools"])} \
        if ref["pools"] else {}
    return {"loss_gap": check.loss_gap(prog["losses"], ref["losses"]),
            "loss1_gap": check.loss_gap(prog["losses"][:1],
                                        ref["losses"][:1]),
            "grad_gap": check.leaf_gap(prog["grads"], ref["grads"], moved),
            "grad_median": check.leaf_median(prog["grads"], ref["grads"],
                                             moved),
            "change_gap": check.leaf_gap(prog["change"], ref["change"],
                                         moved),
            "change_median": check.leaf_median(prog["change"],
                                               ref["change"], moved),
            **pools}


def worst_leaves(prog: dict, ref: dict) -> dict:
    """The leaf behind each widest leaf gap, with both norms: what a
    reading far from the others points at."""
    moved = check.moved_leaves(ref["grads"])
    out = {}
    for key in ("grads", "change"):
        gaps = [(check.leaf_gap({o: prog[key][o]}, {o: r}, {o: [leaf]}),
                 "/".join(leaf), prog[key][o][leaf], r[leaf])
                for o, r in ref[key].items() for leaf in moved[o]]
        out[key] = max(gaps, default=None)
    return out


def _finish(cell, values, failed, out):
    print("readings: " + json.dumps(values), file=sys.stderr, flush=True)
    out["checks"] = check.block(values, cell.limits)
    out["check_lines"] = check.lines(values, cell.limits)
    out["correct"] = check.judge(values, cell.limits) and failed == 0
    out["failed"] = failed
    return out


def arrivals(rate: float, seconds: float) -> np.ndarray:
    """The scheduled arrival offsets of a window: round(rate x seconds)
    requests evenly spaced at the mix's rate, the same schedule for every
    seed (a fixed amount of work; a queue grows only where the system
    falls behind its rate)."""
    return np.arange(max(1, round(rate * seconds))) / rate


def open_loop(request, sync, due, sample: int, seed: int):
    """Serve the requests due at ``due`` (offsets in s) one at a time, in
    order, each timed from when it was due to its synchronised output, so
    a request that waits behind a late one counts its wait. Returns the
    latencies, the wall seconds and a reservoir of ``sample`` finished
    (index, output) pairs drawn from the seed."""
    pick = np.random.default_rng(seed)
    kept, lat = [], []
    t0 = time.perf_counter()
    for i, off in enumerate(due):
        t = t0 + off
        while (now := time.perf_counter()) < t:
            if t - now > 2e-3:
                time.sleep(t - now - 1e-3)
        y = request(i)
        sync()
        lat.append(time.perf_counter() - t)
        if len(kept) < sample:
            kept.append((i, y))
        else:
            j = int(pick.integers(0, i + 1))
            if j < sample:
                kept[j] = (i, y)
    return lat, time.perf_counter() - t0, kept
