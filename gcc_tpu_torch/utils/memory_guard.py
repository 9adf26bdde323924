"""Startup device-memory guard for cli.train (port of
gcc_tpu/utils/memory_guard.py).

Before the run's first training step, measure the step's peak device
memory and compare it with the card's. The JAX package reads XLA's
buffer assignment of the compiled step; PyTorch has no ahead-of-time
plan to read, so the port runs the step itself, once, on the run's real
first batch, between a snapshot and a restore of everything the step
writes (the nets' parameters and buffers: BatchNorm statistics, spectral
u/v, replay pools; the optimizers; the discrepancy EMA; the step count; the
state's generator and the global ones): the run after the guard is the run
without it, bit for bit. If the peak exceeds the card's memory (or the step
runs out of it), the two-point bytes-per-image fit of
benchmarks/memory_budget.py from half the batch suggests the largest batch
that fits.

The reference has no equivalent: its failure mode is a raw CUDA OOM in the
middle of the first iteration.
"""

from __future__ import annotations

import gc
from typing import Callable, Optional, Tuple

import torch

_GIB = 1024 ** 3


class MemoryGuardError(RuntimeError):
    """The step's peak exceeds the device's memory (strict mode)."""


def device_hbm_bytes(device=None) -> Tuple[int, str]:
    """The card's memory: (bytes, where the number comes from)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    props = torch.cuda.get_device_properties(dev)
    return int(props.total_memory), f"{props.name} total_memory"


def measurable(device) -> bool:
    """The allocator keeps peak statistics on a card, not on the CPU."""
    return torch.device(device).type == "cuda"


def _reset_peak(device) -> None:
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)


def _read_peak(device) -> int:
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


def _snapshot(state) -> tuple:
    """Everything a step writes, on the host: the state's own record (nets,
    optimizers, EMA, step, its generator) and the global generators."""
    cuda = torch.cuda.get_rng_state_all() if torch.cuda.is_initialized() \
        else None
    return state.state_dict(), torch.get_rng_state(), cuda


def _restore(state, snap: tuple) -> None:
    sd, cpu, cuda = snap
    state.load_state_dict(sd)
    torch.set_rng_state(cpu)
    if cuda is not None:
        torch.cuda.set_rng_state_all(cuda)


def _peak(step: Callable[[int], object], state, n: int,
          device) -> Optional[int]:
    """Peak bytes allocated on ``device`` while ``step(n)`` runs the
    training step on the first n items of the batch, from a snapshot of
    ``state`` that is restored after it; None when the step runs out of
    device memory."""
    snap = _snapshot(state)
    oom = False
    try:
        _reset_peak(device)
        step(n)
        peak = _read_peak(device)
    except RuntimeError as e:  # torch.cuda.OutOfMemoryError among them
        if not isinstance(e, torch.cuda.OutOfMemoryError) and not any(
                m in str(e) for m in ("out of memory", "ALLOC_FAILED")):
            raise
        oom = True
    finally:
        _restore(state, snap)
    if oom:
        gc.collect()
        torch.cuda.empty_cache()
        return None
    return peak


def check_step(step: Callable[[int], object], state, batch_size: int,
               device, hbm_bytes: Optional[int] = None, logger=None,
               strict: bool = False) -> Optional[dict]:
    """Measure the training step's peak device memory at ``batch_size``.

    ``step(n)`` runs the step on the first n items of the run's first batch
    and may write ``state``: each measurement restores it. Returns the
    result dict (gcc_tpu's keys, and ``out_of_memory`` when the full batch
    ran out), or None on the CPU, where there are no peak statistics. Best
    effort: a failure is logged and swallowed unless it is strict's
    MemoryGuardError."""
    info = logger.info if logger else (lambda *_: None)
    warn = logger.warning if logger else (lambda *_: None)
    if not measurable(device):
        info("memory guard: no device memory statistics on the CPU; "
             "skipped")
        return None
    try:
        peak = _peak(step, state, batch_size, device)
        if hbm_bytes is None:
            hbm_bytes, src = device_hbm_bytes(device)
        else:
            src = "caller-supplied"
        if peak is not None and peak <= hbm_bytes:
            out = {"peak_bytes": peak, "hbm_bytes": hbm_bytes,
                   "pct_of_hbm": round(100.0 * peak / hbm_bytes, 1)}
            info(f"memory guard: projected step peak "
                 f"{peak / _GIB:.2f} / {hbm_bytes / _GIB:.2f} GiB "
                 f"({out['pct_of_hbm']}% of HBM, {src})")
            return out
        # over budget: fit bytes/image from half the batch (and, when the
        # full batch ran out of memory, from halving until two batches ran)
        # and suggest the largest batch that fits (memory_budget.py's model,
        # incl. its reliability gate)
        points = [] if peak is None else [(batch_size, peak)]
        n = batch_size
        while n >= 2 and len(points) < 2:
            n //= 2
            p = _peak(step, state, n, device)
            if p is not None:
                points.append((n, p))
            elif points:
                break
        oom = peak is None
        if oom and len(points) < 2:
            msg = (f"memory guard: the step ran out of device memory at "
                   f"batch {batch_size} and no two smaller batches ran "
                   f"({src}); try a smaller model or crop")
            if strict:
                raise MemoryGuardError(msg)
            warn(msg)
            return {"peak_bytes": None, "hbm_bytes": hbm_bytes,
                    "out_of_memory": True}
        slope = fixed = None
        if len(points) == 2:
            (n1, p1), (n2, p2) = points
            slope = (p1 - p2) / (n1 - n2)
            if oom:
                peak = int(p1 + slope * (batch_size - n1))
            fixed = peak - slope * batch_size
        out = {"peak_bytes": peak, "hbm_bytes": hbm_bytes,
               "pct_of_hbm": round(100.0 * peak / hbm_bytes, 1)}
        if oom:
            out["out_of_memory"] = True
        suggestion = ""
        if slope is not None:
            share = slope * batch_size / peak if peak else 0.0
            out.update(bytes_per_image=int(slope), fixed_bytes=int(fixed),
                       batch_dependent_share=round(share, 4))
            max_batch = (int((hbm_bytes - fixed) / slope)
                         if slope > 0 and fixed < hbm_bytes else 0)
            if slope > 0 and share >= 0.05 and max_batch >= 1:
                out["suggested_max_batch"] = max_batch
                suggestion = (f"; largest projected-to-fit batch "
                              f"~{max_batch} (fit: {int(slope)} B/image "
                              f"+ {fixed / _GIB:.2f} GiB fixed)")
            else:
                suggestion = ("; peak is dominated by batch-independent "
                              "temps — reducing batch will not fit this "
                              "model (try a smaller model/crop or more "
                              "devices)")
        ran_out = (f" (the step ran out of memory at batch {batch_size}; "
                   f"peak projected from batches {points[0][0]} and "
                   f"{points[1][0]})" if oom else "")
        msg = (f"memory guard: projected step peak {peak / _GIB:.2f} GiB "
               f"EXCEEDS device HBM {hbm_bytes / _GIB:.2f} GiB ({src})"
               f"{ran_out}{suggestion}")
        if strict:
            raise MemoryGuardError(msg)
        warn(msg)
        return out
    except MemoryGuardError:
        raise
    except Exception as e:  # best effort, as in the JAX package
        info(f"memory guard unavailable: {e}")
        return None
