"""What the per-layer metrics read, one function a quantity. Each file
``metrics/<metric>.py`` binds its ``read`` to one of these; a reader that
finds nothing to read returns None and the metric is left out of the
line. ``r`` is the run's readings (entries/): the entry, the batch,
the window's units and seconds, the traced slice, the reference's
operation counts and B2's calls."""

from portbench.reference.bounds import BF16_FLOPS


def _slice(r, entry):
    s = r.slice
    return s if r.entry == entry and s is not None and s.device else None


def train_mfu(r):
    """The reference's operations of one iteration times the window's
    iterations a second, over the dense bf16 peak, in %."""
    if r.entry != "train" or not r.flops_per_iter or not r.units:
        return None
    return 100.0 * r.flops_per_iter * (r.units / r.window_s) / BF16_FLOPS


def launches_per_iter(r):
    """CUDA kernels in the slice (copies and sets not counted) an
    iteration: the host's dispatch."""
    s = _slice(r, "train")
    return None if s is None or not s.kernels else len(s.kernels) / s.units


def _group_ms(r, group):
    s = _slice(r, "train")
    ms = None if s is None else s.ms_by_group().get(group)
    return None if ms is None else ms / s.units


def conv_ms_per_iter(r):
    """Device ms of the library convolutions an iteration."""
    return _group_ms(r, "conv")


def other_ms_per_iter(r):
    """Device ms outside the convolutions, B1 and B2 an iteration."""
    return _group_ms(r, "other")


def b2_ms_per_iter(r):
    """Device ms of B2's kernels an iteration."""
    return _group_ms(r, "b2")


def b2_roofline(r):
    """The least time of an iteration's B2 calls over their device time,
    in %."""
    ms = _group_ms(r, "b2")
    if not ms or not r.b2_calls:
        return None
    return 100.0 * sum(n * b for _, n, b in r.b2_calls) / ms


def device_idle(r, entry):
    """The share of the slice's span in which no device operation ran."""
    s = _slice(r, entry)
    return None if s is None else 100.0 * (1.0 - s.busy_s / s.window_s)


def device_idle_train(r):
    return device_idle(r, "train")


def device_idle_serve(r):
    """The slice serves its requests back to back, each synchronised: its
    idle share is the host's part of a request's service time."""
    return device_idle(r, "serve")


def serve_mfu(r):
    """The student's operations on the slice's images over the seconds
    the device was busy in the slice, as a share of the bf16 peak, in %
    (the open loop's waiting between arrivals is not in it)."""
    s = _slice(r, "serve")
    if s is None or not r.flops_per_image:
        return None
    return 100.0 * r.flops_per_image * r.batch * s.units / s.busy_s \
        / BF16_FLOPS


def serve_launches_per_request(r):
    """CUDA kernels in the slice (copies and sets not counted) a
    request."""
    s = _slice(r, "serve")
    return None if s is None or not s.kernels else len(s.kernels) / s.units
