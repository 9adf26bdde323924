"""Data parallelism over torch.distributed (port of gcc_tpu/parallel/mesh.py).

W ranks, one process each: one card a rank (NCCL), or one CPU process a
rank (Gloo) when the caller asks for the CPU. The batch axis is sharded:
rank r holds rows [r B/W, (r+1) B/W) of the global batch B (``shard_batch``).
Parameters, optimizer moments, the EMA scalars, the step and the state's
generator are replicated (``replicate_state``).

``gcc_tpu`` gets global semantics from SPMD over the global batch; here they
are written out, and hold only inside an engine step (``scope``, entered by
``mesh_step``), so that rank 0 can evaluate alone:

* BatchNorm statistics (ops/layers.py) and every loss (losses.py) are sums
  over the rank's rows, summed across ranks by ``all_reduce_sum`` before
  their nonlinearity (a sqrt, an abs, a rsqrt): each rank holds the same
  global value, and the metrics a step returns are global.
* Dropout masks (models/generators.py) and replay pools (ops/pool.py) are
  drawn over the global batch from replicated generators, each rank keeping
  its rows, so a rank's rows are the 1-process run's rows.

The gradient convention: each rank backpropagates the replicated global
losses. ``all_reduce_sum``'s backward is a sum all-reduce, so a rank's
parameter gradient is W times its rows' part of the global gradient (every
rank seeds its copy of the loss with 1, and those seeds meet in the sum).
``reduce_gradients``, called once by every ``engines.common.grads_of``,
sums the ranks' gradients in one flat buffer and divides by W: the
1-process gradient, on every rank. (The gradient of a rank's own rows, an
activation's, is W times their 1-process gradient; no engine reads one.) A term that touches no collective
(a function of replicated parameters only) has the same gradient on every
rank and survives the average unchanged.

Without an active mesh every helper here is the identity, and the port runs
bit for bit as it does without this module.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import hashlib
import os
import signal
import socket
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = 600.0  # seconds a collective waits for a rank
BARRIER_TIMEOUT = 7200.0  # seconds a rank waits for rank 0's epoch-end eval


@dataclasses.dataclass
class Mesh:
    """One rank's view of the data-parallel mesh: its rank, the world size,
    its device, the process group and the store beside it, and the counters
    of what went through the collectives (``bytes``: ``grad_bytes`` /
    ``grad_calls`` of the gradient all-reduces, ``stat_bytes`` /
    ``stat_calls`` of the forward and backward collectives of the global
    statistics; ``reset_counters`` zeroes them)."""

    rank: int
    world: int
    device: torch.device
    group: Any = None
    store: Any = None
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.reset_counters()

    def reset_counters(self) -> None:
        self.counters = {"grad_bytes": 0, "grad_calls": 0, "stat_bytes": 0,
                         "stat_calls": 0}

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.counters[f"{kind}_bytes"] += t.numel() * t.element_size()
        self.counters[f"{kind}_calls"] += 1

    def all_reduce_(self, t: torch.Tensor, kind: str = "stat"
                    ) -> torch.Tensor:
        """Sum ``t`` across the ranks, in place; returns it."""
        self._count(kind, t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def rows(self, n_global: int) -> slice:
        """This rank's rows of a global batch of ``n_global``."""
        return rows(self.rank, self.world, n_global)

    def barrier(self, key: str, value: str = "",
                timeout: float = BARRIER_TIMEOUT) -> str:
        """Rank 0 publishes ``value`` under ``key``; every other rank waits
        for it, at most ``timeout`` seconds, and returns it. A rank that
        waits while rank 0 works alone (the epoch-end eval) waits here,
        not in a collective."""
        if self.rank == 0:
            self.store.set(key, value)
            return value
        self.store.wait([key], datetime.timedelta(seconds=timeout))
        return self.store.get(key).decode()


def rows(rank: int, world: int, n_global: int) -> slice:
    """Rank ``rank``'s rows [rank B/W, (rank+1) B/W) of a global batch of
    B = ``n_global`` over ``world`` ranks."""
    if n_global % world:
        raise ValueError(f"a batch of {n_global} does not split over "
                         f"{world} ranks")
    b = n_global // world
    return slice(rank * b, (rank + 1) * b)


# ---------------------------------------------------------------------------
# Process group
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A free TCP port on localhost, for a rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(rank: int, world: int, init_method: str, device,
                     backend: Optional[str] = None,
                     timeout: float = DEFAULT_TIMEOUT) -> Mesh:
    """Join the process group at ``init_method`` (``tcp://host:port``, rank
    0 listening) and return this rank's mesh.

    ``device`` is the rank's device: a card (``cuda:i``; the group is NCCL)
    or ``cpu`` (Gloo). ``backend`` overrides that choice (Gloo on CUDA
    tensors: two ranks on one card, which NCCL refuses). ``timeout`` bounds
    every collective, so a lost rank fails the others in seconds. The group
    is checked with one all-reduce before it is returned: a group that
    cannot reduce raises here."""
    from gcc_tpu_torch.device import resolve_device
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    td = datetime.timedelta(seconds=timeout)
    if not init_method.startswith("tcp://"):
        raise ValueError(f"init_method {init_method!r}: give tcp://host:port")
    host, port = init_method[len("tcp://"):].rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, rank == 0, td)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=td, **kw)
    mesh = make_mesh(world, device)
    mesh.store = store
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe, group=mesh.group)
    if float(probe) != world:
        raise RuntimeError(f"{backend} group of {world} ranks reduced "
                           f"{float(probe)}")
    return mesh


def make_mesh(n: Optional[int] = None, device=None) -> Mesh:
    """This rank's mesh over the initialised process group of ``n`` ranks
    (all of them when None)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    return Mesh(dist.get_rank(), world, torch.device(device or "cpu"),
                dist.group.WORLD)


def any_rank(mesh: Optional[Mesh], flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (``flag`` without a mesh): the
    ranks decide together, so they stop at the same iteration."""
    if mesh is None:
        return bool(flag)
    t = torch.tensor([float(bool(flag))], device=mesh.device)
    dist.all_reduce(t, group=mesh.group)
    return bool(t.item() > 0)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), device_kind: str = "cpu",
          devices: Optional[Sequence[int]] = None,
          backend: Optional[str] = None, threads: Optional[int] = None,
          timeout: float = DEFAULT_TIMEOUT) -> None:
    """Run ``fn(mesh, *args)`` on ``world`` new processes, one a rank, and
    wait for them. ``device_kind`` 'cpu' puts every rank on the CPU;
    'cuda' puts rank r on card ``devices[r]`` (card r by default).
    ``threads`` sets each rank's intra-op threads. A rank that raises
    brings the others down and raises here (torch.multiprocessing). A
    SIGTERM to this process goes on to every rank. ``fn`` must be
    importable by name (a module's top-level function)."""
    import torch.multiprocessing as mp
    init_method = f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, init_method, device_kind, devices,
                          backend, threads, timeout, args),
        nprocs=world, join=False, start_method="spawn")

    def forward(_signum, _frame):
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    try:
        prev = signal.signal(signal.SIGTERM, forward)
    except ValueError:  # not the main thread: no handler
        prev = None
    try:
        # a rank that failed: the others get SIGTERM, and SIGKILL 5 s later
        while not ctx.join(grace_period=5):
            pass
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)


def _rank_main(rank: int, fn, world, init_method, device_kind, devices,
               backend, threads, timeout, args) -> None:
    if threads:
        torch.set_num_threads(threads)
    if device_kind == "cpu":
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", (devices or range(world))[rank])
    mesh = init_distributed(rank, world, init_method, device, backend,
                            timeout)
    try:
        fn(mesh, *args)
    finally:
        shutdown()


# ---------------------------------------------------------------------------
# The active mesh
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Mesh] = None


def active() -> Optional[Mesh]:
    """The mesh of the engine step that is running, or None."""
    return _ACTIVE


@contextlib.contextmanager
def scope(mesh: Optional[Mesh]):
    """``mesh`` active for the block (None: no mesh), the previous one
    back after it."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def mesh_step(fn):
    """An engine method that runs under its engine's ``mesh``."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kw):
        with scope(getattr(self, "mesh", None)):
            return fn(self, *args, **kw)
    return wrapped


# ---------------------------------------------------------------------------
# Collectives with autograd
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.detach().clone(
            memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(
            g.clone(memory_format=torch.contiguous_format)), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.world)]
        mesh._count("stat", x)
        dist.all_gather(parts, x, group=mesh.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = ctx.mesh.all_reduce_(g.clone(memory_format=torch.contiguous_format))
        return g[ctx.mesh.rows(g.shape[0])], None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the active mesh's ranks (x itself without
    one); its backward sums the gradient over the ranks."""
    mesh = active()
    return x if mesh is None else _AllReduceSum.apply(x, mesh)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in rank order: the global
    batch (x itself without a mesh); the backward keeps this rank's rows
    of the summed gradient."""
    mesh = active()
    return x if mesh is None else _AllGatherRows.apply(x, mesh)


def local_rows(x):
    """This rank's rows of a global-batch tensor (x without a mesh)."""
    mesh = active()
    return x if mesh is None else x[mesh.rows(x.shape[0])]


def global_batch(n_local: int) -> int:
    """The global batch of a rank that holds ``n_local`` rows."""
    mesh = active()
    return n_local if mesh is None else n_local * mesh.world


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over every element of the global batch: torch.mean
    without a mesh, else the all-reduced sum over the global count."""
    mesh = active()
    if mesh is None:
        return torch.mean(x)
    return all_reduce_sum(x.sum()) / (x.numel() * mesh.world)


def reduce_gradients(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """The ranks' gradients summed and divided by W, through one all-reduce
    of one flat buffer per dtype (the parameters are fp32: one). Unchanged
    without a mesh."""
    mesh = active()
    if mesh is None or not grads:
        return grads
    out = list(grads)
    for dtype in sorted({g.dtype for g in grads}, key=str):
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        mesh.all_reduce_(flat, "grad").div_(mesh.world)
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


# ---------------------------------------------------------------------------
# Batches and state
# ---------------------------------------------------------------------------

def shard_batch(batch, mesh: Optional[Mesh]):
    """This rank's rows of every tensor, array and list in a batch dict
    (the batch itself without a mesh)."""
    if mesh is None or mesh.world == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, (torch.Tensor, np.ndarray, list)) and len(v):
            v = v[mesh.rows(len(v))]
        out[k] = v
    return out


def state_checksum(state) -> str:
    """A hash of every byte of an engine state: each net's parameters and
    buffers (pools and their counts included), the optimizer moments and
    counts, the EMA scalars, the step and the generator's state."""
    h = hashlib.sha256()

    def feed(x, path=""):
        if isinstance(x, dict):
            for k in sorted(x):
                feed(x[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                feed(v, f"{path}/{i}")
        elif x is None:
            h.update(f"{path}:None".encode())
        else:
            a = np.ascontiguousarray(np.asarray(x))
            h.update(f"{path}:{a.dtype}:{a.shape}".encode())
            h.update(a.tobytes())

    feed(state.state_dict())
    return h.hexdigest()


def gather_objects(obj, mesh: Mesh) -> list:
    """Every rank's ``obj``, in rank order."""
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def replicate_state(state, mesh: Optional[Mesh]):
    """Rank 0's state on every rank (nets, moments, EMA, step, generator),
    then checked: a rank whose checksum differs raises on every rank."""
    if mesh is None:
        return state
    box = [state.state_dict() if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    if mesh.rank != 0:
        state.load_state_dict(box[0])
    sums = gather_objects(state_checksum(state), mesh)
    if len(set(sums)) != 1:
        raise RuntimeError(f"replicated state differs across ranks: {sums}")
    return state
