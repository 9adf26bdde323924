"""Row-sharded eval (port of gcc_tpu/parallel/spatial.py): an image's rows
(H) split over ranks, so one image whose activations do not fit one card's
memory is served over several.

SRResNet at 4x keeps full-resolution feature maps through 16 residual
blocks: a 2048x2048 output needs the activation stack of a 512x512 input on
one card (models/SRGAN.py:139-197). Here each of k ranks holds H/k rows of
every activation, NCHW, and the batch may be split over a second, 'data'
axis (``make_mesh_2d``).

``gcc_tpu`` annotates the activations ``P('data', 'spatial')`` and XLA's SPMD
partitioner writes the rest: the halo exchanges of every convolution, the
resharding around strided stages, the cross-shard InstanceNorm sums. Here
they are written out over torch.distributed, for the layers of
ops/layers.py, which read the active view (``scope`` / ``active``):

* A convolution (``conv``, ``conv_transpose``) computes the output rows of
  its rank from the global input rows they read: those of the rank, and the
  rows above and below it (the halo) from whichever ranks hold them
  (``Rows.fetch``: one all-gather of every rank's edge rows, so a halo
  taller than a shard, a 9x9 conv on 2-row shards, reaches past the
  adjacent rank). Zero padding is added only at the global top and bottom;
  a transposed conv's output padding only on the last shard.
* ``reflect_pad`` reflects at the global top and bottom only, and fills the
  interior borders from the halo; it returns the rank's rows with their
  halo, which the next convolution takes as they are.
* InstanceNorm's two sums (the mean, then the squared deviations) are
  all-reduced over the spatial group (``Rows.all_reduce_``).
* Where a layer's output height does not split over the k shards, its
  input is gathered and the layer runs replicated on every rank of the
  group (the U-Net's bottleneck: 256 -> 1 over 8 downs). The next
  resampling layer whose output height splits takes its own rows again.
* BatchNorm in eval mode uses its running statistics: no traffic. Eval is
  all this shards: a train-mode BatchNorm under the view raises.

``auto_shards`` lowers the shard count to the largest divisor of the image
height. Without an active view every layer runs as it does without this
module. The counters (``SpatialMesh.counters``) count what this rank put
into the collectives: halo rows, statistics, and whole-tensor gathers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

# a slab that reflect_pad returned: this rank's rows with ``HALO`` rows of
# halo above and below, which a convolution takes as they are
HALO = "_spatial_halo"


def auto_shards(h: int, n_spatial: int) -> int:
    """Largest shard count <= n_spatial that divides the image height
    (eval images have arbitrary heights: SRDataset's test crops are only
    multiples of the upscale factor, datasets.py:139-141). Worst case 1,
    unsharded."""
    for k in range(min(h, max(1, n_spatial)), 0, -1):
        if h % k == 0:
            return k
    return 1


@dataclasses.dataclass
class SpatialMesh:
    """One rank's view of an (n_data x n_spatial) grid over the first
    n_data * n_spatial ranks of the process group, row-major: rank r sits at
    data row r // n_spatial, spatial position r % n_spatial, so adjacent
    ranks hold adjacent row blocks. ``rows[k]`` is the group of the first k
    ranks of this rank's data row, for every k <= n_spatial (a shard count
    that ``auto_shards`` lowers takes the first k; the others of the row
    wait for the result); ``cols[s]`` the group of the ranks at spatial
    position s across the data rows. A rank outside the grid has neither.
    ``counters``: bytes and calls this rank put into the halo all-gathers
    (``halo_``), the statistics' all-reduces (``stat_``) and the
    whole-tensor gathers (``gather_``)."""

    n_data: int
    n_spatial: int
    rank: int
    world: int
    rows: Dict[int, Any] = dataclasses.field(default_factory=dict)
    cols: Dict[int, Any] = dataclasses.field(default_factory=dict)
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.reset_counters()

    @property
    def member(self) -> bool:
        return self.rank < self.n_data * self.n_spatial

    @property
    def data_index(self) -> int:
        return self.rank // self.n_spatial

    @property
    def position(self) -> int:
        return self.rank % self.n_spatial

    def reset_counters(self) -> None:
        self.counters = {f"{kind}_{what}": 0
                         for kind in ("halo", "stat", "gather")
                         for what in ("bytes", "calls")}

    def count(self, kind: str, t: torch.Tensor) -> None:
        self.counters[f"{kind}_bytes"] += t.numel() * t.element_size()
        self.counters[f"{kind}_calls"] += 1


_MESHES: Dict[Tuple, SpatialMesh] = {}


def make_mesh_2d(n_data: int, n_spatial: int) -> SpatialMesh:
    """This rank's view of an (n_data x n_spatial) grid over the first
    n_data * n_spatial ranks of the initialised process group (every rank
    of the group calls it, in the same order: its subgroups are created
    here, for every shard count up to n_spatial). The same grid over the
    same group is made once."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.init_distributed "
                           "first")
    n, world = n_data * n_spatial, dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    key = (n_data, n_spatial, dist.group.WORLD)
    if key in _MESHES:
        return _MESHES[key]
    mesh = SpatialMesh(n_data, n_spatial, dist.get_rank(), world)
    for k in range(2, n_spatial + 1):
        for d in range(n_data):
            g = dist.new_group(list(range(d * n_spatial, d * n_spatial + k)))
            if mesh.member and d == mesh.data_index:
                mesh.rows[k] = g
    if n_data > 1:
        for s in range(n_spatial):
            g = dist.new_group(list(range(s, n, n_spatial)))
            if mesh.member and s == mesh.position:
                mesh.cols[s] = g
    _MESHES[key] = mesh
    return mesh


# ---------------------------------------------------------------------------
# The active view
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Rows:
    """The view the layers read inside ``spatial_apply``: k shards over
    ``group``, this rank at ``pos``, and the layout of the tensors the next
    layer takes (``sharded``: each rank holds its H/k rows; else every rank
    holds all of them). The layers keep ``sharded`` current."""

    group: Any
    k: int
    pos: int
    mesh: SpatialMesh
    sharded: bool = True

    def height(self, x: torch.Tensor) -> int:
        """x's global height in the current layout."""
        return x.shape[2] * (self.k if self.sharded else 1)

    def own(self, h: int, j: Optional[int] = None) -> Tuple[int, int]:
        """Rows [a, b) of a height-h tensor that position j (this rank)
        holds."""
        j = self.pos if j is None else j
        return j * h // self.k, (j + 1) * h // self.k

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum t over the group, in place (a statistic)."""
        self.mesh.count("stat", t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def fetch(self, x: torch.Tensor,
              need: Callable[[int], Tuple[int, int]]) -> torch.Tensor:
        """Global rows [lo, hi) = need(pos) of x, zero rows where they fall
        outside [0, H). ``need(j)`` gives the rows of every position j: in
        the sharded layout one all-gather carries, from every rank, the
        rows that any other needs of it, as many at its top and at its
        bottom as the widest request asks (at most its shard), so that a
        halo taller than a shard comes from the ranks past the adjacent
        one."""
        h = self.height(x)
        lo, hi = need(self.pos)
        if not self.sharded:
            return _zero_rows(x[:, :, max(lo, 0):min(hi, h)], lo, hi, h)
        hl = x.shape[2]
        above = below = 0  # rows any rank needs of the ranks above / below
        for j in range(self.k):
            a, b = self.own(h, j)
            lo_j, hi_j = need(j)
            above = max(above, a - max(lo_j, 0))
            below = max(below, min(hi_j, h) - b)
        nb, nt = min(below, hl), min(above, hl)  # head rows, tail rows sent
        whole = nb + nt >= hl
        windows: List[List[Tuple[int, torch.Tensor]]] = []
        if nb or nt:
            send = x if whole else torch.cat(
                [x[:, :, :nb], x[:, :, hl - nt:]], 2)
            send = send.contiguous()
            parts = [torch.empty_like(send) for _ in range(self.k)]
            self.mesh.count("halo", send)
            dist.all_gather(parts, send, group=self.group)
            for j, p in enumerate(parts):
                a, b = self.own(h, j)
                windows.append([(a, p)] if whole else
                               [(a, p[:, :, :nb]), (b - nt, p[:, :, nb:])])
        pieces = []
        for j in range(self.k):
            a, b = self.own(h, j)
            wins = [(a, x)] if j == self.pos else (windows[j] if windows
                                                   else [])
            for start, t in wins:
                r0 = max(lo, start, 0)
                r1 = min(hi, start + t.shape[2], h)
                if r1 > r0:
                    pieces.append((r0, t[:, :, r0 - start:r1 - start]))
        pieces.sort(key=lambda p: p[0])
        got = sum(t.shape[2] for _, t in pieces)
        if got != min(hi, h) - max(lo, 0):
            raise AssertionError(f"halo fetch of rows [{lo}, {hi}) at "
                                 f"position {self.pos}: {got} rows")
        slab = torch.cat([t for _, t in pieces], 2) if len(pieces) > 1 \
            else pieces[0][1]
        return _zero_rows(slab, lo, hi, h)

    def relayout(self, x: torch.Tensor, sharded: bool,
                 want: bool) -> torch.Tensor:
        """x from the layout ``sharded`` to the layout ``want``."""
        if sharded == want:
            return x
        return gather_rows(self, x) if sharded else shard_rows(self, x)


def shard_rows(view: Rows, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor every rank holds whole."""
    a, b = view.own(x.shape[2])
    return x[:, :, a:b]


def gather_rows(view: Rows, x: torch.Tensor) -> torch.Tensor:
    """Every row of a sharded tensor, on every rank of the group."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(view.k)]
    view.mesh.count("gather", x)
    dist.all_gather(parts, x, group=view.group)
    return torch.cat(parts, 2)


def _zero_rows(slab: torch.Tensor, lo: int, hi: int, h: int) -> torch.Tensor:
    """slab (global rows [max(lo, 0), min(hi, h))) with zero rows for the
    rows of [lo, hi) outside [0, h)."""
    top, bottom = max(0, -lo), max(0, hi - h)
    if not top and not bottom:
        return slab
    return F.pad(slab, (0, 0, top, bottom))


_ACTIVE: Optional[Rows] = None


def active() -> Optional[Rows]:
    """The view of the row-sharded forward that is running, or None."""
    return _ACTIVE


@contextlib.contextmanager
def scope(view: Optional[Rows]):
    """``view`` active for the block, the previous one back after it."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, view
    try:
        yield view
    finally:
        _ACTIVE = prev


# ---------------------------------------------------------------------------
# The layers' row-sharded forms (ops/layers.py calls them under a view)
# ---------------------------------------------------------------------------

def conv(view: Rows, x: torch.Tensor, run: Callable, kernel: int,
         stride: int, padding: int) -> torch.Tensor:
    """A convolution along H (``kernel``, ``stride``, zero ``padding``)
    under the view: ``run(slab)`` convolves a slab of input rows with no
    padding along H. A slab from ``reflect_pad`` is taken as it is."""
    halo = getattr(x, HALO, 0)
    if halo:
        if stride != 1 or padding or kernel != 2 * halo + 1:
            raise ValueError(f"a reflect-padded slab (halo {halo}) into a "
                             f"conv of kernel {kernel}, stride {stride}, "
                             f"padding {padding}")
        return run(x)
    h_in = view.height(x)
    h_out = (h_in + 2 * padding - kernel) // stride + 1
    out = _out_layout(view, h_out, stride > 1)
    x = _replicate_for(view, x, out)

    def need(j):
        a, b = view.own(h_out, j) if out else (0, h_out)
        return stride * a - padding, stride * (b - 1) - padding + kernel

    y = run(view.fetch(x, need))
    view.sharded = out
    return y


def conv_transpose(view: Rows, x: torch.Tensor, run: Callable, kernel: int,
                   stride: int, padding: int,
                   output_padding: int) -> torch.Tensor:
    """A transposed convolution along H under the view: ``run(slab,
    extra)`` convolves a slab of input rows with no padding along H and
    ``extra`` rows of output padding (only the last shard's, where the
    output reaches past the last row any input touches)."""
    h_in = view.height(x)
    h_out = (h_in - 1) * stride - 2 * padding + kernel + output_padding
    out = _out_layout(view, h_out, True)
    x = _replicate_for(view, x, out)
    a, b = view.own(h_out) if out else (0, h_out)

    def span(a, b):  # the input rows that output rows [a, b) read
        lo = max(0, -(-(a + padding - kernel + 1) // stride))
        hi = min(h_in, (b - 1 + padding) // stride + 1)
        return lo, hi

    def need(j):
        return span(*(view.own(h_out, j) if out else (0, h_out)))

    lo, hi = span(a, b)
    base = lo * stride  # the slab output's first row, before the crop
    extra = max(0, b + padding - base - ((hi - lo - 1) * stride + kernel))
    y = run(view.fetch(x, need), extra)
    view.sharded = out
    return y[:, :, a + padding - base:b + padding - base]


def _out_layout(view: Rows, h_out: int, resamples: bool) -> bool:
    """Whether a layer's output is sharded: where its height splits over
    the shards, and the layer resamples (a stride, a transposed conv) or
    its input is sharded; a stride-1 layer keeps a replicated input
    replicated."""
    return h_out % view.k == 0 and (view.sharded or resamples)


def _replicate_for(view: Rows, x: torch.Tensor, out: bool) -> torch.Tensor:
    """x gathered where the layer's output is replicated and x is not (the
    view's layout follows)."""
    if view.sharded and not out:
        x = gather_rows(view, x)
        view.sharded = False
    return x


def reflect_pad(view: Rows, x: torch.Tensor, pad: int) -> torch.Tensor:
    """ReflectionPad2d under the view: in the sharded layout, the rank's
    rows with ``pad`` rows above and below, reflected at the global top and
    bottom and taken from the neighbours elsewhere, marked for the next
    convolution; replicated, the plain pad."""
    if not view.sharded:
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")
    h = view.height(x)

    def src(r):
        return -r if r < 0 else (2 * (h - 1) - r if r >= h else r)

    def need(j):
        a, b = view.own(h, j)
        rows = [src(r) for r in range(a - pad, b + pad)]
        return min(rows), max(rows) + 1

    lo, _ = need(view.pos)
    slab = view.fetch(x, need)
    a, b = view.own(h)
    idx = torch.tensor([src(r) - lo for r in range(a - pad, b + pad)],
                       device=x.device)
    y = F.pad(slab.index_select(2, idx), (pad, pad, 0, 0), mode="reflect")
    setattr(y, HALO, pad)
    return y


def instance_moments(view: Rows, xf: torch.Tensor):
    """(mean, biased variance) over (H, W) of an fp32 NCHW tensor, keepdim:
    in the sharded layout two-pass over the global plane, each sum
    all-reduced over the group."""
    if not view.sharded:
        mean = xf.mean(dim=(2, 3), keepdim=True)
        return mean, (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    n = xf.shape[2] * view.k * xf.shape[3]
    mean = view.all_reduce_(xf.sum(dim=(2, 3), keepdim=True)) / n
    var = view.all_reduce_((xf - mean).square().sum(dim=(2, 3),
                                                    keepdim=True)) / n
    return mean, var


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def default_mesh() -> Optional[SpatialMesh]:
    """One row over every rank of the initialised group, or None without
    one."""
    if not dist.is_initialized():
        return None
    return make_mesh_2d(1, dist.get_world_size())


def spatial_apply(module, x: torch.Tensor,
                  mesh: Optional[SpatialMesh] = None,
                  n_spatial: Optional[int] = None) -> torch.Tensor:
    """An eval forward of ``module`` on NCHW ``x`` with its rows sharded;
    the full output on every rank (what ``np.asarray`` of ``gcc_tpu``'s
    sharded result gives). Every rank of the group calls it with the same
    x.

    Without a mesh: one row over the ranks of the initialised group (1
    without one); more shards than ranks are lowered to the rank count, with
    ``gcc_tpu``'s warning, and then to ``auto_shards`` of the height. An
    explicit mesh is validated instead: a batch or a height that it does
    not divide raises ``gcc_tpu``'s ValueError. ``module(x)`` may return
    (output, features), as the port's generators do."""
    if mesh is None:
        mesh = default_mesh()
        n_dev = 1 if mesh is None else mesh.world
        want = n_spatial or n_dev
        if want > n_dev:
            logging.getLogger("gcc-tpu-torch").warning(
                "spatial_apply: %d shards requested but only %d ranks; "
                "degrading to %d", want, n_dev, n_dev)
            want = n_dev
        k = auto_shards(x.shape[2], want)
    else:
        nd, ns = mesh.n_data, mesh.n_spatial
        if x.shape[0] % nd or x.shape[2] % ns:
            raise ValueError(
                f"batch {x.shape[0]} / height {x.shape[2]} not divisible by "
                f"mesh (data={nd}, spatial={ns}); pass n_spatial instead to "
                f"auto-reduce, or pad the input")
        k = ns
    if mesh is None:
        return _forward(module, x, None)
    out = None
    if mesh.member and mesh.position < k:
        b = x.shape[0] // mesh.n_data
        xs = x[mesh.data_index * b:(mesh.data_index + 1) * b]
        view = None
        if k > 1:
            view = Rows(mesh.rows[k], k, mesh.position, mesh)
            xs = shard_rows(view, xs)
        out = _forward(module, xs, view)
        if view is not None and view.sharded:
            out = gather_rows(view, out)
        if mesh.n_data > 1:
            out = out.contiguous()
            parts = [torch.empty_like(out) for _ in range(mesh.n_data)]
            mesh.count("gather", out)
            dist.all_gather(parts, out, group=mesh.cols[mesh.position])
            out = torch.cat(parts)
    if k == mesh.n_spatial and mesh.n_data * mesh.n_spatial == mesh.world:
        return out
    # ranks that took no part (past k in their row, or outside the grid)
    # take the result from rank 0
    box = [None if out is None else (tuple(out.shape), out.dtype)]
    dist.broadcast_object_list(box, src=0)
    if out is None:
        out = torch.empty(box[0][0], dtype=box[0][1], device=x.device)
    dist.broadcast(out, src=0)
    return out


def _forward(module, x: torch.Tensor, view: Optional[Rows]) -> torch.Tensor:
    with torch.no_grad(), scope(view):
        out = module(x)
    return out[0] if isinstance(out, (tuple, list)) else out
