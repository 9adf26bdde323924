"""Device-resident dataset cache (port of gcc_tpu/data/device_cache.py).

The packed pipeline (data/packed.py) already removes per-epoch decode, but
every batch still crosses host->device. This module uploads the packed
uint8 blobs to the device ONCE and materializes batches there: the host
draws only the randomized transform parameters (indices, crop offsets, flip
bits: a few KB a batch), and the device gathers, crops, flips and
normalizes.

- **DeviceCacheLoader** iterates device batches: per batch, ONE int32
  parameter matrix goes to the device (plus SAGAN's float32 z) and one
  advanced-index gather per key builds the crops.
- **FusedCachedStep** takes the parameter matrices of the train batch and
  the DARTS val batch, materializes both and runs the engine's step: the
  JAX package traces all of it into one program; here it is the same work
  in eager order.

The numbers match the host path: the same LockedRandomState stream drives
both (PackedDataset.sample_params), the uint8 crops are equal and the
normalization is device_normalize's (within 1 ulp of the host's float32).

Scope: aligned / unaligned / sa packed stores with uniform item shapes
(PackedDataset.device_cacheable). sr keeps the streaming path (variable HR
shapes + an online bicubic). Whether the store fits is the caller's
decision (data._maybe_device_cache). Under a data-parallel mesh each rank
holds the store on its card, draws every item's parameters of the global
batch (the 1-process stream) and gathers only its rows (Loader's
``shard``).

No reference equivalent: the reference streams every batch through a torch
DataLoader and .cuda() copies every iteration (train.py:135-146).
"""

from __future__ import annotations

import os
import warnings
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gcc_tpu_torch.data.loader import Loader
from gcc_tpu_torch.data.packed import PackedDataset, normalize_tensor
from gcc_tpu_torch.parallel.mesh import rows

# one upload per (blob file, device): the train and DARTS-val loaders view
# the same store, so they share the device copy, which is freed with the
# last loader that holds it
_BLOB_CACHE: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()
_UPLOAD_ROWS = 256  # items a host->device copy carries


def _upload(mm: np.memmap, shape, device: torch.device) -> torch.Tensor:
    """The blob as a (n, h, w, c) uint8 tensor on ``device``, copied over in
    chunks of _UPLOAD_ROWS items (no whole host copy first)."""
    arr = np.asarray(mm).reshape((-1,) + tuple(shape))
    out = torch.empty(arr.shape, dtype=torch.uint8, device=device)
    with warnings.catch_warnings():
        # the memmap is read-only; it is only ever read from
        warnings.simplefilter("ignore", UserWarning)
        for i in range(0, arr.shape[0], _UPLOAD_ROWS):
            out[i:i + _UPLOAD_ROWS].copy_(
                torch.from_numpy(arr[i:i + _UPLOAD_ROWS]))
    return out


def shared_blob(mm: np.memmap, shape, device: torch.device) -> torch.Tensor:
    """The device copy of a packed blob, uploaded on first use per (file,
    its size and time, shape, device)."""
    path = getattr(mm, "filename", None)
    key = None
    if path is not None:
        st = os.stat(path)
        key = (os.path.realpath(path), st.st_size, st.st_mtime_ns,
               tuple(shape), str(device))
        cached = _BLOB_CACHE.get(key)
        if cached is not None:
            return cached
    blob = _upload(mm, shape, device)
    if key is not None:
        _BLOB_CACHE[key] = blob
    return blob


class DeviceCacheLoader(Loader):
    """Loader over a device_cacheable PackedDataset with device-resident
    blobs.

    Yields dicts of NCHW tensors of ``dtype`` (default float32) on
    ``device`` (already normalized: what cli.train's set_input gives the
    engines) plus the host-side *_paths lists.
    Epoch keying, shuffle and batch order are Loader's; the per-item rng
    stream is the dataset's own (sample_params), so a given (seed, epoch,
    index order) gives the same pixels as the streaming path.
    """

    def __init__(self, dataset: PackedDataset, batch_size: int, device,
                 dtype=None, **kw):
        if not isinstance(dataset, PackedDataset) \
                or not dataset.device_cacheable():
            raise ValueError("DeviceCacheLoader needs a device_cacheable "
                             "PackedDataset (uniform item shapes, "
                             "aligned/unaligned/sa)")
        super().__init__(dataset, batch_size, **kw)
        self.device = torch.device(device)
        self.dtype = torch.float32 if dtype is None else dtype
        self._shapes = dataset.uniform_shapes()
        self._data = {key: shared_blob(dataset._mm[key], shape, self.device)
                      for key, shape in self._shapes.items()}

    # -- packed transform parameters ---------------------------------------
    def param_batch(self, idx_batch) -> Tuple[tuple, Dict]:
        """The batch's randomized transform parameters as ONE int32 matrix
        (plus the float32 z for sa), and the host-side paths: this rank's
        rows, after every item's parameters are drawn."""
        ds = self.dataset
        params = [ds.sample_params(int(i)) for i in idx_batch]
        params = params[rows(*self.shard, len(params))]
        if ds.mode == "aligned":
            pm = np.array([(j, x, y, int(f)) for j, x, y, f in params],
                          np.int32).reshape(len(params), 4)
            paths = [ds._paths["A"][int(r)] for r in pm[:, 0]]
            return (pm,), {"A_paths": paths, "B_paths": list(paths)}
        if ds.mode == "unaligned":
            pm = np.array([(*a[:3], int(a[3]), *b[:3], int(b[3]))
                           for a, b in params],
                          np.int32).reshape(len(params), 8)
            return (pm,), {
                "A_paths": [ds._paths["A"][int(r)] for r in pm[:, 0]],
                "B_paths": [ds._paths["B"][int(r)] for r in pm[:, 4]]}
        # sa
        pm = np.array([(p[0],) for p in params], np.int32).reshape(-1, 1)
        z = np.stack([p[1] for p in params]).astype(np.float32)
        return (pm, z), {"img_path": [ds._paths["real"][int(r)]
                                      for r in pm[:, 0]]}

    # -- materializer --------------------------------------------------------
    def _gather(self, key: str, j, x, y, flip) -> torch.Tensor:
        """blob[j, y + i, x + k] (k mirrored where flip) for every item:
        one advanced-index gather, (b, hh, ww, c) uint8. Without a crop the
        whole image is taken (x = y = 0), flipped where asked."""
        cfg = self.dataset.cfg
        h, w, _ = self._shapes[key]
        cs = int(cfg.crop_size)
        if "crop" in cfg.preprocess and (h > cs or w > cs):
            hh = ww = cs
        else:
            hh, ww = h, w
            x, y = torch.zeros_like(x), torch.zeros_like(y)
        ar_h = torch.arange(hh, device=self.device)
        ar_w = torch.arange(ww, device=self.device)
        # the flip folds into the column indices: cropped-then-flipped
        # [i, k] = image[y + i, x + ww - 1 - k]
        cols = x[:, None] + torch.where(flip[:, None], ww - 1 - ar_w, ar_w)
        rows = y[:, None] + ar_h
        return self._data[key][j[:, None, None], rows[:, :, None],
                               cols[:, None, :]]

    def crops(self, args: tuple) -> Dict[str, torch.Tensor]:
        """The batch's uint8 NHWC images on the device (and sa's z), before
        normalization: what PackedDataset(out_dtype="uint8") stacks."""
        mode = self.dataset.mode
        pm = torch.from_numpy(np.asarray(args[0], np.int32)).to(
            self.device).long()
        if mode == "aligned":
            j, x, y, flip = pm[:, 0], pm[:, 1], pm[:, 2], pm[:, 3] != 0
            return {k: self._gather(k, j, x, y, flip) for k in ("A", "B")}
        if mode == "unaligned":
            return {k: self._gather(k, pm[:, o], pm[:, o + 1], pm[:, o + 2],
                                    pm[:, o + 3] != 0)
                    for k, o in (("A", 0), ("B", 4))}
        return {"real_img": self._data["real"][pm[:, 0]],
                "z": torch.from_numpy(np.asarray(args[1], np.float32)).to(
                    self.device)}

    def materialize(self, args: tuple) -> Dict[str, torch.Tensor]:
        """The engine batch for one parameter batch: NCHW images in
        [-1, 1] of the loader's dtype on the device. SAGAN's z stays float32
        as drawn, whatever the loader's dtype, as the JAX package's cache
        hands it over (gcc_tpu/data/device_cache.py:209-216): a bf16 run
        from the cache computes its generators in fp32 (ROADMAP Queue C)."""
        return {k: v if k == "z" else normalize_tensor(v, "m11", self.dtype)
                for k, v in self.crops(args).items()}

    def __iter__(self):
        for b in self._index_batches():
            args, paths = self.param_batch(b)
            out = self.materialize(args)
            out.update(paths)
            yield out

    def iter_param_batches(self):
        """The epoch's (args, paths) stream: FusedCachedStep's input (the
        same shuffle and rng stream as __iter__, no materialization)."""
        for b in self._index_batches():
            yield self.param_batch(b)


class InfiniteParams:
    """Endless parameter-batch stream over a DeviceCacheLoader (the fused
    path's loader.InfiniteLoader, for the DARTS val stream)."""

    def __init__(self, loader: DeviceCacheLoader):
        self.loader = loader
        self._it = loader.iter_param_batches()

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self._it = self.loader.iter_param_batches()
            return next(self._it)

    def close(self) -> None:
        self._it.close()


class FusedCachedStep:
    """A training iteration from device-resident data, given the parameter
    matrices: materialize the train batch (and, with a val loader, the DARTS
    val batch), swap A and B for --direction BtoA, run the engine's step.
    It consumes the same streams in the same order as the unfused path, so
    the numbers are the same."""

    def __init__(self, engine, train_loader: DeviceCacheLoader,
                 val_loader: Optional[DeviceCacheLoader] = None,
                 swap_ab: bool = False):
        self.engine = engine
        self.tl, self.vl = train_loader, val_loader
        self.swap_ab = swap_ab

    def _batch(self, loader: DeviceCacheLoader, args: tuple) -> Dict:
        b = loader.materialize(args)
        if self.swap_ab and "A" in b:
            b["A"], b["B"] = b["B"], b["A"]
        return b

    def train_arch_step(self, state, targs, vargs, lr, ema_beta, arch_lr):
        return self.engine.train_arch_step(
            state, self._batch(self.tl, targs), self._batch(self.vl, vargs),
            lr, ema_beta, arch_lr)

    def train_step(self, state, targs, lr):
        return self.engine.train_step(state, self._batch(self.tl, targs), lr)
