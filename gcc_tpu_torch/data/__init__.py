"""Dataset registry + loader factories (port of gcc_tpu/data/__init__.py;
data/__init__.py:18-91).

``dataset_mode`` strings map to classes; ``synthetic`` selects procedural
data so the pipeline runs without downloads. ``create_split_dataset``
returns (train, val) loaders over the same data with seeds ``seed`` and
``seed + 1``, as the JAX package does, so the DARTS arch step sees
differently-ordered batches.

A packed root (``cli.prepare``'s output, a directory holding
``gcc_pack.json``) selects ``PackedDataset``; with ``--device_cache`` the
training loaders keep a packed store on the device (data/device_cache.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gcc_tpu_torch.data.datasets import (
    AlignedDataset, SADataset, SRDataset, SyntheticDataset, UnalignedDataset,
)
from gcc_tpu_torch.data.loader import InfiniteLoader, Loader  # noqa: F401
from gcc_tpu_torch.data.packed import (  # noqa: F401
    PACK_META, PackedDataset, is_packed_root,
)

DATASETS = {
    "aligned": AlignedDataset,
    "unaligned": UnalignedDataset,
    "sa": SADataset,
    "sr": SRDataset,
    "synthetic": SyntheticDataset,
}


def find_dataset_using_name(name: str):
    if name not in DATASETS:
        raise NotImplementedError(
            f"dataset mode [{name}] is not implemented "
            f"(available: {sorted(DATASETS)})")
    return DATASETS[name]


def build_dataset(cfg, seed: int = 0, prefer_uint8: bool = False, **kw):
    mode = cfg.dataset_mode
    if mode != "synthetic" and is_packed_root(cfg.dataroot):
        # packed roots are self-describing: no decode, the randomized
        # transform remainder online
        return PackedDataset(
            cfg, seed=seed,
            out_dtype="uint8" if prefer_uint8 else "float32", **kw)
    if mode != "synthetic" and (not cfg.dataroot
                                or not os.path.isdir(cfg.dataroot)):
        raise FileNotFoundError(
            f"dataroot [{cfg.dataroot}] does not exist; pass a valid "
            f"--dataroot or use --dataset_mode synthetic")
    return find_dataset_using_name(mode)(cfg, seed=seed, **kw)


def create_dataset(cfg, seed: int = 0, drop_last: bool = False) -> Loader:
    ds = build_dataset(cfg, seed=seed)
    return Loader(ds, cfg.batch_size, shuffle=not cfg.serial_batches,
                  num_threads=cfg.num_threads, prefetch=cfg.prefetch,
                  seed=seed, drop_last=drop_last)


def _maybe_device_cache(ds, cfg, seed, drop_last, device, logger,
                        shard=(0, 1)):
    """A DeviceCacheLoader over a packed store when --device_cache allows
    it, else None (keep streaming): ``off`` streams, ``on`` caches (and
    raises on a store that cannot be cached), ``auto`` caches a store of at
    most 25 % of the card's memory, on a card only."""
    mode = getattr(cfg, "device_cache", "auto")
    if mode == "off" or not isinstance(ds, PackedDataset):
        return None
    log = logger.info if logger else (lambda *_: None)
    if not ds.device_cacheable():
        if mode == "on":
            raise ValueError(
                "--device_cache on: this packed store is not device-"
                "cacheable (needs uniform item shapes; aligned/unaligned/"
                "sa modes)")
        return None
    from gcc_tpu_torch.data.device_cache import DeviceCacheLoader
    device = torch.device(device)
    n_bytes = ds.total_bytes()
    if mode == "auto":
        if device.type != "cuda":
            return None
        from gcc_tpu_torch.utils.memory_guard import device_hbm_bytes
        hbm, _ = device_hbm_bytes(device)
        if n_bytes > 0.25 * hbm:
            log(f"device_cache auto: store is {n_bytes / 1e9:.2f} GB "
                f"(> 25% of {hbm / 1e9:.1f} GB device memory); keeping the "
                f"streaming path")
            return None
    # batches in the compute dtype on the card, float32 on the CPU, as
    # gcc_tpu/data/__init__.py:93-95 serves them
    from gcc_tpu_torch.device import compute_dtype
    dtype = compute_dtype(cfg) if device.type == "cuda" else torch.float32
    log(f"device_cache: {n_bytes / 1e6:.0f} MB packed store resident on "
        f"{device}; batches materialize there in {dtype} (no steady-state "
        f"host->device image traffic)")
    return DeviceCacheLoader(ds, cfg.batch_size, device, dtype=dtype,
                             shuffle=not cfg.serial_batches, seed=seed,
                             drop_last=drop_last, shard=shard)


def create_split_dataset(cfg, seed: int = 0, device="cpu", logger=None,
                         mesh=None):
    """(train, val) loaders. drop_last keeps every train batch full, as the
    JAX package's static shapes need (the port follows it for equal
    batches); packed data comes as uint8, normalized on ``device`` by the
    training entry (cli/train.py set_input), and a packed store that
    --device_cache admits lives on ``device``. Under a data-parallel
    ``mesh`` both yield this rank's rows of the global batches of
    ``--batch_size``."""
    drop_last = cfg.batch_size > 1
    shard = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    loaders = []
    for s in (seed, seed + 1):
        ds = build_dataset(cfg, seed=s, prefer_uint8=True)
        dl = _maybe_device_cache(ds, cfg, s, drop_last, device, logger,
                                 shard)
        loaders.append(dl if dl is not None else Loader(
            ds, cfg.batch_size, shuffle=not cfg.serial_batches,
            num_threads=cfg.num_threads, prefetch=cfg.prefetch,
            seed=s, drop_last=drop_last, shard=shard))
    return loaders[0], loaders[1]


def to_device(x: np.ndarray, device) -> torch.Tensor:
    """A host batch array as a float32 tensor on ``device``: images NHWC ->
    NCHW, other arrays (SAGAN's z) as they are."""
    t = torch.from_numpy(np.asarray(x, np.float32))
    if t.ndim == 4:
        t = t.permute(0, 3, 1, 2)
    return t.to(device).contiguous()


def to_host(t: torch.Tensor) -> np.ndarray:
    """A generator's NCHW output as NHWC float32 numpy on the host."""
    return t.detach().permute(0, 2, 3, 1).float().cpu().numpy()
