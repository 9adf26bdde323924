"""Dataset registry + loader factories (port of gcc_tpu/data/__init__.py;
data/__init__.py:18-91).

``dataset_mode`` strings map to classes; ``synthetic`` selects procedural
data so the pipeline runs without downloads. ``create_split_dataset``
returns (train, val) loaders over the same data with seeds ``seed`` and
``seed + 1``, as the JAX package does, so the DARTS arch step sees
differently-ordered batches.

Not in the port yet (ROADMAP Queue A): packed roots (``cli.prepare``'s
``gcc_pack.json``) and the device-resident cache.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gcc_tpu_torch.data.datasets import (
    AlignedDataset, SADataset, SRDataset, SyntheticDataset, UnalignedDataset,
)
from gcc_tpu_torch.data.loader import InfiniteLoader, Loader  # noqa: F401

DATASETS = {
    "aligned": AlignedDataset,
    "unaligned": UnalignedDataset,
    "sa": SADataset,
    "sr": SRDataset,
    "synthetic": SyntheticDataset,
}
PACK_META = "gcc_pack.json"


def find_dataset_using_name(name: str):
    if name not in DATASETS:
        raise NotImplementedError(
            f"dataset mode [{name}] is not implemented "
            f"(available: {sorted(DATASETS)})")
    return DATASETS[name]


def build_dataset(cfg, seed: int = 0, **kw):
    mode = cfg.dataset_mode
    if mode != "synthetic" and cfg.dataroot and os.path.exists(
            os.path.join(cfg.dataroot, PACK_META)):
        raise NotImplementedError(
            f"{cfg.dataroot} is a packed root ({PACK_META}); PackedDataset "
            f"and cli.prepare are not in the port yet (ROADMAP Queue A)")
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


def create_split_dataset(cfg, seed: int = 0):
    """(train, val) loaders; drop_last keeps every train batch full, as the
    JAX package's static shapes need (the port follows it for equal
    batches)."""
    drop_last = cfg.batch_size > 1
    return tuple(create_dataset(cfg, seed=s, drop_last=drop_last)
                 for s in (seed, seed + 1))


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
