"""Epoch-end evaluation orchestrators (port of gcc_tpu/eval/orchestrators.py;
metric/test_metric.py:15-204).

Protocol quirks kept: eval batches are serial, unflipped, at a fixed
load_size (test_metric.py:16-21); SAGAN evaluates on 10% of the dataset
(l.144); CycleGAN reports one metric per direction, SRGAN PSNR and SSIM on
Y per test set (Set5, Set14, B100, Urban100 where the dataroot has them,
else val). ``--eval_batch`` > 1 batches the generator forwards with the same
outputs (eval mode: no dropout, running BN stats, per-sample IN).

FID needs the InceptionV3 weights (``--inception_path``: the TF-FID
``.pth`` or its ingested ``.npz``) and the real statistics
(``real_stat_<side>.npz`` in the dataroot, ``cli.get_real_stat``); mIoU
needs DRN-D-105 (``--drn_path``) and a cityscapes dataroot. The evaluators
run on the engine's device. Without their weights the orchestrator reports
the JAX package's proxies and logs them as ``[proxy]``: pixel-FID (the
Fréchet distance of 8x8-downsampled pixel statistics) or, on cityscapes,
PSNR.

``--spatial_shards S`` > 1 shards the rows of the pix2pix and CycleGAN
eval images over the ranks of the process group (parallel/spatial.py,
``row_sharded``), as gcc_tpu/eval/orchestrators.py:80-92 does; every rank
runs the generator passes in step, and a rank that is not the lead
(``lead=False``) stops there.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np

from gcc_tpu_torch.data import (
    PACK_META, build_dataset, create_dataset, is_packed_root, to_device,
    to_host,
)
from gcc_tpu_torch.data.datasets import SyntheticDataset
from gcc_tpu_torch.data.resample import BILINEAR, resize
from gcc_tpu_torch.metrics.fid import (
    activation_statistics, fid_from_activations, frechet_distance,
)
from gcc_tpu_torch.metrics.psnr_ssim import psnr_y, ssim_y


def eval_cfg(cfg, **overrides):
    base = dict(batch_size=max(1, int(getattr(cfg, "eval_batch", 1))),
                serial_batches=True, no_flip=True,
                phase="val" if cfg.dataset_mode != "synthetic" else cfg.phase)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)


def _pixel_features(images: np.ndarray) -> np.ndarray:
    """8x8x3 bilinear-downsampled pixel features for the proxy Fréchet
    distance (Pillow's BILINEAR, bit for bit)."""
    feats = []
    for im in images:
        arr = ((np.asarray(im) + 1) / 2 * 255).clip(0, 255).astype(np.uint8)
        small = np.asarray(resize(arr, (8, 8), BILINEAR), np.float64) / 255.0
        feats.append(small.ravel())
    return np.stack(feats)


def pixel_fid(fakes: np.ndarray, reals: np.ndarray) -> float:
    mu1, s1 = activation_statistics(_pixel_features(fakes))
    mu2, s2 = activation_statistics(_pixel_features(reals))
    return frechet_distance(mu1, s1, mu2, s2)


def _real_stat_path(cfg, side: Optional[str] = None) -> str:
    side = side or ("B" if cfg.direction == "AtoB" else "A")
    return os.path.join(cfg.dataroot, f"real_stat_{side}.npz")


def uses_fid(cfg, side: Optional[str] = None) -> bool:
    """The InceptionV3 weights and real_stat_<side>.npz are there."""
    return bool(cfg.inception_path) and os.path.exists(
        cfg.inception_path) and os.path.exists(_real_stat_path(cfg, side))


def uses_miou(cfg) -> bool:
    """pix2pix on cityscapes with DRN weights: the metric is mIoU."""
    return ("pix2pix" in cfg.model and "cityscapes" in cfg.dataroot
            and bool(cfg.drn_path) and os.path.exists(cfg.drn_path))


def _real_fid(cfg, fakes: np.ndarray, device,
              side: Optional[str] = None) -> Optional[float]:
    """FID against real_stat_<side>.npz, or None without the weights or
    the statistics."""
    if not uses_fid(cfg, side):
        return None
    from gcc_tpu_torch.metrics.inception import InceptionExtractor
    acts = InceptionExtractor.get(cfg.inception_path, device).activations(
        fakes)
    with np.load(_real_stat_path(cfg, side)) as npz:
        return fid_from_activations(acts, npz["mu"], npz["sigma"])


def row_sharded(cfg) -> bool:
    """Whether the eval shards its images' rows: ``--spatial_shards`` > 1,
    and a family whose eval images go through ``_collect`` (not SAGAN,
    whose z has no rows, and not SRGAN, whose sets are scored one image at
    a time by ``generate``, as in gcc_tpu)."""
    return int(getattr(cfg, "spatial_shards", 1)) > 1 and (
        "pix2pix" in cfg.model or "cyclegan" in cfg.model)


def _collect(cfg, engine, state, loader, key_in: str, key_out: str,
             max_items: Optional[int] = None, direction: Optional[str] = None):
    """Run the generator over a loader in eval mode: (fakes, reals) as NHWC
    numpy, at most ``max_items`` of each. ``direction`` picks CycleGAN's
    generator. With ``row_sharded`` the rows of each batch are sharded over
    the ranks, the shard count lowered per image height."""
    fakes, reals = [], []
    n = 0
    kw = {} if direction is None else {"direction": direction}
    if row_sharded(cfg):
        gen, kw["n_spatial"] = engine.generate_spatial, int(cfg.spatial_shards)
    else:
        gen = engine.generate
    for batch in loader:
        x = to_device(batch[key_in], engine.device)
        fakes.append(to_host(gen(state, x, **kw)))
        reals.append(np.asarray(batch[key_out], np.float32))
        n += x.shape[0]
        if max_items is not None and n >= max_items:
            break
    # trim to the cap: with --eval_batch >1 the last batch can overshoot
    return np.concatenate(fakes)[:max_items], \
        np.concatenate(reals)[:max_items]


def evaluate_engine(cfg, engine, state, logger, epoch, lead: bool = True):
    """The epoch's metric (logged), or None. ``lead=False``: a rank of a
    row-sharded eval that is not the lead runs the generator passes alone
    and returns None."""
    if not lead:
        if row_sharded(cfg):
            _collect_images(cfg, engine, state)
        return None
    if "pix2pix" in cfg.model:
        return _eval_pix2pix(cfg, engine, state, logger)
    if cfg.model == "srgan":
        return _eval_srgan(cfg, engine, state, logger)
    if cfg.model == "sagan":
        return _eval_sagan(cfg, engine, state, logger)
    if "cyclegan" in cfg.model:
        return _eval_cyclegan(cfg, engine, state, logger)
    raise NotImplementedError(cfg.model)


def _collect_images(cfg, engine, state):
    """The generator passes of the pix2pix eval, (loader, fakes, reals), or
    of CycleGAN's, {direction: (fakes, reals)}: both directions before any
    metric, as gcc_tpu collects them."""
    loader = create_dataset(eval_cfg(cfg, load_size=256), seed=1234)
    cap = None if cfg.ntest == float("inf") else int(cfg.ntest)
    if "cyclegan" in cfg.model:
        return {direction: _collect(cfg, engine, state, loader, key_in,
                                    key_out, cap, direction=direction)
                for direction, key_in, key_out in (("AtoB", "A", "B"),
                                                   ("BtoA", "B", "A"))}
    # direction swap as in set_input
    key_in, key_out = ("B", "A") if cfg.direction == "BtoA" else ("A", "B")
    return (loader,) + _collect(cfg, engine, state, loader, key_in, key_out,
                                cap)


def _eval_pix2pix(cfg, engine, state, logger):
    loader, fakes, reals = _collect_images(cfg, engine, state)
    if uses_miou(cfg):
        from gcc_tpu_torch.metrics.miou import compute_miou
        miou = compute_miou(cfg, fakes, loader.dataset, device=engine.device)
        logger.info(f"mIoU: {miou:.2f}")
        return miou
    fid = _real_fid(cfg, fakes, engine.device)
    if fid is not None:
        logger.info(f"FID: {fid:.2f}")
        return fid
    if "cityscapes" in cfg.dataroot:
        # maximize-direction proxy when DRN weights are absent
        p = float(np.mean([psnr_y(f, r) for f, r in zip(fakes, reals)]))
        logger.info(f"[proxy] PSNR (no DRN weights at drn_path): {p:.2f}")
        return p
    fid = pixel_fid(fakes, reals)
    logger.info(f"[proxy] pixel-FID (no inception weights): {fid:.4f}")
    return fid


def _eval_sagan(cfg, engine, state, logger):
    loader = create_dataset(eval_cfg(cfg, load_size=64), seed=1234)
    n_eval = max(1, int(0.1 * len(loader.dataset)))  # 10% (test_metric.py:144)
    fakes, reals = _collect(cfg, engine, state, loader, "z", "real_img",
                            n_eval)
    fid = _real_fid(cfg, fakes, engine.device)
    if fid is not None:
        logger.info(f"FID: {fid:.2f}")
        return fid
    fid = pixel_fid(fakes, reals)
    logger.info(f"[proxy] pixel-FID (no inception weights): {fid:.4f}")
    return fid


SR_TEST_SETS = ("Set5", "Set14", "B100", "Urban100")


def _eval_srgan(cfg, engine, state, logger) -> Dict[str, float]:
    """PSNR and SSIM on Y per test set, one image at a time
    (gcc_tpu/eval/orchestrators.py:157-192); a packed root names its sets
    as phases."""
    if is_packed_root(cfg.dataroot):
        with open(os.path.join(cfg.dataroot, PACK_META)) as f:
            packed = json.load(f).get("phases", {})
        available = [t for t in SR_TEST_SETS if t in packed]
    else:
        available = [t for t in SR_TEST_SETS if cfg.dataroot and os.path.isdir(
            os.path.join(cfg.dataroot, t))]
    available = available or ["val"]
    results: Dict[str, float] = {}
    for name in available:
        if cfg.dataset_mode == "synthetic":
            ds = SyntheticDataset(eval_cfg(cfg), seed=999, length=8)
        else:
            ds = build_dataset(eval_cfg(cfg), seed=0,
                               test_data_name=None if name == "val" else name)
        psnrs, ssims = [], []
        for i in range(len(ds)):
            item = ds[i]
            fake = to_host(engine.generate(
                state, to_device(item["lr"][None], engine.device)))[0]
            psnrs.append(psnr_y(fake, item["hr"]))
            ssims.append(ssim_y(fake, item["hr"]))
        results[f"{name}_psnr"] = float(np.mean(psnrs))
        results[f"{name}_ssim"] = float(np.mean(ssims))
        logger.info(f"{name}: PSNR: {results[f'{name}_psnr']:.2f} | "
                    f"SSIM: {results[f'{name}_ssim']:.4f}")
    return results


def _eval_cyclegan(cfg, engine, state, logger) -> Dict[str, float]:
    """Each direction's FID against the other domain's real statistics
    (real_stat_B.npz for AtoB, real_stat_A.npz for BtoA), or the proxy
    pixel-FID against its images (gcc_tpu/eval/orchestrators.py:212-235)."""
    out = {}
    for direction, (fakes, reals) in _collect_images(cfg, engine,
                                                     state).items():
        key_out = direction[-1]
        fid = _real_fid(cfg, fakes, engine.device, side=key_out)
        if fid is not None:
            out[direction] = fid
            logger.info(f"{direction} FID: {fid:.2f}")
        else:
            out[direction] = pixel_fid(fakes, reals)
            logger.info(f"[proxy] {direction} pixel-FID: "
                        f"{out[direction]:.4f}")
    return out
