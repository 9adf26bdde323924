"""Tiny image roots (at most 8 images a folder) for the port's packed-data
tests, and the configs that read them in either package."""

import os

import numpy as np
from PIL import Image

# (mode, preprocess, split): the packer's cases
CASES = [("aligned", "resize_and_crop", False),
         ("aligned", "scale_width_and_crop", False),
         ("aligned", "crop", False),
         ("unaligned", "resize_and_crop", True),
         ("sa", None, False),
         ("sr", None, False)]
IDS = ["aligned-resize", "aligned-scale_width", "aligned-crop-pad",
       "unaligned-split", "sa", "sr"]


def _imgs(d, n, w, h, seed, prefix="img"):
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(d, f"{prefix}_{i:03d}.png"))


def write_root(root, mode, preprocess=None):
    """An image root for ``mode``: aligned AB pairs (A 20x14 for the crop
    case, which pads past the bottom edge), unaligned A/B folders of 5 and
    7, sa images past the 160 centre crop, sr train images and a Set5."""
    if mode == "aligned":
        w, h = (40, 14) if preprocess == "crop" else (60, 20)
        _imgs(os.path.join(root, "train"), 6, w, h, 0)
    elif mode == "unaligned":
        _imgs(os.path.join(root, "trainA"), 5, 40, 30, 1)
        _imgs(os.path.join(root, "trainB"), 7, 36, 28, 2)
    elif mode == "sa":
        _imgs(os.path.join(root, "train"), 4, 200, 180, 3)
    else:
        _imgs(os.path.join(root, "train"), 4, 70, 60, 4)
        _imgs(os.path.join(root, "Set5"), 2, 37, 53, 5)
    return root


def cfg_kw(root, mode, preprocess=None, split=False, **kw):
    """Config fields of a run on ``root`` (the same in both packages)."""
    base = dict(dataroot=str(root), phase="train", dataset_mode=mode,
                num_threads=2)
    if mode in ("aligned", "unaligned"):
        base.update(load_size=24, crop_size=16, no_flip=False,
                    preprocess=preprocess, split_dataset=split)
    elif mode == "sa":
        base.update(model="sagan", crop_size=32, center_crop=True, z_dim=8)
    else:
        base.update(model="srgan", image_size=48, upscale_factor=4)
    base.update(kw)
    return base
