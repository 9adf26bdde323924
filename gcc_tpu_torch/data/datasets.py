"""Dataset classes: aligned / sa / synthetic (port of gcc_tpu/data/datasets.py).

Host-side objects returning numpy dicts (NHWC float32); batching and
shuffling live in ``loader``, the move to the device in the CLI. The
preprocessing is the JAX package's, bit for bit (``transforms``):

  * AlignedDataset    data/aligned_dataset.py:7-60 (side-by-side AB pairs,
    identical transform params on both halves)
  * SADataset         data/sa_dataset.py:9-50 (flat dir, optional
    center-crop 160, per-item z ~ N(0, 1))
  * SyntheticDataset  procedurally generated images, so tests and the card
    need no downloads (modes aligned and sa).

Decoding an image file needs Pillow; it is imported by ``read_rgb`` alone.
The unaligned and sr folder datasets come with their families' ports.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from gcc_tpu_torch.data.image_folder import make_dataset
from gcc_tpu_torch.data.resample import BICUBIC, BILINEAR, resize
from gcc_tpu_torch.data.rng import LockedRandomState
from gcc_tpu_torch.data.transforms import (
    apply_transform, center_crop, crop, get_params, size_of, to_tensor_norm,
)


def read_rgb(path: str) -> np.ndarray:
    """An image file as a uint8 HWC RGB array (``Image.open(path)
    .convert("RGB")``)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs Pillow, which is not installed; use "
            f"--dataset_mode synthetic, or install Pillow to read image "
            f"folders") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class AlignedDataset:
    def __init__(self, cfg, seed: int = 0):
        self.cfg = cfg
        self.dir_AB = os.path.join(cfg.dataroot, cfg.phase)
        self.AB_paths = sorted(make_dataset(self.dir_AB, cfg.max_dataset_size))
        if cfg.load_size < cfg.crop_size:
            raise ValueError(f"load_size {cfg.load_size} < crop_size "
                             f"{cfg.crop_size}")
        self.rng = LockedRandomState(seed)

    def __len__(self):
        return len(self.AB_paths)

    def __getitem__(self, index) -> Dict:
        path = self.AB_paths[index]
        AB = read_rgb(path)
        w, h = size_of(AB)
        w2 = w // 2
        A = crop(AB, (0, 0, w2, h))
        B = crop(AB, (w2, 0, w, h))
        params = get_params(self.cfg, size_of(A), self.rng)
        A = apply_transform(self.cfg, A, params)
        B = apply_transform(self.cfg, B, params)
        return {"A": A, "B": B, "A_paths": path, "B_paths": path}


class SADataset:
    def __init__(self, cfg, seed: int = 0):
        self.cfg = cfg
        self.data_folder = os.path.join(cfg.dataroot, cfg.phase)
        self.image_file_names = sorted(os.listdir(self.data_folder))
        self.rng = LockedRandomState(seed)

    def __len__(self):
        return len(self.image_file_names)

    def __getitem__(self, index) -> Dict:
        name = self.image_file_names[index]
        img = read_rgb(os.path.join(self.data_folder, name))
        if self.cfg.center_crop:
            img = center_crop(img, 160)
        img = resize(img, (self.cfg.crop_size, self.cfg.crop_size),
                     BILINEAR)  # torchvision Resize default
        real = to_tensor_norm(img)
        z = self.rng.randn(self.cfg.z_dim).astype(np.float32)
        return {"z": z, "real_img": real, "img_path": name}


class SyntheticDataset:
    """Procedural data for tests and the card: smooth random fields for B
    (and SAGAN's real images) and an edge-map-like rendition for A."""

    def __init__(self, cfg, seed: int = 0, length: Optional[int] = None):
        self.cfg = cfg
        if length is None:
            # a finite --max_dataset_size sets the epoch size directly;
            # unbounded keeps the small test default
            length = (int(cfg.max_dataset_size)
                      if np.isfinite(cfg.max_dataset_size) else 64)
        self.length = int(min(length, cfg.max_dataset_size))
        self.seed = seed
        self.mode = cfg.dataset_mode if cfg.dataset_mode != "synthetic" else {
            "pix2pix": "aligned", "cyclegan": "unaligned",
            "sagan": "sa", "srgan": "sr"}.get(cfg.model, "aligned")
        if self.mode not in ("aligned", "sa"):
            raise NotImplementedError(
                f"synthetic mode {self.mode!r} comes with the CycleGAN and "
                f"SRGAN ports (ROADMAP Queue A)")
        self.rng = LockedRandomState(seed)

    def __len__(self):
        return self.length

    def _image(self, index: int, size: int) -> np.ndarray:
        rng = np.random.RandomState(self.seed * 100003 + index * 31)
        low = rng.rand(8, 8, 3).astype(np.float32)
        img = np.asarray(resize((low * 255).astype(np.uint8), (size, size),
                                BICUBIC), np.float32) / 255.0
        return img * 2.0 - 1.0

    def __getitem__(self, index) -> Dict:
        cfg = self.cfg
        if self.mode == "aligned":
            B = self._image(index, cfg.crop_size)
            A = np.sign(B) * np.abs(B) ** 0.5
            return {"A": A.astype(np.float32), "B": B.astype(np.float32),
                    "A_paths": f"synthetic_{index}.png",
                    "B_paths": f"synthetic_{index}.png"}
        return {"z": self.rng.randn(cfg.z_dim).astype(np.float32),
                "real_img": self._image(index, cfg.crop_size),
                "img_path": f"synthetic_{index}.png"}
