"""Dataset classes: aligned / unaligned / sa / sr / synthetic (port of
gcc_tpu/data/datasets.py).

Host-side objects returning numpy dicts (NHWC float32); batching and
shuffling live in ``loader``, the move to the device in the CLI. The
preprocessing is the JAX package's, bit for bit (``transforms``):

  * AlignedDataset    data/aligned_dataset.py:7-60 (side-by-side AB pairs,
    identical transform params on both halves)
  * UnalignedDataset  data/unaligned_dataset.py:8-79 (random B index
    unless serial_batches; independent transforms per side; optional half
    split)
  * SADataset         data/sa_dataset.py:9-50 (flat dir, optional
    center-crop 160, per-item z ~ N(0, 1))
  * SRDataset         data/sr_dataset.py:122-183 (train: random HR crop ->
    bicubic /scale LR; test: the largest scale-divisible centre crop; LR
    imagenet-normalised, HR in [-1, 1])
  * SyntheticDataset  procedurally generated images, so tests and the card
    need no downloads (modes aligned, unaligned, sa and sr).

Decoding an image file (a photo, or a label map for mIoU) needs Pillow; it
is imported by ``read_rgb`` alone.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from gcc_tpu_torch.data.image_folder import make_dataset, make_split_dataset
from gcc_tpu_torch.data.resample import BICUBIC, BILINEAR, resize
from gcc_tpu_torch.data.rng import LockedRandomState
from gcc_tpu_torch.data.transforms import (
    apply_transform, center_crop, crop, get_params, size_of, to_tensor_norm,
)
from gcc_tpu_torch.metrics.vgg import IMAGENET_MEAN, IMAGENET_STD


def read_rgb(path: str, mode: Optional[str] = "RGB") -> np.ndarray:
    """An image file as a uint8 HWC RGB array (``Image.open(path)
    .convert("RGB")``); ``mode=None`` keeps the file's own mode (a label
    map's "L" or "P": HW class indices)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs Pillow, which is not installed; use "
            f"--dataset_mode synthetic, or install Pillow to read image "
            f"folders") from e
    with Image.open(path) as im:
        return np.asarray(im if mode is None else im.convert(mode))


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


class UnalignedDataset:
    def __init__(self, cfg, seed: int = 0, first_part: bool = True):
        self.cfg = cfg
        self.dir_A = os.path.join(cfg.dataroot, cfg.phase + "A")
        self.dir_B = os.path.join(cfg.dataroot, cfg.phase + "B")
        if cfg.split_dataset:
            self.A_paths = sorted(make_split_dataset(
                self.dir_A, cfg.max_dataset_size, first_part))
            self.B_paths = sorted(make_split_dataset(
                self.dir_B, cfg.max_dataset_size, first_part))
        else:
            self.A_paths = sorted(make_dataset(self.dir_A,
                                               cfg.max_dataset_size))
            self.B_paths = sorted(make_dataset(self.dir_B,
                                               cfg.max_dataset_size))
        self.rng = LockedRandomState(seed)

    def __len__(self):
        return max(len(self.A_paths), len(self.B_paths))

    def __getitem__(self, index) -> Dict:
        A_path = self.A_paths[index % len(self.A_paths)]
        if self.cfg.serial_batches:
            B_path = self.B_paths[index % len(self.B_paths)]
        else:
            B_path = self.B_paths[self.rng.randint(0, len(self.B_paths))]
        A = apply_transform(self.cfg, read_rgb(A_path), params=None,
                            rng=self.rng)
        B = apply_transform(self.cfg, read_rgb(B_path), params=None,
                            rng=self.rng)
        return {"A": A, "B": B, "A_paths": A_path, "B_paths": B_path}


def imagenet_norm(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 in [0, 1], imagenet-normalised (the LR input,
    sr_dataset.py:52-56)."""
    return ((np.asarray(img, np.float32) / 255.0 - IMAGENET_MEAN)
            / IMAGENET_STD).astype(np.float32)


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


class SRDataset:
    def __init__(self, cfg, seed: int = 0,
                 test_data_name: Optional[str] = None):
        self.cfg = cfg
        folder = test_data_name if test_data_name else cfg.phase
        self.data_folder = os.path.join(cfg.dataroot, folder)
        self.split = ("train" if cfg.phase.lower() == "train"
                      and test_data_name is None else "test")
        self.crop_size = int(cfg.image_size)
        self.scale = int(cfg.upscale_factor)
        self.image_file_names = sorted(os.listdir(self.data_folder))
        self.rng = LockedRandomState(seed)

    def __len__(self):
        return len(self.image_file_names)

    def __getitem__(self, index) -> Dict:
        name = self.image_file_names[index]
        img = read_rgb(os.path.join(self.data_folder, name))
        w, h = size_of(img)
        if self.split == "train":
            # random crop, low bound 1 as the reference (sr_dataset.py:94-95)
            left = self.rng.randint(1, w - self.crop_size + 1)
            top = self.rng.randint(1, h - self.crop_size + 1)
            hr = crop(img, (left, top, left + self.crop_size,
                            top + self.crop_size))
        else:
            xr, yr = w % self.scale, h % self.scale
            hr = crop(img, (xr // 2, yr // 2, xr // 2 + w - xr,
                            yr // 2 + h - yr))
        hw, hh = size_of(hr)
        lr = resize(hr, (hw // self.scale, hh // self.scale), BICUBIC)
        return {"lr": imagenet_norm(lr), "hr": to_tensor_norm(hr),
                "lr_names": name, "hr_names": name}


class SyntheticDataset:
    """Procedural data for tests and the card: smooth random fields for B
    (and SAGAN's and SRGAN's real images), an edge-map-like rendition for
    A in aligned mode and a second field in unaligned mode."""

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
        if self.mode not in ("aligned", "unaligned", "sa", "sr"):
            raise NotImplementedError(f"synthetic mode {self.mode!r}")
        self.rng = LockedRandomState(seed)

    def __len__(self):
        return self.length

    def _image(self, index: int, size: int, salt: int = 0) -> np.ndarray:
        rng = np.random.RandomState(self.seed * 100003 + index * 31 + salt)
        low = rng.rand(8, 8, 3).astype(np.float32)
        img = np.asarray(resize((low * 255).astype(np.uint8), (size, size),
                                BICUBIC), np.float32) / 255.0
        return img * 2.0 - 1.0

    def __getitem__(self, index) -> Dict:
        cfg = self.cfg
        if self.mode in ("aligned", "unaligned"):
            B = self._image(index, cfg.crop_size)
            A = np.sign(B) * np.abs(B) ** 0.5 if self.mode == "aligned" \
                else self._image(index, cfg.crop_size, 1)
            return {"A": A.astype(np.float32), "B": B.astype(np.float32),
                    "A_paths": f"synthetic_{index}.png",
                    "B_paths": f"synthetic_{index}.png"}
        if self.mode == "sr":
            hr = self._image(index, cfg.image_size)
            lr = resize(((hr + 1) / 2 * 255).astype(np.uint8),
                        (cfg.image_size // cfg.upscale_factor,) * 2, BICUBIC)
            return {"lr": imagenet_norm(lr), "hr": hr.astype(np.float32),
                    "lr_names": f"synthetic_{index}.png",
                    "hr_names": f"synthetic_{index}.png"}
        return {"z": self.rng.randn(cfg.z_dim).astype(np.float32),
                "real_img": self._image(index, cfg.crop_size),
                "img_path": f"synthetic_{index}.png"}
