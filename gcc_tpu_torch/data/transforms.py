"""Image preprocessing on uint8 HWC arrays (port of gcc_tpu/data/transforms.py;
data/base_dataset.py:63-147).

The JAX package applies these to PIL images; here an image is a uint8
array, resized by ``resample.resize`` (Pillow's algorithm, bit for bit),
cropped and flipped by slicing. The random draws are the same calls in the
same order, so the same ``RandomState`` gives the same pixels. Outputs are
float32 HWC in [-1, 1] (ToTensor + Normalize(0.5, 0.5, 0.5)).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from gcc_tpu_torch.data.resample import BICUBIC, resize


def size_of(img: np.ndarray) -> Tuple[int, int]:
    """PIL's ``Image.size``: (width, height)."""
    return img.shape[1], img.shape[0]


def crop(img: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    """``Image.crop(box)``: (left, upper, right, lower); the part of the box
    outside the image is black, as PIL fills it."""
    left, top, right, bottom = (int(v) for v in box)
    h, w = img.shape[:2]
    out = np.zeros((bottom - top, right - left) + img.shape[2:], img.dtype)
    y0, y1 = max(top, 0), min(bottom, h)
    x0, x1 = max(left, 0), min(right, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


def get_params(cfg, size: Tuple[int, int],
               rng: np.random.RandomState) -> Dict:
    """Shared random crop/flip parameters (base_dataset.py:63-78)."""
    w, h = size
    new_w, new_h = w, h
    if cfg.preprocess == "resize_and_crop":
        new_w = new_h = cfg.load_size
    elif cfg.preprocess == "scale_width_and_crop":
        new_w = cfg.load_size
        new_h = cfg.load_size * h // w
    x = rng.randint(0, max(0, new_w - cfg.crop_size) + 1)
    y = rng.randint(0, max(0, new_h - cfg.crop_size) + 1)
    flip = rng.rand() > 0.5
    return {"crop_pos": (x, y), "flip": flip}


def scale_width(img: np.ndarray, target_size: int, crop_size: int,
                method=BICUBIC) -> np.ndarray:
    ow, oh = size_of(img)
    if ow == target_size and oh >= crop_size:
        return img
    w = target_size
    h = int(max(target_size * oh / ow, crop_size))
    return resize(img, (w, h), method)


def make_power_2(img: np.ndarray, base: int = 4, method=BICUBIC
                 ) -> np.ndarray:
    ow, oh = size_of(img)
    w, h = int(round(ow / base) * base), int(round(oh / base) * base)
    if (w, h) == (ow, oh):
        return img
    return resize(img, (w, h), method)


def apply_transform(cfg, img: np.ndarray, params: Optional[Dict] = None,
                    rng: Optional[np.random.RandomState] = None,
                    method=BICUBIC) -> np.ndarray:
    """get_transform(opt, params) applied to one RGB image
    (base_dataset.py:81-112). params=None draws crop/flip from rng (the
    reference's RandomCrop / RandomHorizontalFlip path)."""
    if "resize" in cfg.preprocess:
        img = resize(img, (cfg.load_size, cfg.load_size), method)
    elif "scale_width" in cfg.preprocess:
        img = scale_width(img, cfg.load_size, cfg.crop_size, method)

    if "crop" in cfg.preprocess:
        ow, oh = size_of(img)
        if params is None:
            x = rng.randint(0, max(0, ow - cfg.crop_size) + 1)
            y = rng.randint(0, max(0, oh - cfg.crop_size) + 1)
        else:
            x, y = params["crop_pos"]
        if ow > cfg.crop_size or oh > cfg.crop_size:
            img = crop(img, (x, y, x + cfg.crop_size, y + cfg.crop_size))

    if cfg.preprocess == "none":
        img = make_power_2(img, 4, method)

    if not cfg.no_flip:
        flip = (rng.rand() > 0.5) if params is None else params["flip"]
        if flip:
            img = img[:, ::-1]
    return to_tensor_norm(img)


def to_tensor_norm(img: np.ndarray) -> np.ndarray:
    """ToTensor + Normalize(0.5): HWC float32 in [-1, 1]."""
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr * 2.0 - 1.0


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    w, h = size_of(img)
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return crop(img, (left, top, left + size, top + size))
