"""Image conversion and saving (port of gcc_tpu/utils/image.py;
utils/util.py:45-95, 208-235).

tensor2im: [-1, 1] float NHWC -> uint8 HWC; save_images writes
<name>_<label>.png per visual, as the reference's test loops do. The PNG is
written here (8-bit RGB or grayscale, zlib, no filter), so the port needs
no Pillow; ``aspect_ratio`` resizes with Pillow's bicubic (``data.resample``).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict

import numpy as np

from gcc_tpu_torch.data.resample import BICUBIC, resize


def tensor2im(arr, imtype=np.uint8) -> np.ndarray:
    """First image of an NHWC batch in [-1,1] -> HWC uint8."""
    arr = np.asarray(arr)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    img = (arr + 1.0) / 2.0 * 255.0
    return np.clip(img, 0, 255).astype(imtype)


def png_bytes(img: np.ndarray) -> bytes:
    """A PNG file of a uint8 HxWx3 (RGB) or HxW (grayscale: a label map)
    image."""
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or img.ndim == 3 and img.shape[2] == 3):
        raise ValueError(f"png_bytes takes uint8 HxWx3 or HxW, not "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))

    # every row starts with filter type 0 (none)
    channels = 1 if img.ndim == 2 else 3
    rows = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(
        img).reshape(h, w * channels)], 1)
    color = 0 if channels == 1 else 2  # grayscale / truecolour
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_image(image_numpy: np.ndarray, image_path: str,
               aspect_ratio: float = 1.0) -> None:
    os.makedirs(os.path.dirname(image_path) or ".", exist_ok=True)
    h, w = image_numpy.shape[:2]
    if aspect_ratio > 1.0:
        image_numpy = resize(image_numpy, (w, int(h * aspect_ratio)), BICUBIC)
    elif aspect_ratio < 1.0:
        image_numpy = resize(image_numpy, (int(w / aspect_ratio), h), BICUBIC)
    with open(image_path, "wb") as f:
        f.write(png_bytes(image_numpy))


def save_images(save_dir: str, visuals: Dict[str, np.ndarray],
                image_name: str, aspect_ratio: float = 1.0) -> None:
    base = os.path.splitext(os.path.basename(image_name))[0]
    for label, im_data in visuals.items():
        save_image(tensor2im(im_data),
                   os.path.join(save_dir, f"{base}_{label}.png"),
                   aspect_ratio=aspect_ratio)
