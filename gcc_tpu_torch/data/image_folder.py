"""Recursive image discovery (copy of gcc_tpu/data/image_folder.py;
data/image_folder.py:24-47)."""

from __future__ import annotations

import os
from typing import List

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp",
                  ".tif", ".tiff", ".webp")


def is_image_file(fname: str) -> bool:
    return fname.lower().endswith(IMG_EXTENSIONS)


def make_dataset(directory: str, max_dataset_size=float("inf")) -> List[str]:
    images = []
    assert os.path.isdir(directory), f"{directory} is not a valid directory"
    for root, _, fnames in sorted(os.walk(directory)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(root, fname))
    return images[:min(int(max_dataset_size) if max_dataset_size != float("inf")
                       else len(images), len(images))]


def make_split_dataset(directory: str, max_dataset_size=float("inf"),
                       first_part: bool = True) -> List[str]:
    """Half split (data/image_folder.py:35-47)."""
    images = make_dataset(directory, float("inf"))
    n = min(int(max_dataset_size) if max_dataset_size != float("inf")
            else len(images), len(images))
    return images[: n // 2] if first_part else images[n // 2:]
