"""Truncated VGG19 feature extractor (port of gcc_tpu/metrics/vgg.py;
models/GANLoss.py:95-144).

TruncatedVGG19(i=5, j=4): output = ReLU(conv5_4), torchvision's
``vgg19.features[:36]``: SRGAN's perceptual space (SRGAN.py:451-453) on
imagenet-normalised NCHW inputs. Conv names follow torchvision's feature
indices (conv_0, conv_2, conv_5, ...), so a torchvision state dict maps
across by name.

Weights: ``load_torch_vgg19`` reads a torchvision vgg19 state dict saved
by torch (read with ``weights_only=True``) or as an ``.npz``, into the JAX
package's parameter tree; torchvision itself is never imported. Without
weights the SRGAN engine switches the perceptual term off and says so.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gcc_tpu_torch.ops.layers import Conv
from gcc_tpu_torch.utils.weights import read_state_dict

# torchvision vgg19.features conv layer indices (configuration E)
VGG19_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34]
_POOL_AFTER = {2, 7, 16, 25}  # a 2x2 max pool follows the conv at these

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class TruncatedVGG19(nn.Module):
    """VGG19 features through ReLU(conv5_4); NCHW, imagenet-normalised."""

    def __init__(self):
        super().__init__()
        in_ch = 3
        for idx in VGG19_CONV_IDX:
            ch = 64 * min(2 ** sum(1 for p in _POOL_AFTER if p < idx), 8)
            self.add_module(f"conv_{idx}", Conv(in_ch, ch, (3, 3), (1, 1), 1))
            in_ch = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for idx in VGG19_CONV_IDX:
            h = torch.relu(getattr(self, f"conv_{idx}")(h))
            if idx in _POOL_AFTER:
                h = F.max_pool2d(h, 2, 2)
        return h


def load_torch_vgg19(path) -> Dict[str, dict]:
    """A torchvision vgg19 state dict (a file saved by torch, an ``.npz`` of
    it, or an in-memory {key: array} mapping) as the JAX-layout parameter
    tree {conv_<idx>: {kernel (HWIO), bias}} of numpy arrays."""
    sd = read_state_dict(path)
    params = {}
    for idx in VGG19_CONV_IDX:
        w = np.asarray(sd[f"features.{idx}.weight"], np.float32)  # OIHW
        params[f"conv_{idx}"] = {
            "kernel": np.transpose(w, (2, 3, 1, 0)),
            "bias": np.asarray(sd[f"features.{idx}.bias"], np.float32)}
    return params


def to_imagenet_norm(x_m11: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW -> imagenet-normalised (data/sr_dataset.py:52-56)."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x_m11.device)
    std = torch.as_tensor(IMAGENET_STD, device=x_m11.device)
    x01 = (x_m11 + 1.0) / 2.0
    return (x01 - mean[None, :, None, None]) / std[None, :, None, None]
