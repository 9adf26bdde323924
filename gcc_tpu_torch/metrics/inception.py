"""FID InceptionV3 (pool3, 2048-d) — port of gcc_tpu/metrics/inception.py
(the reference's metric/inception.py:16-315).

torchvision's InceptionV3 with the TF-FID patches the reference applies
(metric/inception.py:166-315): every in-block average pool divides by the
real window (``count_include_pad=False``), and the last InceptionE block
(Mixed_7c) max-pools in its pool branch. Convolutions are bias-free, then
BatchNorm (eps 1e-3) and ReLU (BasicConv2d).

Modules carry the reference's names (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch1x1.bn.running_var``, ...), so the TF-FID state dict
(``pt_inception-2015-12-05-6726825d.pth``) strict-loads; its 1008-way
``fc`` head, which pool3 never reads, is dropped first.

Input protocol (metric/fid_score.py:147-216): [-1, 1] images -> uint8 ->
/255 -> bilinear resize to 299 (no corner alignment, no antialiasing) ->
2x - 1 -> network -> global mean -> 2048-d activations. The evaluator runs
in fp32 with TF32 off (``device.exact_fp32``), in eval mode.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gcc_tpu_torch.device import exact_fp32, resolve_device
from gcc_tpu_torch.utils.weights import clean_state_dict, read_state_dict

# the reference's 1008-class logits head: in the TF-FID file, unused by FID
HEAD_KEYS = ("fc.weight", "fc.bias")


class BasicConv2d(nn.Module):
    """Bias-free conv + BatchNorm(eps 1e-3) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def avg_pool_nocountpad(x, window=3, stride=1, pad=1):
    """avg_pool2d(count_include_pad=False): divide by the real window."""
    return F.avg_pool2d(x, window, stride, pad, count_include_pad=False)


def max_pool(x, window=3, stride=2, pad=0):
    return F.max_pool2d(x, window, stride, pad)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(avg_pool_nocountpad(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(avg_pool_nocountpad(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool  # FIDInceptionE_2 (Mixed_7c)
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = max_pool(x, 3, 1, 1) if self.use_max_pool \
            else avg_pool_nocountpad(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)],
                         1)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate(bilinear, align_corners=False), no antialiasing: the
    FID input resize (inception.py:160-162)."""
    return F.interpolate(x, size=(299, 299), mode="bilinear",
                         align_corners=False, antialias=False)


class FIDInceptionV3(nn.Module):
    """pool3 (2048-d) feature extractor; input NCHW in [0, 1], any size
    (at least 75 without the resize)."""

    def __init__(self, resize_input: bool = True,
                 normalize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)

    def forward(self, x):
        if self.resize_input:
            x = resize_299(x)
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = max_pool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # global average pool -> 2048


def load_torch_fid_inception(path) -> FIDInceptionV3:
    """The TF-FID state dict (a file saved by torch, read with
    ``weights_only=True``; an ``.npz`` of it; or an in-memory {key: array}
    mapping) strict-loaded into a CPU ``FIDInceptionV3`` in eval mode."""
    sd = clean_state_dict(read_state_dict(path), ignore=HEAD_KEYS)
    net = FIDInceptionV3()
    net.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in sd.items()}, strict=True)
    return net.eval()


class InceptionExtractor:
    """Batched pool3 activations of [-1, 1] NHWC images on one device
    (fid_score.py:147-216). The uint8 round trip (tensor2imgs) is the
    reference's, bit for bit."""

    _cache: Dict[Tuple[str, str], "InceptionExtractor"] = {}

    def __init__(self, net: FIDInceptionV3, device=None,
                 batch_size: int = 50):
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.batch_size = batch_size

    @classmethod
    def get(cls, path: str, device=None) -> "InceptionExtractor":
        """One extractor per (weights file, device)."""
        key = (str(path), str(resolve_device(device)))
        if key not in cls._cache:
            cls._cache[key] = cls(load_torch_fid_inception(path), device)
        return cls._cache[key]

    def activations(self, images_m11: np.ndarray) -> np.ndarray:
        imgs = np.asarray(images_m11, np.float32)
        u8 = np.clip((imgs + 1) / 2 * 255.0, 0, 255).astype(np.uint8)
        out = []
        with torch.no_grad(), exact_fp32():
            for i in range(0, len(u8), self.batch_size):
                x = torch.from_numpy(u8[i:i + self.batch_size]).to(
                    self.device).permute(0, 3, 1, 2).float() / 255.0
                out.append(self.net(x).cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, 2048),
                                                        np.float32)
