"""Cityscapes mIoU: DRN-D-105 segmentation network and protocol — port of
gcc_tpu/metrics/miou.py (the reference's metric/drn.py:104-255 and
metric/mIoU_score.py:20-218).

  fake [-1, 1] -> uint8 -> Pillow BILINEAR resize to the label's size
  (2048x1024 on cityscapes; ``data.resample``, bit for bit) -> /255 ->
  the reference's cityscapes mean/std -> DRN-D-105 -> 1x1 seg head (19
  classes) -> the fixed bilinear 8x grouped transpose conv -> argmax ->
  confusion histogram against the label named by table.txt -> mean
  per-class IoU x 100, rounded to 2 decimals.

Arch D: a 7x7 stem, conv-bn-relu stacks (layers 1-2, and 7-8 dilated
(2, 1) with no residual), Bottleneck stacks (layers 3-6, dilations
1, 1, 2, 4); channels (16, 32, 64, 128, 256, 512, 512, 512), depths
(1, 1, 3, 4, 23, 3, 1, 1) for DRN-D-105, read from the checkpoint's keys
(``infer_drn_layers``) so thin fixtures run the same code. Modules carry
the reference's names (``base.<l>.<i>...``, ``seg.*``); the fixed ``up``
kernel is a constant, not a weight, and is dropped from a file that has it.
The network runs in fp32 with TF32 off, in eval mode.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from gcc_tpu_torch.device import exact_fp32, resolve_device
from gcc_tpu_torch.utils.weights import clean_state_dict, read_state_dict

CITYSCAPES_MEAN = np.array([0.29010095242892997, 0.32808144844279574,
                            0.28696394422942517], np.float32)
CITYSCAPES_STD = np.array([0.1829540508368939, 0.18656561047509476,
                           0.18447508988480435], np.float32)
DRN_D_105_LAYERS = (1, 1, 3, 4, 23, 3, 1, 1)
DRN_CHANNELS = (16, 32, 64, 128, 256, 512, 512, 512)
N_CLASSES = 19
UP_KEYS = ("up.weight",)  # the fixed deconv kernel some checkpoints carry


def conv_bn_relu(cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1) -> list:
    pad = dilation if kernel == 3 else kernel // 2
    return [nn.Conv2d(cin, cout, kernel, stride, pad, dilation, bias=False),
            nn.BatchNorm2d(cout), nn.ReLU(inplace=True)]


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, dilation, dilation,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
            nn.BatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class DRNSeg(nn.Module):
    """DRN-D base + 19-class seg head: NCHW normalised input -> logits at
    1/8 resolution (``upsample_logits_8x`` brings them back)."""

    def __init__(self, layers: Sequence[int] = DRN_D_105_LAYERS,
                 classes: int = N_CLASSES):
        super().__init__()
        ch, ly = DRN_CHANNELS, tuple(layers)
        base = [nn.Sequential(*conv_bn_relu(3, ch[0], kernel=7))]
        for cin, cout, n, stride, dil in ((ch[0], ch[0], ly[0], 1, 1),
                                          (ch[0], ch[1], ly[1], 2, 1)):
            base.append(nn.Sequential(*[m for i in range(n) for m in
                                        conv_bn_relu(cin if i == 0 else cout,
                                                     cout, 3,
                                                     stride if i == 0 else 1,
                                                     dil)]))
        inplanes = ch[1]
        for planes, n, stride, dil in ((ch[2], ly[2], 2, 1),
                                       (ch[3], ly[3], 2, 1),
                                       (ch[4], ly[4], 1, 2),
                                       (ch[5], ly[5], 1, 4)):
            blocks = []
            for b in range(n):
                down = b == 0 and (stride != 1 or inplanes != planes * 4)
                blocks.append(Bottleneck(inplanes, planes,
                                         stride if b == 0 else 1, dil, down))
                inplanes = planes * 4
            base.append(nn.Sequential(*blocks))
        for cout, n, dil in ((ch[6], ly[6], 2), (ch[7], ly[7], 1)):
            base.append(nn.Sequential(*[m for i in range(n) for m in
                                        conv_bn_relu(inplanes if i == 0
                                                     else cout, cout, 3, 1,
                                                     dil)]))
            inplanes = cout if n else inplanes
        self.base = nn.Sequential(*base)
        self.seg = nn.Conv2d(inplanes, classes, 1, bias=True)

    def forward(self, x):
        return self.seg(self.base(x))


def bilinear_up_weights(k: int = 16) -> np.ndarray:
    """fill_up_weights: the bilinear kernel of the fixed grouped deconv."""
    f = (k + 1) // 2
    c = f - 1 if k % 2 == 1 else f - 0.5
    og = np.ogrid[:k, :k]
    return ((1 - abs(og[0] - c) / f) * (1 - abs(og[1] - c) / f)).astype(
        np.float32)


def upsample_logits_8x(logits: torch.Tensor) -> torch.Tensor:
    """The fixed grouped ConvTranspose2d(16, stride 8, padding 4) with
    bilinear weights, one group per class (mIoU_score.py:144-151)."""
    c = logits.shape[1]
    k = torch.as_tensor(bilinear_up_weights(16), device=logits.device,
                        dtype=logits.dtype)
    return F.conv_transpose2d(logits, k.expand(c, 1, 16, 16), stride=8,
                              padding=4, groups=c)


def fast_hist(pred: np.ndarray, label: np.ndarray, n: int) -> np.ndarray:
    k = (label >= 0) & (label < n)
    return np.bincount(n * label[k].astype(int) + pred[k],
                       minlength=n ** 2).reshape(n, n)


def per_class_iu(hist: np.ndarray) -> np.ndarray:
    return np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))


def miou_from_hist(hist: np.ndarray) -> float:
    return float(round(np.nanmean(per_class_iu(hist) * 100), 2))


def _drn_sd(path) -> dict:
    """A DRNSeg state dict (--drn_path: a file saved by torch, an .npz of
    it, or an in-memory mapping): ``module.`` prefixes stripped, BatchNorm
    counters and the fixed ``up`` kernel dropped."""
    return clean_state_dict(read_state_dict(path), ignore=UP_KEYS)


def infer_drn_layers(sd: dict) -> tuple:
    """Per-layer block depths from a DRNSeg state dict's keys: conv-bn-relu
    stacks (layers 1-2, 7-8) have ``base.<l>.<3i>.weight``, Bottleneck
    stacks (3-6) ``base.<l>.<b>.conv1.weight``. DRN-D-105 gives
    (1, 1, 3, 4, 23, 3, 1, 1)."""
    ly = []
    for li in range(1, 9):
        probe = (f"base.{li}.{{}}.conv1.weight" if 3 <= li <= 6
                 else f"base.{li}.{{}}.weight")
        step = 1 if 3 <= li <= 6 else 3
        n = 0
        while probe.format(step * n) in sd:
            n += 1
        ly.append(n)
    return tuple(ly)


def load_torch_drnseg(path, layers: Optional[Sequence[int]] = None
                      ) -> DRNSeg:
    """A DRNSeg checkpoint strict-loaded into a CPU ``DRNSeg`` in eval mode;
    its depths are the file's unless ``layers`` names them."""
    sd = _drn_sd(path)
    net = DRNSeg(layers=tuple(layers) if layers else infer_drn_layers(sd))
    net.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in sd.items()}, strict=True)
    return net.eval()


def resize_logits_pil(logits_nhwc: np.ndarray, width: int,
                      height: int) -> np.ndarray:
    """resize_4d_tensor: Pillow's per-channel float ("F") BILINEAR resize
    (mIoU_score.py:169-193), in numpy."""
    from gcc_tpu_torch.data.resample import BILINEAR, resize_float
    return np.stack([resize_float(im, (width, height), BILINEAR)
                     for im in np.asarray(logits_nhwc, np.float32)])


def miou_histogram(cfg, fakes_m11: np.ndarray, dataset,
                   table_path: Optional[str] = None, device=None
                   ) -> np.ndarray:
    """The 19x19 confusion histogram of the mIoU protocol on generated
    cityscapes photos (mIoU_score.py:195-218 with SegList's 2048x1024
    resize, l.78). The resolution is the label file's own: 2048x1024 on
    cityscapes, smaller on test fixtures. DRN (--drn_path) runs on
    ``device``: the card unless the CPU is asked for."""
    from gcc_tpu_torch.data.datasets import read_rgb
    from gcc_tpu_torch.data.resample import BILINEAR, resize

    dev = resolve_device(device)
    net = load_torch_drnseg(cfg.drn_path).to(dev)
    # table.txt rows: "<name> <label file> <leftImg8bit file>"
    with open(table_path or os.path.join(
            os.path.dirname(cfg.drn_path) or cfg.dataroot, "table.txt")) as f:
        table = [line.strip().split(" ") for line in f if line.strip()]
    names = [os.path.splitext(os.path.basename(p))[0]
             for p in getattr(dataset, "AB_paths", [])][:len(fakes_m11)]
    mean = torch.as_tensor(CITYSCAPES_MEAN, device=dev)[None, :, None, None]
    std = torch.as_tensor(CITYSCAPES_STD, device=dev)[None, :, None, None]

    hist = np.zeros((N_CLASSES, N_CLASSES))
    for fake, name in zip(fakes_m11, names):
        label_file = next((item[1] for item in table if item[0] == name
                           or item[2][:-len(".png")].endswith(name)), None)
        if label_file is None:
            continue
        label = np.asarray(read_rgb(os.path.join(cfg.dataroot, label_file),
                                    mode=None), np.int64)
        lh, lw = label.shape[:2]
        u8 = np.clip((fake + 1) / 2 * 255, 0, 255).astype(np.uint8)
        img = resize(u8, (lw, lh), BILINEAR)
        with torch.no_grad(), exact_fp32():
            x = torch.from_numpy(img).to(dev).permute(2, 0, 1)[None]
            x = (x.float() / 255.0 - mean) / std
            up = upsample_logits_8x(net(x))
            if up.shape[2:] == (lh, lw):
                pred = up.argmax(1)[0].cpu().numpy()
            else:
                up = resize_logits_pil(
                    up.permute(0, 2, 3, 1).cpu().numpy(), lw, lh)
                pred = up.argmax(-1)[0]
        hist += fast_hist(pred.flatten(), label.flatten(), N_CLASSES)
    return hist


def compute_miou(cfg, fakes_m11: np.ndarray, dataset,
                 table_path: Optional[str] = None, device=None) -> float:
    """mIoU x 100 of ``miou_histogram``, rounded to 2 decimals."""
    return miou_from_hist(miou_histogram(cfg, fakes_m11, dataset,
                                         table_path, device))
