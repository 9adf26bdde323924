"""Analytic MACs / parameter counting (port of gcc_tpu/compress/macs.py;
replaces thop, utils/prune_util.py:6-18).

Conventions follow thop's count_convNd: MACs per conv = out_numel *
(in_channels / groups) * kh * kw; ConvTranspose identical with its own output
size; Linear = in * out. Norm/activation layers contribute zero (their FLOPs
are negligible at every reference budget; thop's BN hook is also disabled in
train mode). Units: raw MACs; callers divide by 1e9 for the GMACs budgets in
scripts/*/train.sh.

MACs are pure functions of the cfg lists, so the prune-threshold binary
search (utils/prune_util.py:20-47) runs with no model construction at all —
the reference rebuilds and profiles a full torch model per probe.

Elision rules mirror the constructors: U-Net blocks vanish when their cfg
pair is zero (models/Pix2Pix.py:87-103), resnet blocks when layer1 is zero
(models/CycleGAN.py:112-113), SRResNet blocks when inner width is zero
(models/SRGAN.py:164-166).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.nn as nn

from gcc_tpu_torch.models.generators import (
    mobile_resnet_default_cfg, sagan_default_filter_cfgs,
    unet_default_filter_cfgs, unet_existing_depths,
)


def conv_macs(out_hw: int, out_c: int, in_c: int, k: int, groups: int = 1) -> int:
    return out_hw * out_hw * out_c * (in_c // groups) * k * k


# ---------------------------------------------------------------------------
# U-Net (pix2pix)
# ---------------------------------------------------------------------------

def unet_macs(filter_cfgs: Optional[Sequence[int]], num_downs: int = 8,
              image_size: int = 256, input_nc: int = 3,
              output_nc: int = 3, ngf: int = 64) -> int:
    """MACs of UnetGenerator(filter_cfgs) on a single image_size^2 input."""
    f = list(filter_cfgs) if filter_cfgs is not None else \
        unet_default_filter_cfgs(ngf, num_downs)
    n = num_downs
    depths = unet_existing_depths(f, n)

    total = 0
    in_ch, hw = input_nc, image_size
    widths = {}
    for d in depths:
        hw //= 2
        total += conv_macs(hw, f[d], in_ch, 4)
        widths[d] = f[d]
        in_ch = f[d]
    for d in reversed(depths):
        hw *= 2
        out_ch = output_nc if d == 0 else f[2 * n - 1 - d]
        total += conv_macs(hw, out_ch, in_ch, 4)
        if d == 0:
            break
        shallower = max(dd for dd in depths if dd < d)
        in_ch = widths[shallower] + out_ch
    return total


# ---------------------------------------------------------------------------
# Mobile ResNet (cyclegan / pix2pix resnet backbone)
# ---------------------------------------------------------------------------

def mobile_resnet_macs(cfg: Optional[Sequence[int]], n_blocks: int = 9,
                       image_size: int = 256, input_nc: int = 3,
                       output_nc: int = 3, ngf: int = 64) -> int:
    c = list(cfg) if cfg is not None else mobile_resnet_default_cfg(ngf, n_blocks)

    total = 0
    hw = image_size
    total += conv_macs(hw, c[0], input_nc, 7)
    in_ch = c[0]
    for i in range(2):
        hw //= 2
        total += conv_macs(hw, c[1 + i], in_ch, 3)
        in_ch = c[1 + i]
    body = in_ch  # residual trunk width
    for b in range(n_blocks):
        l1, l2 = c[3 + 2 * b], c[4 + 2 * b]
        if l1 == 0:
            continue
        # SeparableConv = depthwise(k3, groups=in) + pointwise(1x1)
        total += conv_macs(hw, body, body, 3, groups=body) + conv_macs(hw, l1, body, 1)
        total += conv_macs(hw, l1, l1, 3, groups=l1) + conv_macs(hw, l2, l1, 1)
    for i in range(2):
        hw *= 2
        total += conv_macs(hw, c[3 + 2 * n_blocks + i], in_ch, 3)
        in_ch = c[3 + 2 * n_blocks + i]
    total += conv_macs(hw, output_nc, in_ch, 7)
    return total


# ---------------------------------------------------------------------------
# SAGAN generator
# ---------------------------------------------------------------------------

def sagan_macs(filter_cfgs: Optional[Sequence[int]], z_dim: int = 128,
               image_size: int = 64, ngf: int = 64) -> int:
    f = list(filter_cfgs) if filter_cfgs is not None else \
        sagan_default_filter_cfgs(ngf, image_size)

    total = 0
    # deconv stages: 1->4->8->16->32->64
    total += conv_macs(4, f[0], z_dim, 4)
    total += conv_macs(8, f[1], f[0], 4)
    total += conv_macs(16, f[2], f[1], 4)
    # attn1 at 16^2 on f[2] channels: q,k (C -> C//8), v (C -> C)
    cq = max(f[2] // 8, 1)
    total += 2 * conv_macs(16, cq, f[2], 1) + conv_macs(16, f[2], f[2], 1)
    total += conv_macs(32, f[3], f[2], 4)
    cq = max(f[3] // 8, 1)
    total += 2 * conv_macs(32, cq, f[3], 1) + conv_macs(32, f[3], f[3], 1)
    total += conv_macs(64, 3, f[3], 4)
    return total


# ---------------------------------------------------------------------------
# SRResNet
# ---------------------------------------------------------------------------

def srresnet_macs(filter_cfgs: Optional[Sequence[int]], n_channels: int = 64,
                  n_blocks: int = 16, lr_size: int = 24,
                  scaling_factor: int = 4, large_kernel: int = 9,
                  small_kernel: int = 3) -> int:
    nc = n_channels
    f = list(filter_cfgs) if filter_cfgs is not None else [nc] * n_blocks
    lk, sk = large_kernel, small_kernel

    total = conv_macs(lr_size, nc, 3, lk)
    for b in range(n_blocks):
        if f[b] == 0:
            continue
        total += conv_macs(lr_size, f[b], nc, sk)
        total += conv_macs(lr_size, nc, f[b], sk)
    total += conv_macs(lr_size, nc, nc, sk)  # conv_mid
    hw = lr_size
    for _ in range(int(math.log2(scaling_factor))):
        total += conv_macs(hw, nc * 4, nc, sk)
        hw *= 2
    total += conv_macs(hw, 3, nc, lk)
    return total


# ---------------------------------------------------------------------------
# Parameter counting
# ---------------------------------------------------------------------------

def count_params(module: nn.Module, collection: str = "params") -> int:
    """Total parameter count of a module's JAX collection: "params" (every
    parameter but the MaskGate alphas) or "arch" (the alphas). Running
    statistics and spectral vectors are buffers, in neither."""
    arch = collection == "arch"
    return sum(p.numel() for n, p in module.named_parameters()
               if n.endswith("alpha") == arch)
