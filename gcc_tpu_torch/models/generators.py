"""Generator networks (port of gcc_tpu/models/generators.py): the U-Net
(models/Pix2Pix.py:79-130), the MobileResnet generator
(models/CycleGAN.py:77-138 = models/Pix2Pix.py:199-265), the SAGAN
generator (models/SAGAN.py:109-171) and SRGAN's SRResNet
(models/SRGAN.py:139-197).

Submodule names mirror the JAX package's parameter tree (``conv_in``,
``block_3_sep1.depthwise``, ...), which is how ``utils/weights.py`` carries
weights across. Every forward returns ``(output, features)``: the captured
distillation features in the order the JAX package's sorted sown keys give.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from gcc_tpu_torch.ops.attention import SelfAttention
from gcc_tpu_torch.ops.layers import (
    BatchNorm, Conv, ConvTranspose, PReLU, SeparableConv, SubPixelConv,
    instance_norm, leaky_relu, reflect_pad,
)
from gcc_tpu_torch.ops.mobile_block import fused_mobile_block
from gcc_tpu_torch.ops.spectral import SpectralConvTranspose


def unet_default_filter_cfgs(ngf: int, num_downs: int) -> list:
    """Unpruned filter_cfgs: downs [0..N-1] then ups [N..2N-2] (innermost->depth1)."""
    n = num_downs
    downs = [ngf * min(2 ** k, 8) for k in range(n)]
    ups = [ngf * min(2 ** (k - 1), 8) for k in range(n - 1, 0, -1)]
    return downs + ups


def unet_default_channel_cfgs(ngf: int, num_downs: int) -> list:
    """Unpruned channel_cfgs (input widths; see Pix2Pix.py:88-127)."""
    n = num_downs
    downs = [ngf * min(2 ** (k + 1), 8) for k in range(n - 1)]
    inner_up_in = [ngf * 8]
    cat = [2 * ngf * min(2 ** (k - 1), 8) for k in range(n - 1, 0, -1)]
    return downs + inner_up_in + cat


def unet_existing_depths(f: Sequence[int], num_downs: int) -> List[int]:
    """The depths whose blocks exist (Pix2Pix.py:87-103): the innermost iff
    f[N-1] and f[N] are non-zero, a middle depth d in [4..N-2] iff f[d] and
    f[2N-1-d] are, depths 0..3 always."""
    n = num_downs

    def exists(d):
        if d == n - 1:
            return f[n - 1] != 0 and f[n] != 0
        if 4 <= d <= n - 2:
            return f[d] != 0 and f[2 * n - 1 - d] != 0
        return True

    return [d for d in range(n) if exists(d)]


def unet_layout(f: Sequence[int], num_downs: int, input_nc: int = 3,
                output_nc: int = 3):
    """What a U-Net of filter_cfgs ``f`` is built from: (depths, downs, ups,
    feature widths). downs[d] and ups[d] are the (in, out) widths of the
    conv and the transpose conv at depth d; the feature widths are those of
    g_feat_0..3: f[1], f[3], the concat that feeds up depth 3 and the one
    that feeds up depth 1 (the shallower skip's width plus the deeper up's
    output, or the skip's alone where nothing deeper exists)."""
    n = num_downs
    depths = unet_existing_depths(f, n)
    downs, ups, width = {}, {}, input_nc
    for d in depths:
        downs[d] = (width, f[d])
        width = f[d]
    feats = {0: f[1], 1: f[3]}
    for d in reversed(depths):  # width: h's channels where up depth d reads it
        if d == 3:
            feats[2] = width
        if d == 1:
            feats[3] = width
        out = output_nc if d == 0 else f[2 * n - 1 - d]
        ups[d] = (width, out)
        if d > 0:
            width = f[max(dd for dd in depths if dd < d)] + out
    return depths, downs, ups, [feats[i] for i in range(4)]


class UnetGenerator(nn.Module):
    """8-down U-Net with cfg-driven widths and zero-width block elision.

    filter_cfgs layout (N = num_downs, len 2N-1):
      [0..N-1]   out-channels of downconvs, outermost -> innermost
      [N]        out-channels of the innermost upconv
      [N+1..2N-2] out-channels of upconvs, depth N-2 -> depth 1
    The outermost upconv's out-channels are output_nc. Downconvs are
    bias-free; the innermost and outermost carry no norm. Every upconv but
    the outermost (which keeps its bias, then tanh) is bias-free and
    BatchNormed, with dropout 0.5 at depths 4..N-2 in train mode. Where a
    block is elided (``unet_existing_depths``), the skip chain passes the
    shallower feature straight through. ``channel_cfgs`` is carried, not
    used to build.

    Captured features (Pix2Pix.py:366-369), in this order:
      g_feat_0 <- BN output of down depth 1
      g_feat_1 <- BN output of down depth 3
      g_feat_2 <- relu(concat) feeding up depth 3
      g_feat_3 <- relu(concat) feeding up depth 1
    """

    def __init__(self, input_nc: int = 3, output_nc: int = 3,
                 num_downs: int = 8, ngf: int = 64, use_dropout: bool = True,
                 filter_cfgs: Optional[Sequence[int]] = None,
                 channel_cfgs: Optional[Sequence[int]] = None):
        super().__init__()
        n = num_downs
        f = list(filter_cfgs) if filter_cfgs is not None \
            else unet_default_filter_cfgs(ngf, n)
        self.num_downs, self.use_dropout = n, use_dropout
        self.filter_cfgs, self.channel_cfgs = f, channel_cfgs
        self.depths, downs, ups, self.feature_widths = unet_layout(
            f, n, input_nc, output_nc)
        for d in self.depths:
            self.add_module(f"down_{d}", Conv(*downs[d], (4, 4), (2, 2), 1,
                                              use_bias=False))
            if d not in (0, n - 1):
                self.add_module(f"down_norm_{d}", BatchNorm(downs[d][1]))
        for d in reversed(self.depths):
            self.add_module(f"up_{d}", ConvTranspose(*ups[d], use_bias=d == 0))
            if d > 0:
                self.add_module(f"up_norm_{d}", BatchNorm(ups[d][1]))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                update_stats: bool = True
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``generator`` draws the dropout masks (train mode); a train-mode
        forward moves the BatchNorm running stats when ``update_stats``."""
        n, depths = self.num_downs, self.depths
        feats, skips, h = [None] * 4, {}, x
        for d in depths:
            if d > 0:
                h = leaky_relu(h, 0.2)
            h = getattr(self, f"down_{d}")(h)
            if d not in (0, n - 1):
                h = getattr(self, f"down_norm_{d}")(h, update_stats)
                if d in (1, 3):
                    feats[d // 2] = h  # g_feat_0 at depth 1, g_feat_1 at 3
            skips[d] = h
        for d in reversed(depths):
            h = torch.relu(h)  # uprelu on the innermost down output or concat
            if d in (1, 3):
                feats[3 - d // 2] = h  # g_feat_2 at depth 3, g_feat_3 at 1
            if d == 0:
                return torch.tanh(self.up_0(h)), feats
            h2 = getattr(self, f"up_norm_{d}")(getattr(self, f"up_{d}")(h),
                                               update_stats)
            if self.use_dropout and self.training and 4 <= d <= n - 2:
                h2 = dropout(h2, 0.5, generator)
            h = torch.cat([skips[max(dd for dd in depths if dd < d)], h2], 1)
        raise AssertionError("unreachable")


def mobile_resnet_default_cfg(ngf: int, n_blocks: int = 9) -> list:
    """[conv7, down1, down2, (block layer1, layer2) x n, up1, up2]."""
    return ([ngf, ngf * 2, ngf * 4] + [ngf * 4] * (2 * n_blocks)
            + [ngf * 2, ngf])


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with its mask drawn from ``generator``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class MobileResnetGenerator(nn.Module):
    """ReflectPad conv7 -> 2x down -> n separable-conv residual blocks -> 2x up
    -> conv7 tanh, InstanceNorm throughout.

    cfg layout (len 3 + 2*n_blocks + 2): [c7, d1, d2, (b_i l1, b_i l2)*n, u1, u2].
    A block is elided when its layer1 width is 0 (CycleGAN.py:112-113).
    Residual adds require every block's l2 == d2 width.

    Captured features ('model.9', 'model.12', 'model.15', 'model.18',
    CycleGAN.py:239): g_feat_0 = relu after down2, g_feat_1..3 = outputs of
    blocks 2, 5, 8.

    use_fused_blocks: None (auto: off, the JAX package's default, until a
    measurement on the card decides it) | bool. The fused path runs each
    residual block as the CUDA stage kernels (ops/mobile_block.py) with the
    SAME parameters; it is taken only without dropout and for inputs of at
    least 20 px a side, as in the JAX package.
    """

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_blocks: int = 9, dropout_rate: float = 0.0,
                 cfg: Optional[Sequence[int]] = None,
                 use_fused_blocks: Optional[bool] = None):
        super().__init__()
        cfg = list(cfg) if cfg is not None \
            else mobile_resnet_default_cfg(ngf, n_blocks)
        self.cfg, self.n_blocks = cfg, n_blocks
        self.dropout_rate = dropout_rate
        self.use_fused_blocks = use_fused_blocks
        self.conv_in = Conv(input_nc, cfg[0], (7, 7))
        self.down_0 = Conv(cfg[0], cfg[1], (3, 3), (2, 2), 1)
        self.down_1 = Conv(cfg[1], cfg[2], (3, 3), (2, 2), 1)
        width = cfg[2]
        for b in range(n_blocks):
            l1, l2 = cfg[3 + 2 * b], cfg[4 + 2 * b]
            if l1 != 0:
                self.add_module(f"block_{b}_sep1", SeparableConv(width, l1))
                self.add_module(f"block_{b}_sep2", SeparableConv(l1, l2))
        u0, u1 = cfg[3 + 2 * n_blocks], cfg[4 + 2 * n_blocks]
        self.up_0 = ConvTranspose(width, u0, (3, 3), (2, 2), 1, 1)
        self.up_1 = ConvTranspose(u0, u1, (3, 3), (2, 2), 1, 1)
        self.conv_out = Conv(u1, output_nc, (7, 7))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                update_stats: bool = True
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``generator`` draws the dropout masks (dropout_rate > 0, train
        mode). ``update_stats`` is the U-Net's: InstanceNorm keeps none."""
        # TPU VMEM gate dropped (gcc_tpu/models/generators.py:232-238): it
        # guards Mosaic's 16 MB scoped VMEM, which the card does not have; the
        # CUDA kernels tile every width. At full width the JAX teacher
        # (ngf 64: 64*64 px * 256 ch * 4 B * 6 = 25.2 MB > 15.5 MB) falls
        # back to XLA there while the card runs it fused: the same function
        # either way (fused == unfused, tests/test_mobile_block.py:78-100).
        fused = bool(self.use_fused_blocks) and self.dropout_rate == 0 \
            and min(x.shape[2:4]) >= 20
        h = torch.relu(instance_norm(self.conv_in(reflect_pad(x, 3))))
        h = torch.relu(instance_norm(self.down_0(h)))
        h = torch.relu(instance_norm(self.down_1(h)))
        feats = [h]
        for b in range(self.n_blocks):
            if self.cfg[3 + 2 * b] != 0:
                sep1 = getattr(self, f"block_{b}_sep1")
                sep2 = getattr(self, f"block_{b}_sep2")
                if fused:
                    h = fused_mobile_block(h, sep1, sep2)
                else:
                    r = torch.relu(instance_norm(sep1(reflect_pad(h, 1))))
                    if self.dropout_rate > 0 and self.training:
                        r = dropout(r, self.dropout_rate, generator)
                    h = h + instance_norm(sep2(reflect_pad(r, 1)))
            if b in (2, 5, 8):
                feats.append(h)
        h = torch.relu(instance_norm(self.up_0(h)))
        h = torch.relu(instance_norm(self.up_1(h)))
        return torch.tanh(self.conv_out(reflect_pad(h, 3))), feats


def sagan_default_filter_cfgs(ngf: int, image_size: int = 64) -> list:
    repeat = int(math.log2(image_size)) - 3
    mult = 2 ** repeat
    return [ngf * mult, ngf * mult // 2, ngf * mult // 4, ngf * mult // 8]


class SAGANGenerator(nn.Module):
    """z -> 4 spectral-norm deconv stages with BatchNorm + two self-attention
    blocks -> deconv to 3 channels, tanh. Image size 64 (4 stages + output).

    Captured features ('l2', 'attn2', SAGAN.py:294): g_feat_0 = relu output of
    stage 2, g_feat_1 = output of attn2. ``attn_threshold``: the H*W from
    which attention runs through the flash kernels (attn2 at 32x32 on the
    default 1024; attn1 at 16x16 stays below it).
    """

    def __init__(self, ngf: int = 64, image_size: int = 64, z_dim: int = 128,
                 filter_cfgs: Optional[Sequence[int]] = None,
                 attn_threshold: int = 1024):
        super().__init__()
        f = list(filter_cfgs) if filter_cfgs is not None \
            else sagan_default_filter_cfgs(ngf, image_size)
        self.l1 = SpectralConvTranspose(z_dim, f[0], (4, 4), (1, 1), 0)
        self.bn1 = BatchNorm(f[0])
        self.l2 = SpectralConvTranspose(f[0], f[1])
        self.bn2 = BatchNorm(f[1])
        self.l3 = SpectralConvTranspose(f[1], f[2])
        self.bn3 = BatchNorm(f[2])
        self.attn1 = SelfAttention(f[2], attn_threshold)
        self.l4 = SpectralConvTranspose(f[2], f[3])
        self.bn4 = BatchNorm(f[3])
        self.attn2 = SelfAttention(f[3], attn_threshold)
        self.last = ConvTranspose(f[3], 3, (4, 4), (2, 2), 1)

    def forward(self, z: torch.Tensor, update_stats: bool = True
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``update_stats``: whether a train-mode forward moves the BatchNorm
        running statistics and the spectral vectors (the JAX package's
        ``apply_net`` flag)."""
        h = z.reshape(z.shape[0], z.shape[1], 1, 1)
        h = torch.relu(self.bn1(self.l1(h, update_stats), update_stats))
        h = torch.relu(self.bn2(self.l2(h, update_stats), update_stats))
        feats = [h]
        h = torch.relu(self.bn3(self.l3(h, update_stats), update_stats))
        h = self.attn1(h)
        h = torch.relu(self.bn4(self.l4(h, update_stats), update_stats))
        h = self.attn2(h)
        feats.append(h)
        return torch.tanh(self.last(h)), feats


class SRResNet(nn.Module):
    """conv9 PReLU -> n residual blocks (prunable inner width) -> conv3 BN +
    global skip -> log2(scale) subpixel x2 stages -> conv9 tanh.

    filter_cfgs: each block's inner width, len n_blocks; a block of width 0
    is elided (SRGAN.py:164-166). Captured features (SRGAN.py:318-321):
    g_feat_0..3 = outputs of residual blocks 3, 7, 11, 15.
    """

    FEAT_BLOCKS = (3, 7, 11, 15)

    def __init__(self, n_channels: int = 64, n_blocks: int = 16,
                 scaling_factor: int = 4, large_kernel: int = 9,
                 small_kernel: int = 3,
                 filter_cfgs: Optional[Sequence[int]] = None,
                 input_nc: int = 3):
        super().__init__()
        nc, lk, sk = n_channels, (large_kernel,) * 2, (small_kernel,) * 2
        f = list(filter_cfgs) if filter_cfgs is not None else [nc] * n_blocks
        self.filter_cfgs, self.n_blocks = f, n_blocks
        self.conv_in = Conv(input_nc, nc, lk, (1, 1), large_kernel // 2)
        self.prelu_in = PReLU()
        for b, inner in enumerate(f):
            if inner == 0:
                continue
            self.add_module(f"block_{b}_conv1",
                            Conv(nc, inner, sk, (1, 1), small_kernel // 2))
            self.add_module(f"block_{b}_bn1", BatchNorm(inner))
            self.add_module(f"block_{b}_prelu", PReLU())
            self.add_module(f"block_{b}_conv2",
                            Conv(inner, nc, sk, (1, 1), small_kernel // 2))
            self.add_module(f"block_{b}_bn2", BatchNorm(nc))
        self.conv_mid = Conv(nc, nc, sk, (1, 1), small_kernel // 2)
        self.bn_mid = BatchNorm(nc)
        self.n_up = int(math.log2(scaling_factor))
        for i in range(self.n_up):
            self.add_module(f"subpixel_{i}", SubPixelConv(nc, sk, 2))
        self.conv_out = Conv(nc, 3, lk, (1, 1), large_kernel // 2)

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``update_stats``: whether a train-mode forward moves the BatchNorm
        running statistics (the JAX package's ``apply_net`` flag)."""
        h = self.prelu_in(self.conv_in(x))
        residual, feats = h, []
        for b in range(self.n_blocks):
            if self.filter_cfgs[b] != 0:
                r = getattr(self, f"block_{b}_conv1")(h)
                r = getattr(self, f"block_{b}_bn1")(r, update_stats)
                r = getattr(self, f"block_{b}_prelu")(r)
                r = getattr(self, f"block_{b}_conv2")(r)
                h = h + getattr(self, f"block_{b}_bn2")(r, update_stats)
            if b in self.FEAT_BLOCKS:
                feats.append(h)
        h = self.bn_mid(self.conv_mid(h), update_stats) + residual
        for i in range(self.n_up):
            h = getattr(self, f"subpixel_{i}")(h)
        return torch.tanh(self.conv_out(h)), feats
