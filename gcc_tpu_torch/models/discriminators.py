"""Discriminator networks (port of gcc_tpu/models/discriminators.py:27-148):
the PatchGAN, the SAGAN discriminator and SRGAN's VGG-style discriminator,
each plain and mask-gated (DARTS-searchable)."""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from gcc_tpu_torch.ops.attention import SelfAttention
from gcc_tpu_torch.ops.layers import (
    BatchNorm, Conv, Dense, InstanceNorm, leaky_relu,
)
from gcc_tpu_torch.ops.mask import MaskGate
from gcc_tpu_torch.ops.spectral import SpectralConv


class PatchGAN(nn.Module):
    """NLayerDiscriminator: 4x4 convs, stride 2,2,2,1,1 (n_layers=3).

    masked=True inserts a MaskGate after each normed stage plus the first
    conv (MaskNLayerDiscriminator, Pix2Pix.py:307-348) and always uses
    BatchNorm (CycleGAN.py:185); the plain variant uses ``norm``.

    Captured features (Pix2Pix.py:370-373): d_feat_0 / d_feat_1 = post-norm
    outputs of conv stages 1 and n_layers (widths ndf*2 and ndf*8).
    """

    def __init__(self, input_nc: int = 6, ndf: int = 64, n_layers: int = 3,
                 norm: str = "batch", masked: bool = False,
                 threshold: float = 0.5):
        super().__init__()
        self.n_layers, self.masked = n_layers, masked
        norm_kind = "batch" if masked else norm
        use_bias = norm_kind == "instance"
        self.conv_0 = Conv(input_nc, ndf, (4, 4), (2, 2), 1)
        if masked:
            self.mask_0 = MaskGate(ndf, threshold)
        nf = 1
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(2 ** n, 8)
            stride = (2, 2) if n < n_layers else (1, 1)
            self.add_module(f"conv_{n}", Conv(ndf * nf_prev, ndf * nf, (4, 4),
                                              stride, 1, use_bias))
            self.add_module(f"norm_{n}", BatchNorm(ndf * nf)
                            if norm_kind == "batch" else InstanceNorm())
            if masked:
                self.add_module(f"mask_{n}", MaskGate(ndf * nf, threshold))
        self.conv_out = Conv(ndf * nf, 1, (4, 4), (1, 1), 1)

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``update_stats``: whether a train-mode forward moves the BatchNorm
        running statistics (the JAX package's ``apply_net`` flag)."""
        h = leaky_relu(self.conv_0(x), 0.2)
        if self.masked:
            h = self.mask_0(h)
        feats = []
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv_{n}")(h)
            norm = getattr(self, f"norm_{n}")
            h = norm(h, update_stats) if isinstance(norm, BatchNorm) else norm(h)
            if n in (1, self.n_layers):
                feats.append(h)
            if self.masked:
                h = getattr(self, f"mask_{n}")(h)
            h = leaky_relu(h, 0.2)
        return self.conv_out(h), feats


class SAGANDiscriminator(nn.Module):
    """RGB input -> 4 spectral-norm conv stages (stride 2) + two
    self-attention blocks + a 4x4 valid conv head, output (B,)
    (models/SAGAN.py:173-277). LeakyReLU slope 0.1; masked=True gates each
    stage's output before the activation with ``mask_{i+1}``
    (SAGAN.py:235-255). attn1 follows stage 3, attn2 stage 4.

    Captured features ('l2', 'attn2', SAGAN.py:296-298): d_feat_0 = stage-2
    activation, d_feat_1 = output of attn2.
    """

    def __init__(self, ndf: int = 64, masked: bool = False,
                 threshold: float = 0.5, attn_threshold: int = 1024):
        super().__init__()
        self.masked = masked
        dims = [ndf, ndf * 2, ndf * 4, ndf * 8]
        for i, (ci, co) in enumerate(zip([3] + dims[:-1], dims)):
            self.add_module(f"l{i + 1}", SpectralConv(ci, co, (4, 4), (2, 2),
                                                      1))
            if masked:
                self.add_module(f"mask_{i + 1}", MaskGate(co, threshold))
            if i == 2:
                self.attn1 = SelfAttention(co, attn_threshold)
        self.attn2 = SelfAttention(dims[-1], attn_threshold)
        self.last = Conv(dims[-1], 1, (4, 4))

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``update_stats``: whether a train-mode forward moves the spectral
        vectors (the JAX package's ``apply_net`` flag)."""
        h, feats = x, []
        for i in range(4):
            h = getattr(self, f"l{i + 1}")(h, update_stats)
            if self.masked:
                h = getattr(self, f"mask_{i + 1}")(h)
            h = leaky_relu(h, 0.1)
            if i == 1:
                feats.append(h)
            if i == 2:
                h = self.attn1(h)
        h = self.attn2(h)
        feats.append(h)
        return self.last(h).reshape(h.shape[0]), feats


class SRGANDiscriminator(nn.Module):
    """VGG-style: n_blocks conv blocks (even blocks double the channels at
    stride 1, odd ones halve the resolution at stride 2; the first has no
    BatchNorm), global average pool, linear head (models/SRGAN.py:199-295).
    LeakyReLU slope 0.2; masked=True gates each block's output before the
    activation with ``mask_{i}``. Output (B, 1).

    Captured features ('conv_blocks.1', 'conv_blocks.3', SRGAN.py:322-325):
    d_feat_0 / d_feat_1 = the activations of blocks 1 and 3.
    """

    def __init__(self, ndf: int = 64, n_blocks: int = 4,
                 kernel_size: int = 3, masked: bool = False,
                 threshold: float = 0.5, input_nc: int = 3):
        super().__init__()
        self.n_blocks, self.masked = n_blocks, masked
        k, in_ch = kernel_size, input_nc
        for i in range(n_blocks):
            out_ch = (ndf if i == 0 else in_ch * 2) if i % 2 == 0 else in_ch
            stride = (1, 1) if i % 2 == 0 else (2, 2)
            self.add_module(f"conv_{i}", Conv(in_ch, out_ch, (k, k), stride,
                                              k // 2))
            if i != 0:
                self.add_module(f"norm_{i}", BatchNorm(out_ch))
            if masked:
                self.add_module(f"mask_{i}", MaskGate(out_ch, threshold))
            in_ch = out_ch
        self.fc = Dense(in_ch, 1)

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``update_stats``: whether a train-mode forward moves the BatchNorm
        running statistics (the JAX package's ``apply_net`` flag)."""
        h, feats = x, []
        for i in range(self.n_blocks):
            h = getattr(self, f"conv_{i}")(h)
            if i != 0:
                h = getattr(self, f"norm_{i}")(h, update_stats)
            if self.masked:
                h = getattr(self, f"mask_{i}")(h)
            h = leaky_relu(h, 0.2)
            if i in (1, 3):
                feats.append(h)
        return self.fc(h.mean(dim=(2, 3))), feats
