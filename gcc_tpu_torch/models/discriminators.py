"""Discriminator networks (port of gcc_tpu/models/discriminators.py:27-75).
This slice has the PatchGAN, plain and mask-gated (DARTS-searchable)."""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from gcc_tpu_torch.ops.layers import BatchNorm, Conv, InstanceNorm, leaky_relu
from gcc_tpu_torch.ops.mask import MaskGate


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
