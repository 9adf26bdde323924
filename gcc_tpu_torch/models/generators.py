"""Generator networks (port of gcc_tpu/models/generators.py). This slice has
the MobileResnet generator (models/CycleGAN.py:77-138 = models/Pix2Pix.py:199-265);
the U-Net follows in the next slice.

Submodule names mirror the JAX package's parameter tree (``conv_in``,
``block_3_sep1.depthwise``, ...), which is how ``utils/weights.py`` carries
weights across. Every forward returns ``(output, features)``: the captured
distillation features in the order the JAX package's sorted sown keys give.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from gcc_tpu_torch.ops.layers import (
    Conv, ConvTranspose, SeparableConv, instance_norm, reflect_pad,
)
from gcc_tpu_torch.ops.mobile_block import fused_mobile_block


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
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``generator`` draws the dropout masks (dropout_rate > 0, train mode)."""
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
