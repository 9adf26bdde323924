"""DifferentiableOP: learnable hard channel gates with straight-through grads
(port of gcc_tpu/ops/mask.py:24-64; models/DifferentiableOp.py:22-59).

  forward:  mask = (sign(alpha - threshold) + 1) / 2        in {0, 1/2, 1}
  backward: d(mask)/d(alpha) = identity (gradient passes through unchanged)

sign(0) = 0 gives mask 1/2 exactly at alpha == threshold, as in torch.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn as nn


class _MaskFromAlpha(torch.autograd.Function):

    @staticmethod
    def forward(ctx, alpha: torch.Tensor, threshold: float) -> torch.Tensor:
        return (torch.sign(alpha - threshold) + 1.0) / 2.0

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # straight-through: grad w.r.t. alpha is g unchanged; none for the
        # threshold (models/DifferentiableOp.py:29-32)
        return g, None


def mask_from_alpha(alpha: torch.Tensor, threshold: float) -> torch.Tensor:
    return _MaskFromAlpha.apply(alpha, threshold)


class MaskGate(nn.Module):
    """Per-channel gate over dim 1 of an NCHW tensor.

    ``alpha`` is the net's only parameter named ``alpha``: the engines keep
    it out of the D-weight optimizer and step it in the arch step alone.
    Alphas init to 1.0 and are clipped to [0, 1] by the arch step
    (DifferentiableOp.py:39,51-53).
    """

    def __init__(self, features: int, threshold: float = 0.5):
        super().__init__()
        self.threshold = threshold
        self.alpha = nn.Parameter(torch.ones(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.alpha.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mask = mask_from_alpha(self.alpha, self.threshold)
        return x * mask[None, :, None, None]


def clip_alphas(alphas: Iterable[torch.Tensor]) -> None:
    """clip_alpha(): project alphas back to [0, 1] in place
    (DifferentiableOp.py:51-53)."""
    with torch.no_grad():
        for a in alphas:
            a.clamp_(0.0, 1.0)
