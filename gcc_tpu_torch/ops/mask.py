"""DifferentiableOP: learnable hard channel gates with straight-through grads
(port of gcc_tpu/ops/mask.py; models/DifferentiableOp.py:22-59).

  forward:  mask = (sign(alpha - threshold) + 1) / 2        in {0, 1/2, 1}
  backward: d(mask)/d(alpha) = identity (gradient passes through unchanged)

sign(0) = 0 gives mask 1/2 exactly at alpha == threshold, as in torch.
"""

from __future__ import annotations

from typing import Dict, Iterable

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


def current_masks(alphas: Dict[str, torch.Tensor], threshold: float = 0.5
                  ) -> Dict[str, torch.Tensor]:
    """get_current_mask() per gate, for sparsity reporting
    (DifferentiableOp.py:58-59; gcc_tpu/ops/mask.py:67-71). ``threshold``
    must match the gates' --threshold for an accurate report."""
    return {k: (torch.sign(a.detach() - threshold) + 1.0) / 2.0
            for k, a in alphas.items()}


def sparsity_report(alphas: Dict[str, torch.Tensor], threshold: float = 0.5
                    ) -> Dict[str, float]:
    """name -> fraction of masked-off channels (models/Pix2Pix.py:595-600;
    gcc_tpu/ops/mask.py:74-82). ``alphas`` maps a gate's name, in the JAX
    package's ``net/module/.../alpha`` form, to its alphas."""
    return {k: float((m == 0.0).float().mean())
            for k, m in current_masks(alphas, threshold).items()}


def named_alphas(prefix: str, net: nn.Module) -> Dict[str, torch.Tensor]:
    """A net's MaskGate alphas keyed as the JAX package's arch tree paths:
    ``prefix/<module path with '/'>/alpha``."""
    return {f"{prefix}/{n.replace('.', '/')}": p
            for n, p in net.named_parameters() if n.endswith("alpha")}
