"""The precisions the reference's convolutions compute in.

``Exact`` is the reference: fp32 operands and fp32 sums (the caller turns
TF32 off). ``FP8`` is the control of a bf16 configuration, the nearest
precision below it: every convolution takes its input and weight rounded
to float8 e4m3 and, in the backward, its incoming gradient rounded to
float8 e5m2, each with one scale per tensor (amax over the format's
largest finite value), and sums in fp32 (the usual fp8 training recipe).
Norms, losses and the optimizer stay fp32 in both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


class Exact:
    name = "fp32"

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        return F.conv2d(x, w, b, stride, padding, 1, groups)

    def conv_t(self, x, w, b, stride, padding, output_padding):
        return F.conv_transpose2d(x, w, b, stride, padding, output_padding)


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """t rounded to ``dtype`` under one per-tensor scale, back in fp32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (t.float() / scale).to(dtype).float() * scale


class _Operand(torch.autograd.Function):
    """An operand rounded to e4m3; its gradient passes unchanged."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    """The identity, whose gradient (the backward products' input) is
    rounded to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class FP8(Exact):
    name = "fp8"

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        return _Output.apply(F.conv2d(_Operand.apply(x), _Operand.apply(w), b,
                                      stride, padding, 1, groups))

    def conv_t(self, x, w, b, stride, padding, output_padding):
        return _Output.apply(F.conv_transpose2d(
            _Operand.apply(x), _Operand.apply(w), b, stride, padding,
            output_padding))

