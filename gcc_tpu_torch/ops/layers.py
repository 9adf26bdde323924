"""Core NCHW building blocks with the JAX package's semantics
(port of gcc_tpu/ops/layers.py:26-273).

Activations are NCHW, where cuDNN takes the plain convolutions; weights are
torch's layouts: conv (O, I/groups, kh, kw), transpose conv (I, O, kh, kw).
``gcc_tpu_torch.utils.weights`` maps the JAX package's HWIO trees onto them.

Norm semantics match torch defaults, as in the JAX package: BatchNorm eps
1e-5 / momentum 0.1 (running <- 0.9*running + 0.1*batch, unbiased running
var) with affine + tracked stats; InstanceNorm affine-free, eps 1e-5, two-pass
variance.

Parameters are created uninitialised; ``init_params`` draws them from an
explicit ``torch.Generator`` with the JAX package's initialisers.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

CONV_STD = 0.02  # N(0, 0.02) conv/linear init (utils/util.py:266-268)


class Conv(nn.Module):
    """2D conv, NCHW x OIHW -> NCHW; symmetric per-side zero padding."""

    def __init__(self, in_ch: int, features: int, kernel_size=(3, 3),
                 stride=(1, 1), padding: int = 0, use_bias: bool = True,
                 groups: int = 1):
        super().__init__()
        kh, kw = kernel_size
        self.stride, self.padding, self.groups = tuple(stride), padding, groups
        self.weight = nn.Parameter(torch.empty(features, in_ch // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, CONV_STD, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        groups=self.groups)


class ConvTranspose(nn.Module):
    """torch ConvTranspose2d(k, s, p, output_padding) semantics:
    out = (i-1)*s - 2p + k + output_padding. Weight (in, out, kh, kw)."""

    def __init__(self, in_ch: int, features: int, kernel_size=(4, 4),
                 stride=(2, 2), padding: int = 1, output_padding: int = 0,
                 use_bias: bool = True):
        super().__init__()
        kh, kw = kernel_size
        self.stride, self.padding = tuple(stride), padding
        self.output_padding = output_padding
        self.weight = nn.Parameter(torch.empty(in_ch, features, kh, kw))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    reset_parameters = Conv.reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding)


class BatchNorm(nn.Module):
    """BatchNorm2d with torch semantics and explicit running-stat control.

    In train mode the batch statistics normalise; the running statistics
    are updated only when ``update_stats`` is True. This is the JAX
    package's ``apply_net(..., update_stats=False)``: a train-mode forward
    that leaves ``batch_stats`` alone (engines/pix2pix.py:171-173), which
    torch's own BatchNorm cannot express.
    """

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            # scale ~ N(1, 0.02), bias ~ N(0, 1) (utils/util.py:281-283)
            self.weight.normal_(1.0, 0.02, generator=generator)
            self.bias.normal_(0.0, 1.0, generator=generator)
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
            if update_stats:
                n = x.shape[0] * x.shape[2] * x.shape[3]
                unbias = n / max(n - 1, 1)  # torch stores unbiased running var
                with torch.no_grad():
                    self.running_mean.mul_(1 - self.momentum).add_(
                        mean.detach(), alpha=self.momentum)
                    self.running_var.mul_(1 - self.momentum).add_(
                        var.detach() * unbias, alpha=self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[None, :, None, None]) * inv[None, :, None, None]
                + self.bias[None, :, None, None])


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free InstanceNorm2d over (H, W), two-pass variance."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class InstanceNorm(nn.Module):
    """Parameter-free module form of ``instance_norm``."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.eps)


class SeparableConv(nn.Module):
    """Depthwise conv + InstanceNorm + 1x1 pointwise (models/Pix2Pix.py:132-145)."""

    def __init__(self, in_ch: int, features: int, kernel_size=(3, 3),
                 stride=(1, 1), padding: int = 0, use_bias: bool = True,
                 scale_factor: int = 1):
        super().__init__()
        self.depthwise = Conv(in_ch, in_ch * scale_factor, kernel_size, stride,
                              padding, use_bias, groups=in_ch)
        self.norm = InstanceNorm()
        self.pointwise = Conv(in_ch * scale_factor, features, (1, 1), (1, 1),
                              0, use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.norm(self.depthwise(x)))


class PReLU(nn.Module):
    """Single-parameter PReLU (torch nn.PReLU() default, init 0.25). The
    parameter is ``weight`` (0-d), as torch names it; the JAX tree's
    ``alpha`` (a name the port keeps for MaskGate's arch parameters)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(()))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight * x)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth-to-space in torch.nn.PixelShuffle's channel order (C, r, r),
    the order the JAX package's NHWC version unpacks."""
    return F.pixel_shuffle(x, r)


class SubPixelConv(nn.Module):
    """conv -> pixel-shuffle(r) -> PReLU (models/SRGAN.py:71-101)."""

    def __init__(self, n_channels: int, kernel_size=(3, 3),
                 scaling_factor: int = 2):
        super().__init__()
        self.r = scaling_factor
        self.conv = Conv(n_channels, n_channels * self.r ** 2, kernel_size,
                         (1, 1), kernel_size[0] // 2)
        self.prelu = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(pixel_shuffle(self.conv(x), self.r))


class Dense(nn.Module):
    """Linear layer; the weight is torch's (out, in), the JAX kernel's
    (in, out) transposed."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    reset_parameters = Conv.reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """ReflectionPad2d on NCHW."""
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``module`` from ``generator``, submodules in
    registration order (MaskGate alphas start at 1)."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return module
