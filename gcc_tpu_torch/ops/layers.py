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

The dtype follows the data, as in the JAX package: parameters stay fp32 and
each layer computes in its input's dtype. A bf16 conv takes its weight
rounded to bf16, adds the fp32 bias to its bf16 output and rounds once
(gcc_tpu/ops/layers.py:70-80); the norms take fp32 statistics and return the
input's dtype. An fp32 input takes the fp32 code as it was, bit for bit.

Under a row-sharded view (parallel/spatial.py, eval only) the convs fetch
their halo rows, ``reflect_pad`` reflects at the image's own borders and
``instance_norm`` sums over the whole plane across the ranks; without one
every layer runs as above.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from gcc_tpu_torch.parallel import spatial
from gcc_tpu_torch.parallel.mesh import active, all_reduce_sum

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
        view = spatial.active()
        if view is not None:  # row-sharded: H's padding is in the slab
            return spatial.conv(
                view, x, lambda s: self._conv(s, (0, self.padding)),
                self.weight.shape[2], self.stride[0], self.padding)
        return self._conv(x, self.padding)

    def _conv(self, x: torch.Tensor, padding) -> torch.Tensor:
        if full_precision(x, self.weight):
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            padding, groups=self.groups)
        return add_bias(F.conv2d(x, self.weight.to(x.dtype), None,
                                 self.stride, padding,
                                 groups=self.groups), self.bias)


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
        view = spatial.active()
        if view is not None:  # row-sharded: no padding along H in the slab
            return spatial.conv_transpose(
                view, x, lambda s, extra: self._conv(
                    s, (0, self.padding), (extra, self.output_padding)),
                self.weight.shape[2], self.stride[0], self.padding,
                self.output_padding)
        return self._conv(x, self.padding, self.output_padding)

    def _conv(self, x: torch.Tensor, padding, output_padding
              ) -> torch.Tensor:
        if full_precision(x, self.weight):
            return F.conv_transpose2d(x, self.weight, self.bias, self.stride,
                                      padding, output_padding)
        return add_bias(F.conv_transpose2d(
            x, self.weight.to(x.dtype), None, self.stride, padding,
            output_padding), self.bias)


class BatchNorm(nn.Module):
    """BatchNorm2d with torch semantics and explicit running-stat control.

    In train mode the batch statistics normalise; the running statistics
    are updated only when ``update_stats`` is True. Under a data-parallel
    mesh the statistics and the running variance's count are the global
    batch's (``global_moments``). This is the JAX
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
        xf = x.float()
        if self.training and spatial.active() is not None:
            raise RuntimeError("a row-sharded forward is eval only: "
                               "BatchNorm in train mode under the view")
        if self.training:
            n = x.shape[0] * x.shape[2] * x.shape[3]
            if active() is not None:
                mean, var, n = global_moments(xf, x.dtype == torch.float32)
            else:
                mean = xf.mean(dim=(0, 2, 3))
                if x.dtype == torch.float32:
                    var = (xf - mean[None, :, None, None]).square().mean(
                        dim=(0, 2, 3))
                else:  # the JAX package's one-pass form, E[x^2] - E[x]^2
                    var = xf.square().mean(dim=(0, 2, 3)) - mean.square()
            if update_stats:
                unbias = n / max(n - 1, 1)  # torch stores unbiased running var
                with torch.no_grad():
                    self.running_mean.mul_(1 - self.momentum).add_(
                        mean.detach(), alpha=self.momentum)
                    self.running_var.mul_(1 - self.momentum).add_(
                        var.detach() * unbias, alpha=self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        # fp32 also where the net was cast below it (a bf16 serving artifact,
        # utils/serve_export.py), as XLA folds the JAX layer's constants; a
        # no-op on the engines' fp32 tensors
        mean, var = mean.float(), var.float()
        inv = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean[None, :, None, None]) * inv[None, :, None, None]
                + self.bias.float()[None, :, None, None]).to(x.dtype)


def global_moments(xf: torch.Tensor, two_pass: bool):
    """Per-channel (mean, biased variance, count) of an fp32 NCHW batch over
    the active mesh's global batch. ``two_pass`` (fp32 inputs) keeps the
    1-process form, the sum first and then the squared deviations from the
    global mean: two all-reduces. Otherwise (bf16 inputs) the one-pass
    E[x^2] - E[x]^2 of one all-reduce of the stacked [sum x, sum x^2]."""
    n = xf.shape[0] * xf.shape[2] * xf.shape[3] * active().world
    if two_pass:
        mean = all_reduce_sum(xf.sum(dim=(0, 2, 3))) / n
        var = all_reduce_sum((xf - mean[None, :, None, None]).square().sum(
            dim=(0, 2, 3))) / n
        return mean, var, n
    sums = all_reduce_sum(torch.stack([xf.sum(dim=(0, 2, 3)),
                                       xf.square().sum(dim=(0, 2, 3))])) / n
    return sums[0], sums[1] - sums[0].square(), n


def full_precision(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """Whether a conv of x and weight takes its bias inside the library
    call: both in fp32 (or wider). Below fp32 the output is rounded before
    its bias is added (``add_bias``), as in the JAX layers, also where the
    weights themselves were cast (a bf16 serving artifact,
    utils/serve_export.py)."""
    return x.dtype == weight.dtype and x.element_size() >= 4


def add_bias(y: torch.Tensor, bias) -> torch.Tensor:
    """A low-precision conv output plus its bias, rounded once to the
    output's dtype (torch would otherwise promote the sum with an fp32 bias
    to fp32; a bias cast to the output's dtype is added in it)."""
    return y if bias is None else (y + bias[None, :, None, None]).to(y.dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free InstanceNorm2d over (H, W), two-pass variance in fp32,
    returned in x's dtype; row-sharded, over the global plane."""
    xf = x.float()
    view = spatial.active()
    if view is not None:
        mean, var = spatial.instance_moments(view, xf)
    else:
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


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
        # the slope in x's dtype, as the JAX PReLU's a.astype(x.dtype) * x
        # (gcc_tpu/ops/layers.py:240)
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


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
    (in, out) transposed. Below fp32, as the JAX Dense (gcc_tpu/ops/
    layers.py:249-257): the product of x and the weight rounded to x's dtype,
    summed in fp32 and rounded to x's dtype; then the fp32 bias is added, so
    the result is fp32."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None

    reset_parameters = Conv.reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return F.linear(x, self.weight, self.bias)
        # bf16 x bf16 products are exact in fp32: an fp32 product of the
        # rounded operands is the bf16 product with fp32 sums
        y = F.linear(x.float(), self.weight.to(x.dtype).float()).to(x.dtype)
        return y if self.bias is None else y + self.bias


class _Tanh(torch.autograd.Function):
    """tanh whose backward is the JAX package's derivative op for op in the
    gradient's dtype, (g + g y) (1 - y) with y = tanh(x), each product and
    sum rounded (jax's tanh rule); torch's tanh backward rounds
    g (1 - y^2) once."""

    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return (g + g * y) * (1 - y)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """torch.tanh in fp32; below fp32 with the JAX package's derivative."""
    return torch.tanh(x) if x.dtype == torch.float32 else _Tanh.apply(x)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    return torch.tensor(value, dtype=dtype).item()


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """Below fp32 the slope is rounded to x's dtype, as JAX multiplies by a
    Python scalar in x's dtype (weak typing): 0.2 is 0.2001953125 in bf16,
    where torch would multiply by fp32's 0.2 and round the product."""
    if x.dtype != torch.float32:
        slope = _rounded(slope, x.dtype)
    return torch.where(x >= 0, x, slope * x)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """ReflectionPad2d on NCHW; row-sharded, the rank's rows with their
    halo (parallel/spatial.py)."""
    view = spatial.active()
    if view is not None:
        return spatial.reflect_pad(view, x, pad)
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``module`` from ``generator``, submodules in
    registration order (MaskGate alphas start at 1)."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return module
