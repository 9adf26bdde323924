"""Spectral normalisation with power-iteration state (port of
gcc_tpu/ops/spectral.py; models/SAGAN.py:17-71).

Each forward does one power iteration on the detached weight matrix,
v <- l2n(W^T u), u <- l2n(W v) (eps 1e-12 added to the norm), then divides
the weight by sigma = u . (W v), with the gradient flowing through W only.
The new u and v are stored in the ``u``/``v`` buffers only in a train-mode
forward with ``update_stats=True`` (the JAX package's mutable ``spectral``
collection, engines/common.py:48-50); otherwise the freshly iterated
vectors still give sigma but are dropped.

The matricization is the JAX package's: height O for the conv and I for the
transposed conv (spectral.py:97-117), width flattened in (kh, kw, other
channel) order, so ``v`` has the JAX layout and carries across as it is.

The dtype follows x. The power iteration and sigma stay fp32; below fp32 the
normalised weight w / sigma is rounded to x's dtype, and the bias is rounded
to it and added in it (spectral.py:67, :86-93, :117-125): not ``Conv``'s fp32
add rounded once (layers.add_bias).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gcc_tpu_torch.ops.layers import Conv, ConvTranspose, full_precision

EPS = 1e-12


def _l2n(t: torch.Tensor) -> torch.Tensor:
    return t / (torch.linalg.vector_norm(t) + EPS)


class SpectralNormed:
    """Power-iteration state and weight normalisation shared by the spectral
    conv and transposed conv. The host module's weight has the height axis
    first: conv (O, I, kh, kw), transposed conv (I, O, kh, kw)."""

    def _init_vectors(self) -> None:
        h, o, kh, kw = self.weight.shape
        self.register_buffer("u", torch.empty(h))
        self.register_buffer("v", torch.empty(o * kh * kw))

    def _reset_vectors(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.u.copy_(_l2n(torch.randn(self.u.shape, generator=generator)))
            self.v.copy_(_l2n(torch.randn(self.v.shape, generator=generator)))

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        """w / sigma, the power iteration and sigma in fp32 and sigma
        rounded to the weight's dtype (spectral.py:41-67): a no-op on the
        engines' fp32 weights, the JAX layer's rounding on a net cast to
        bf16 (a serving artifact, utils/serve_export.py)."""
        w = self.weight
        wm = w.float().permute(0, 2, 3, 1).reshape(w.shape[0], -1)
        with torch.no_grad():  # the JAX matricization's order
            v = _l2n(wm.t() @ self.u.float())
            u = _l2n(wm @ v)
            if self.training and update_stats:
                self.u.copy_(u)
                self.v.copy_(v)
        return w / (u @ (wm @ v)).to(w.dtype)

    def _low_precision(self, y: torch.Tensor) -> torch.Tensor:
        """A conv output below fp32 plus the bias rounded to its dtype."""
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype)[None, :, None, None]


class SpectralConv(SpectralNormed, Conv):
    """Conv2d wrapped in spectral norm (SAGAN D stages)."""

    def __init__(self, in_ch: int, features: int, kernel_size=(4, 4),
                 stride=(2, 2), padding: int = 1, use_bias: bool = True):
        super().__init__(in_ch, features, kernel_size, stride, padding,
                         use_bias)
        self._init_vectors()

    def reset_parameters(self, generator: torch.Generator) -> None:
        Conv.reset_parameters(self, generator)
        self._reset_vectors(generator)

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        w = self.normalized_weight(update_stats)
        if full_precision(x, w):
            return F.conv2d(x, w, self.bias, self.stride, self.padding)
        return self._low_precision(F.conv2d(x, w.to(x.dtype), None,
                                            self.stride, self.padding))


class SpectralConvTranspose(SpectralNormed, ConvTranspose):
    """ConvTranspose2d wrapped in spectral norm (SAGAN G stages)."""

    def __init__(self, in_ch: int, features: int, kernel_size=(4, 4),
                 stride=(2, 2), padding: int = 1, use_bias: bool = True):
        super().__init__(in_ch, features, kernel_size, stride, padding, 0,
                         use_bias)
        self._init_vectors()

    def reset_parameters(self, generator: torch.Generator) -> None:
        ConvTranspose.reset_parameters(self, generator)
        self._reset_vectors(generator)

    def forward(self, x: torch.Tensor, update_stats: bool = True
                ) -> torch.Tensor:
        w = self.normalized_weight(update_stats)
        if full_precision(x, w):
            return F.conv_transpose2d(x, w, self.bias, self.stride,
                                      self.padding)
        return self._low_precision(F.conv_transpose2d(
            x, w.to(x.dtype), None, self.stride, self.padding))
