"""SAGAN self-attention over H*W positions (port of gcc_tpu/ops/attention.py;
models/SAGAN.py:73-107).

out = gamma * (softmax(Q^T K) applied to V) + x, with Q, K projecting to
max(C // 8, 1) channels, unscaled logits. From N = H*W >= ``flash_threshold``
the attention goes through ``flash_attention`` on every device: on the card
its CUDA kernels, on the CPU its plain pieces (so the CPU tests cover its
custom backward). Below it, the einsum/softmax path of the JAX package
(attention.py:45-50). The JAX package takes its Pallas path on TPU only;
the port's Function carries that choice itself.

The dtype follows x. In bf16 the einsum route rounds where the JAX one does
(attention.py:45-52): fp32 energies from the bf16 q and k, the softmax in
fp32 rounded to bf16, its product with v summed in fp32 and rounded to bf16,
then gamma rounded to bf16 and multiplied and added in bf16. The flash route
keeps p in fp32, as the TPU kernel does, and rounds O once, so in bf16 the
two routes differ by the rounding of p (in fp32 they agree).
tests/test_torch_bf16_sagan.py states the measured difference.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gcc_tpu_torch.ops.flash_attention import flash_attention
from gcc_tpu_torch.ops.layers import Conv


def einsum_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """The route below the threshold, the JAX package's einsum path
    (attention.py:45-51): fp32 energies (bf16 products are exact in fp32),
    softmax in fp32 rounded to q's dtype, the product with v summed in fp32
    and rounded; in fp32 every cast is a no-op and this is
    ``attention_reference``."""
    energy = torch.einsum("bci,bcj->bij", q.float(), k.float())
    attn = torch.softmax(energy, -1).to(q.dtype)
    return torch.einsum("bij,bcj->bci", attn.float(), v.float()).to(q.dtype)


class SelfAttention(nn.Module):
    """NCHW self-attention block with a learnable residual gate ``gamma``
    (a scalar, initialised to zero)."""

    def __init__(self, in_ch: int, flash_threshold: int = 1024):
        super().__init__()
        cq = max(in_ch // 8, 1)
        self.flash_threshold = flash_threshold
        self.query_conv = Conv(in_ch, cq, (1, 1))
        self.key_conv = Conv(in_ch, cq, (1, 1))
        self.value_conv = Conv(in_ch, in_ch, (1, 1))
        self.gamma = nn.Parameter(torch.empty(()))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gamma.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        q = self.query_conv(x).reshape(b, -1, h * w)
        k = self.key_conv(x).reshape(b, -1, h * w)
        v = self.value_conv(x).reshape(b, c, h * w)
        attend = flash_attention if h * w >= self.flash_threshold \
            else einsum_attention
        return self.gamma.to(x.dtype) * attend(q, k, v).reshape(b, c, h, w) + x
