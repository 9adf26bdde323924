"""The tensor cores' fp32 arithmetic emulated on the CPU, for the precision
tests of the port's split-TF32 kernels (tests/test_torch_attention.py,
tests/test_torch_mobile_block.py)."""

import torch


def tf32(x):
    """float32 -> TF32 by masking the 13 low mantissa bits, as the CUDA
    kernels form their tensor-core operands."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def rz32(x64):
    """float64 -> float32 rounded toward zero, as the tensor cores round
    what they accumulate."""
    f = x64.float()
    return torch.where(f.double().abs() > x64.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def mma_partial(a, b, mode):
    """a @ b over k in steps of 8 (one m16n8k8 mma each) into a zeroed
    accumulator that rounds toward zero after every mma: split-TF32 operands
    (lo*hi, hi*lo, hi*hi) or plain TF32 ones ("tf32")."""
    ah, bh = tf32(a), tf32(b)
    if mode == "tf32":
        pairs = [(ah, bh)]
    else:
        pairs = [(tf32(a - ah), bh), (ah, tf32(b - bh)), (ah, bh)]
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
    for k0 in range(0, a.shape[1], 8):
        for x, y in pairs:
            acc = rz32(acc + x[:, k0:k0 + 8].double() @ y[k0:k0 + 8].double())
    return acc.float()
