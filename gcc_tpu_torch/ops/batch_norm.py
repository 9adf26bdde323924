"""Train-mode BatchNorm on bf16 activations: CUDA kernels and their plain
PyTorch versions.

No TPU kernel stands behind these: the JAX package leaves BatchNorm to XLA,
which fuses it. In eager PyTorch the same arithmetic (``layers.BatchNorm``
on bf16) is a chain of fp32 elementwise launches, 18 forward and 25
backward, that moves ~52 and ~120 bytes an element; csrc/batch_norm_bf16.cu
does it in two launches each way at 6 and 10 bytes an element (the source
note has the design).

    bn_fwd   x, w, b [, running stats]  ->  y, mean, invstd
    bn_bwd   g, x, mean, invstd, w      ->  dx, dw, db

x, y, g and dx are NCHW bf16; the weights, statistics and their gradients
fp32. The statistics are the JAX package's one-pass form for bf16,
var = E[x^2] - E[x]^2, in fp32; y and dx round once to bf16. On a CUDA tensor
each wrapper launches its kernels or raises, also for an input they do not
take; on a CPU tensor it runs its plain version, ``*_plain`` below, which
repeats the kernels' arithmetic (only the sums' order differs). ``LAUNCHES``
counts the CUDA calls of each wrapper. ``batch_norm_train`` is the
differentiable form that ``layers.BatchNorm`` takes where the kernels
engage (``layers.kernel_route``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from gcc_tpu_torch.ops import kernels

LAUNCHES = {"bn_fwd_bf16": 0, "bn_bwd_bf16": 0}

# how the kernels are held to the plain versions (tests/, chip_smoke.py): y
# and dx within BF16_ULPS bf16 ulps of their largest value and at most
# BF16_SHARE of their elements apart at all (both round once from fp32
# values whose sums ran in another order), the fp32 statistics within
# STAT_RTOL and the weight gradients within GRAD_RTOL of their largest value
BF16_ULPS, BF16_SHARE, STAT_RTOL, GRAD_RTOL = 2.0, 0.01, 1e-5, 1e-4

# the split of a channel's slots over blocks: at most BLOCKS_AN_SM blocks of
# 256 threads an SM over the grid (what the SMs hold at once, so no second,
# partial wave), none with fewer than MIN_SLOTS slots of eight values
BLOCKS_AN_SM, MIN_SLOTS = 8, 1024


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _c(v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector broadcast over NCHW."""
    return v[:, None, None]


def update_running(running_mean: torch.Tensor, running_var: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, n: int,
                   momentum: float) -> None:
    """running <- (1 - momentum) running + momentum batch, in place; the
    variance unbiased by n / (n - 1), as torch stores it."""
    unbias = n / max(n - 1, 1)
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1 - momentum).add_(var * unbias, alpha=momentum)


def bn_fwd_plain(x, weight, bias, running_mean=None, running_var=None,
                 momentum=0.1, eps=1e-5):
    """Plain version of ``bn_fwd``: (y, mean, invstd)."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = xf.square().mean(dim=(0, 2, 3)) - mean.square()
    invstd = torch.rsqrt(var + eps)
    if running_mean is not None:
        update_running(running_mean, running_var, mean, var,
                       x.shape[0] * x.shape[2] * x.shape[3], momentum)
    y = ((xf - _c(mean)) * _c(invstd * weight) + _c(bias)).to(x.dtype)
    return y, mean, invstd


def bn_bwd_plain(g, x, mean, invstd, weight, need_dx=True, need_dw=True,
                 need_db=True):
    """Plain version of ``bn_bwd``: (dx, dw, db), None where not needed."""
    n = x.shape[0] * x.shape[2] * x.shape[3]
    gf = g.float()
    xhat = (x.float() - _c(mean)) * _c(invstd)
    sg = gf.sum(dim=(0, 2, 3))
    sgx = (gf * xhat).sum(dim=(0, 2, 3))
    dx = None
    if need_dx:
        dx = (_c(weight * invstd) * ((gf - _c(sg / n)) - xhat * _c(sgx / n))
              ).to(x.dtype)
    return dx, sgx if need_dw else None, sg if need_db else None


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def slots_a_plane(hw: int) -> int:
    """The 16-byte slots a plane of hw bf16 values spans at most (the
    library's ``slots_a_plane``)."""
    return hw // 8 if hw % 8 == 0 else (hw + 14) // 8


@functools.lru_cache(maxsize=None)
def splits(N: int, C: int, HW: int, sms: int) -> int:
    """Blocks a channel for an (N, C, HW) batch on ``sms`` SMs: as many as
    fit BLOCKS_AN_SM blocks an SM over the grid, each with at least
    MIN_SLOTS slots, and one at least."""
    return max(1, min(BLOCKS_AN_SM * sms // C,
                      N * slots_a_plane(HW) // MIN_SLOTS))


def _dims(x: torch.Tensor) -> Tuple[int, int, int]:
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"the BatchNorm kernels take a non-empty NCHW "
                         f"tensor, got shape {tuple(x.shape)}")
    N, C, H, W = x.shape
    if C > 65535 or N * slots_a_plane(H * W) >= 2 ** 31:
        raise ValueError(f"the BatchNorm kernels take C <= 65535 and fewer "
                         f"than 2^31 slots a channel, got {tuple(x.shape)}")
    return N, C, H * W


def _check_act(dev, name: str, t: torch.Tensor, shape) -> None:
    kernels.check(dev, name, t, shape, torch.bfloat16)
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def bn_fwd(x, weight, bias, running_mean=None, running_var=None,
           momentum=0.1, eps=1e-5):
    """Train-mode forward: (y, mean, invstd); moves the running statistics
    in place where they are given."""
    if not x.is_cuda:
        return bn_fwd_plain(x, weight, bias, running_mean, running_var,
                            momentum, eps)
    N, C, HW = _dims(x)
    dev = x.device
    _check_act(dev, "x", x, x.shape)
    kernels.check(dev, "weight", weight, (C,))
    kernels.check(dev, "bias", bias, (C,))
    if (running_mean is None) != (running_var is None):
        raise ValueError("running_mean and running_var go together")
    if running_mean is not None:
        kernels.check(dev, "running_mean", running_mean, (C,))
        kernels.check(dev, "running_var", running_var, (C,))
    S = splits(N, C, HW, kernels.sm_count(dev.index))
    n = N * HW
    with kernels.on_device(dev):
        y = torch.empty_like(x)
        mean = torch.empty(C, device=dev)
        invstd = torch.empty(C, device=dev)
        part = torch.empty(C * S * 2, device=dev)
        p = kernels.ptr
        kernels.launch("batch_norm_bf16", "gcc_bn_fwd_bf16", p(x), p(weight),
                       p(bias), p(running_mean), p(running_var), p(y),
                       p(mean), p(invstd), p(part), N, C, HW, S, eps,
                       1 - momentum, momentum, n / max(n - 1, 1))
    LAUNCHES["bn_fwd_bf16"] += 1
    return y, mean, invstd


def bn_bwd(g, x, mean, invstd, weight, need_dx=True, need_dw=True,
           need_db=True):
    """Backward: (dx, dw, db), None where not needed."""
    if not g.is_cuda:
        return bn_bwd_plain(g, x, mean, invstd, weight, need_dx, need_dw,
                            need_db)
    N, C, HW = _dims(x)
    dev = x.device
    _check_act(dev, "g", g, x.shape)
    _check_act(dev, "x", x, x.shape)
    for name, t in (("mean", mean), ("invstd", invstd), ("weight", weight)):
        kernels.check(dev, name, t, (C,))
    S = splits(N, C, HW, kernels.sm_count(dev.index))
    with kernels.on_device(dev):
        dx = torch.empty_like(x) if need_dx else None
        dw = torch.empty(C, device=dev) if need_dw else None
        db = torch.empty(C, device=dev) if need_db else None
        part = torch.empty(C * S * 2, device=dev)
        p = kernels.ptr
        kernels.launch("batch_norm_bf16", "gcc_bn_bwd_bf16", p(g), p(x),
                       p(mean), p(invstd), p(weight), p(dx), p(dw), p(db),
                       p(part), N, C, HW, S)
    LAUNCHES["bn_bwd_bf16"] += 1
    return dx, dw, db


# ---------------------------------------------------------------------------
# differentiable form
# ---------------------------------------------------------------------------

def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and on a 16-byte boundary (a copy only where not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _BatchNormTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        x = _aligned(x) if x.is_cuda else x
        y, mean, invstd = bn_fwd(x, weight, bias, running_mean, running_var,
                                 momentum, eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight, mean, invstd = ctx.saved_tensors
        if g.is_cuda:
            g = _aligned(g)
        dx, dw, db = bn_bwd(g, x, mean, invstd, weight,
                            *ctx.needs_input_grad[:3])
        return dx, dw, db, None, None, None, None


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor,
                     running_mean: Optional[torch.Tensor] = None,
                     running_var: Optional[torch.Tensor] = None,
                     momentum: float = 0.1, eps: float = 1e-5
                     ) -> torch.Tensor:
    """Train-mode BatchNorm of a bf16 NCHW batch through ``bn_fwd`` and
    ``bn_bwd``: y in x's dtype, dw and db in fp32. The running statistics
    move in place where they are given."""
    return _BatchNormTrain.apply(x, weight, bias, running_mean, running_var,
                                 momentum, eps)
