"""Fused MobileResnet residual-block stage: CUDA kernels and their plain
PyTorch versions (counterpart of gcc_tpu/ops/pallas/mobile_block.py).

A stage is one separable conv and its two InstanceNorms:

    y = IN(pw1x1(IN(dw3x3(reflectpad1(x))))) [relu] [+ residual]

and a residual block is two stages (models/CycleGAN.py:112-120). Tensors are
NCHW: x (B, C, H, W), depthwise kernel (C, 1, 3, 3), pointwise kernel
(M, C, 1, 1), residual (B, M, H, W). fp32 only.

Three wrappers stand for the three TPU kernels, with the same split of work:

    stage_fwd     <- _stage_fwd_kernel     (ops/pallas/mobile_block.py:155)
    stage_bwd_pw  <- _stage_bwd_pw_kernel  (:187)  relu + IN2 + pointwise
    stage_bwd_dw  <- _stage_bwd_dw_kernel  (:220)  IN1 + depthwise + pad adjoint

On a CUDA tensor each launches its kernel (csrc/mobile_block.cu) or raises;
on a CPU tensor it runs its plain version, ``*_plain`` below, which repeats
the kernel's arithmetic in PyTorch. ``LAUNCHES`` counts the CUDA calls of
each wrapper. The forward saves a-hat, b-hat and the two per-plane 1/std
vectors for the backward instead of recomputing them as the TPU does.

Conv biases are inert (each conv feeds an affine-free InstanceNorm): the
stage does not read them and ``fused_sep_stage`` returns zero gradients for
them, as the TPU path does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from gcc_tpu_torch.ops import kernels

EPS = 1e-5  # torch InstanceNorm2d default
K_CHUNK = 512  # pixels per split-k partial of the pointwise weight gradient

LAUNCHES = {"stage_fwd": 0, "stage_bwd_pw": 0, "stage_bwd_dw": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _inorm(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Affine-free IN over (H, W), two-pass: (normalised, 1/std of (B, C))."""
    mean = t.mean(dim=(2, 3), keepdim=True)
    r = torch.rsqrt((t - mean).square().mean(dim=(2, 3), keepdim=True) + EPS)
    return (t - mean) * r, r[:, :, 0, 0]


def _inorm_bwd(g: torch.Tensor, that: torch.Tensor,
               r: torch.Tensor) -> torch.Tensor:
    gm = g.mean(dim=(2, 3), keepdim=True)
    gym = (g * that).mean(dim=(2, 3), keepdim=True)
    return r[:, :, None, None] * (g - gm - that * gym)


def _rpad1_adjoint(gxp: torch.Tensor) -> torch.Tensor:
    """Adjoint of reflect-padding H and W by 1: (B, C, H+2, W+2) -> (B, C, H, W)."""
    h, w = gxp.shape[2] - 2, gxp.shape[3] - 2
    g1 = gxp[:, :, :, 1:w + 1].clone()
    g1[:, :, :, 1] += gxp[:, :, :, 0]
    g1[:, :, :, w - 2] += gxp[:, :, :, w + 1]
    gx = g1[:, :, 1:h + 1].clone()
    gx[:, :, 1] += g1[:, :, 0]
    gx[:, :, h - 2] += g1[:, :, h + 1]
    return gx


def stage_fwd_plain(x, dwk, pwk, residual=None, relu=False):
    """Plain version of ``stage_fwd``; differentiable by autograd.
    Returns (y, a-hat, b-hat, 1/std of a (B, C), 1/std of b (B, M))."""
    a = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), dwk,
                 groups=x.shape[1])
    ahat, rstd_a = _inorm(a)
    b = torch.einsum("mc,bchw->bmhw", pwk[:, :, 0, 0], ahat)
    bhat, rstd_b = _inorm(b)
    y = torch.relu(bhat) if relu else bhat
    if residual is not None:
        y = y + residual
    return y, ahat, bhat, rstd_a, rstd_b


def stage_bwd_pw_plain(g, ahat, bhat, rstd_b, pwk, relu):
    """Plain version of ``stage_bwd_pw``: (d loss/d a-hat, d loss/d pwk)."""
    if relu:
        g = torch.where(bhat > 0, g, torch.zeros_like(g))
    gb = _inorm_bwd(g, bhat, rstd_b)
    gah = torch.einsum("mc,bmhw->bchw", pwk[:, :, 0, 0], gb)
    gpw = torch.einsum("bmhw,bchw->mc", gb, ahat)
    return gah, gpw[:, :, None, None]


def stage_bwd_dw_plain(gah, ahat, rstd_a, x, dwk):
    """Plain version of ``stage_bwd_dw``: (d loss/d x, d loss/d dwk)."""
    ga = _inorm_bwd(gah, ahat, rstd_a)
    h, w = x.shape[2], x.shape[3]
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
    gdw = torch.stack([(ga * xp[:, :, i:i + h, j:j + w]).sum(dim=(0, 2, 3))
                       for i in range(3) for j in range(3)], dim=1)
    gxp = F.conv_transpose2d(ga, dwk, groups=x.shape[1])
    return _rpad1_adjoint(gxp), gdw.reshape(dwk.shape)


def sep_stage_reference(x, dwk, pwk, residual=None, relu=False):
    """The stage in plain PyTorch; its backward is autograd's."""
    return stage_fwd_plain(x, dwk, pwk, residual, relu)[0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _dims(x, pwk):
    b, c, h, w = x.shape
    if h < 2 or w < 2:
        raise ValueError(f"reflect padding needs H, W >= 2, got {h}x{w}")
    return b, c, pwk.shape[0], h, w


def stage_fwd(x, dwk, pwk, residual=None, relu=False):
    """Forward of one stage: (y, a-hat, b-hat, 1/std of a, 1/std of b)."""
    if not x.is_cuda:
        return stage_fwd_plain(x, dwk, pwk, residual, relu)
    B, C, M, H, W = _dims(x, pwk)
    dev = x.device
    kernels.check(dev, "x", x, (B, C, H, W))
    kernels.check(dev, "dwk", dwk, (C, 1, 3, 3))
    kernels.check(dev, "pwk", pwk, (M, C, 1, 1))
    if residual is not None:
        kernels.check(dev, "residual", residual, (B, M, H, W))
    with torch.cuda.device(x.device):
        y = torch.empty(B, M, H, W, device=x.device)
        ahat = torch.empty_like(x)
        bhat = torch.empty_like(y)
        rstd_a = torch.empty(B, C, device=x.device)
        rstd_b = torch.empty(B, M, device=x.device)
        p = kernels.ptr
        kernels.launch("mobile_block", "gcc_stage_fwd", p(x), p(dwk), p(pwk),
                       p(residual), p(y), p(ahat), p(bhat), p(rstd_a),
                       p(rstd_b), B, C, M, H, W, int(relu))
    LAUNCHES["stage_fwd"] += 1
    return y, ahat, bhat, rstd_a, rstd_b


def stage_bwd_pw(g, ahat, bhat, rstd_b, pwk, relu):
    """Backward through relu, IN2 and the pointwise conv:
    (d loss/d a-hat (B, C, H, W), d loss/d pwk (M, C, 1, 1))."""
    if not g.is_cuda:
        return stage_bwd_pw_plain(g, ahat, bhat, rstd_b, pwk, relu)
    B, C, M, H, W = _dims(ahat, pwk)
    dev = g.device
    kernels.check(dev, "g", g, (B, M, H, W))
    kernels.check(dev, "ahat", ahat, (B, C, H, W))
    kernels.check(dev, "bhat", bhat, (B, M, H, W))
    kernels.check(dev, "rstd_b", rstd_b, (B, M))
    kernels.check(dev, "pwk", pwk, (M, C, 1, 1))
    splits = -(-H * W // K_CHUNK)
    with torch.cuda.device(g.device):
        gb = torch.empty_like(g)
        gah = torch.empty_like(ahat)
        gpw_part = torch.empty(B * splits, M, C, device=g.device)
        gpw = torch.empty_like(pwk)
        p = kernels.ptr
        kernels.launch("mobile_block", "gcc_stage_bwd_pw", p(g), p(ahat),
                       p(bhat), p(rstd_b), p(pwk), p(gb), p(gah), p(gpw_part),
                       p(gpw), B, C, M, H, W, int(relu), K_CHUNK)
    LAUNCHES["stage_bwd_pw"] += 1
    return gah, gpw


def stage_bwd_dw(gah, ahat, rstd_a, x, dwk):
    """Backward through IN1, the depthwise conv and the reflect pad:
    (d loss/d x (B, C, H, W), d loss/d dwk (C, 1, 3, 3))."""
    if not gah.is_cuda:
        return stage_bwd_dw_plain(gah, ahat, rstd_a, x, dwk)
    B, C, _, H, W = _dims(x, dwk)
    dev = x.device
    kernels.check(dev, "gah", gah, (B, C, H, W))
    kernels.check(dev, "ahat", ahat, (B, C, H, W))
    kernels.check(dev, "rstd_a", rstd_a, (B, C))
    kernels.check(dev, "x", x, (B, C, H, W))
    kernels.check(dev, "dwk", dwk, (C, 1, 3, 3))
    with torch.cuda.device(x.device):
        ga = torch.empty_like(gah)
        gx = torch.empty_like(x)
        gdw_part = torch.empty(B, C, 9, device=x.device)
        gdw = torch.empty_like(dwk)
        p = kernels.ptr
        kernels.launch("mobile_block", "gcc_stage_bwd_dw", p(gah), p(ahat),
                       p(rstd_a), p(x), p(dwk), p(ga), p(gx), p(gdw_part),
                       p(gdw), B, C, H, W)
    LAUNCHES["stage_bwd_dw"] += 1
    return gx, gdw


# ---------------------------------------------------------------------------
# differentiable stage and block
# ---------------------------------------------------------------------------

class _FusedSepStage(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dwk, pwk, dwb, pwb, residual, relu):
        x, dwk, pwk = x.contiguous(), dwk.contiguous(), pwk.contiguous()
        if residual is not None:
            residual = residual.contiguous()
        y, ahat, bhat, rstd_a, rstd_b = stage_fwd(x, dwk, pwk, residual, relu)
        ctx.save_for_backward(x, dwk, pwk, ahat, bhat, rstd_a, rstd_b)
        ctx.relu, ctx.has_res = relu, residual is not None
        ctx.bias_shapes = (None if dwb is None else dwb.shape,
                           None if pwb is None else pwb.shape)
        return y

    @staticmethod
    def backward(ctx, g):
        x, dwk, pwk, ahat, bhat, rstd_a, rstd_b = ctx.saved_tensors
        gah, gpw = stage_bwd_pw(g.contiguous(), ahat, bhat, rstd_b, pwk,
                                ctx.relu)
        gx, gdw = stage_bwd_dw(gah, ahat, rstd_a, x, dwk)
        gdwb, gpwb = (None if s is None else g.new_zeros(s)
                      for s in ctx.bias_shapes)
        return (gx, gdw, gpw, gdwb, gpwb, g if ctx.has_res else None, None)


def fused_sep_stage(x: torch.Tensor, dwk: torch.Tensor, pwk: torch.Tensor,
                    residual: Optional[torch.Tensor] = None,
                    relu: bool = False, dwb: Optional[torch.Tensor] = None,
                    pwb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused stage, differentiable through the kernels' backward.
    ``dwb``/``pwb`` are the inert biases: not read, zero gradients."""
    return _FusedSepStage.apply(x, dwk, pwk, dwb, pwb, residual, relu)


def fused_mobile_block(x: torch.Tensor, sep1, sep2) -> torch.Tensor:
    """One MobileResnet residual block (CycleGAN.py:112-120) from two
    SeparableConv modules: x + IN(pw2(IN(dw2(rpad(relu(IN(pw1(IN(dw1(rpad(x)))))))))))."""
    r = fused_sep_stage(x, sep1.depthwise.weight, sep1.pointwise.weight, None,
                        True, sep1.depthwise.bias, sep1.pointwise.bias)
    return fused_sep_stage(r, sep2.depthwise.weight, sep2.pointwise.weight, x,
                           False, sep2.depthwise.bias, sep2.pointwise.bias)
