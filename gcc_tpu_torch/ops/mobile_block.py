"""Fused MobileResnet residual-block stage: CUDA kernels and their plain
PyTorch versions (counterpart of gcc_tpu/ops/pallas/mobile_block.py).

A stage is one separable conv and its two InstanceNorms:

    y = IN(pw1x1(IN(dw3x3(reflectpad1(x))))) [relu] [+ residual]

and a residual block is two stages (models/CycleGAN.py:112-120). Tensors are
NCHW: x (B, C, H, W), depthwise kernel (C, 1, 3, 3), pointwise kernel
(M, C, 1, 1), residual (B, M, H, W). The activations (x, the residual, y,
a-hat, b-hat, the upstream gradient and dx) are float32 or bfloat16, the
TPU kernel's activation dtype; the weights, the 1/std vectors and the weight
gradients are float32. In bf16 each wrapper launches its ``*_bf16`` entry
point and the plain versions round where the TPU kernel rounds.

Three wrappers stand for the three TPU kernels, with the same split of work:

    stage_fwd     <- _stage_fwd_kernel     (ops/pallas/mobile_block.py:155)
    stage_bwd_pw  <- _stage_bwd_pw_kernel  (:187)  relu + IN2 + pointwise
    stage_bwd_dw  <- _stage_bwd_dw_kernel  (:220)  IN1 + depthwise + pad adjoint

On a CUDA tensor each launches its kernel or raises, also for an activation
dtype without a kernel: csrc/mobile_block.cu in fp32, csrc/mobile_block_bf16.cu
in bf16. On a CPU tensor it runs its
plain version, ``*_plain`` below, which repeats the kernel's arithmetic in
PyTorch. ``LAUNCHES`` counts the CUDA calls of each wrapper by dtype
(``stage_fwd`` fp32, ``stage_fwd_bf16`` bf16, and so on). The forward
saves a-hat, b-hat and the two per-plane 1/std vectors for the backward
instead of recomputing them as the TPU does.

Conv biases are inert (each conv feeds an affine-free InstanceNorm): the
stage does not read them and ``fused_sep_stage`` returns zero gradients for
them, as the TPU path does.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from gcc_tpu_torch.ops import kernels

EPS = 1e-5  # torch InstanceNorm2d default

# the entry points' suffix by activation dtype
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}
# the library of the entry points, by suffix
_LIBRARY = {"": "mobile_block", "_bf16": "mobile_block_bf16"}

LAUNCHES = {f"{k}{sfx}": 0 for sfx in _SUFFIX.values()
            for k in ("stage_fwd", "stage_bwd_pw", "stage_bwd_dw")}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _inorm(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Affine-free IN over (H, W), two-pass statistics in fp32:
    (normalised, in t's dtype; 1/std of (B, C))."""
    tf = t.float()
    mean = tf.mean(dim=(2, 3), keepdim=True)
    r = torch.rsqrt((tf - mean).square().mean(dim=(2, 3), keepdim=True) + EPS)
    return ((tf - mean) * r).to(t.dtype), r[:, :, 0, 0]


def _inorm_bwd(g: torch.Tensor, that: torch.Tensor,
               r: torch.Tensor) -> torch.Tensor:
    """IN's backward in fp32, rounded to g's dtype."""
    gf, tf = g.float(), that.float()
    gm = gf.mean(dim=(2, 3), keepdim=True)
    gym = (gf * tf).mean(dim=(2, 3), keepdim=True)
    return (r[:, :, None, None] * (gf - gm - tf * gym)).to(g.dtype)


def _rpad1_adjoint(gxp: torch.Tensor) -> torch.Tensor:
    """Adjoint of reflect-padding H and W by 1: (B, C, H+2, W+2) -> (B, C, H, W),
    columns folded first, then rows, each sum in gxp's dtype."""
    h, w = gxp.shape[2] - 2, gxp.shape[3] - 2
    g1 = gxp[:, :, :, 1:w + 1].clone()
    g1[:, :, :, 1] += gxp[:, :, :, 0]
    g1[:, :, :, w - 2] += gxp[:, :, :, w + 1]
    gx = g1[:, :, 1:h + 1].clone()
    gx[:, :, 1] += g1[:, :, 0]
    gx[:, :, h - 2] += g1[:, :, h + 1]
    return gx


def _pw(pwk: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The pointwise kernel (M, C) rounded to the activations' dtype, as an
    fp32 tensor: bf16 x bf16 products are exact in fp32, so an fp32 einsum
    of these is the tensor cores' bf16 product with fp32 sums."""
    return pwk[:, :, 0, 0].to(dtype).float()


def _dw_taps(x: torch.Tensor, dwk: torch.Tensor) -> torch.Tensor:
    """The depthwise 3x3 of the reflect-padded x in fp32. Below fp32 the
    taps are products summed by kernel row, then the three rows
    ((t0 + t1) + t2) + ((t3 + t4) + t5) + ((t6 + t7) + t8), each a separate
    fp32 operation: the order in which XLA sums the TPU kernel's nine taps
    and in which the bf16 CUDA kernel sums them, so that a rounds to bf16
    from the same fp32 value. fp32 takes the convolution."""
    xp = F.pad(x.float(), (1, 1, 1, 1), mode="reflect")
    if x.dtype == torch.float32:
        return F.conv2d(xp, dwk, groups=x.shape[1])
    h, w = x.shape[2], x.shape[3]
    rows = []
    for i in range(3):
        t = [xp[:, :, i:i + h, j:j + w] * dwk[None, :, 0, i, j, None, None]
             for j in range(3)]
        rows.append((t[0] + t[1]) + t[2])
    return (rows[0] + rows[1]) + rows[2]


def stage_fwd_plain(x, dwk, pwk, residual=None, relu=False):
    """Plain version of ``stage_fwd``; differentiable by autograd.
    Returns (y, a-hat, b-hat, 1/std of a (B, C), 1/std of b (B, M)).

    In x's dtype with the TPU kernel's rounding points: a (the depthwise
    taps, fp32 from fp32 weights), a-hat, b (pw rounded to x's dtype, fp32
    sums), b-hat and y are rounded to it; the residual is added to the
    rounded y and rounded once more. fp32 rounds nowhere."""
    dt = x.dtype
    a = _dw_taps(x, dwk).to(dt)
    ahat, rstd_a = _inorm(a)
    b = torch.einsum("mc,bchw->bmhw", _pw(pwk, dt), ahat.float()).to(dt)
    bhat, rstd_b = _inorm(b)
    y = torch.relu(bhat) if relu else bhat
    if residual is not None:
        y = y + residual
    return y, ahat, bhat, rstd_a, rstd_b


def stage_bwd_pw_plain(g, ahat, bhat, rstd_b, pwk, relu):
    """Plain version of ``stage_bwd_pw``: (d loss/d a-hat in g's dtype,
    d loss/d pwk in fp32). d b-hat and d a-hat are rounded to g's dtype."""
    if relu:
        g = torch.where(bhat > 0, g, torch.zeros_like(g))
    gb = _inorm_bwd(g, bhat, rstd_b)
    gah = torch.einsum("mc,bmhw->bchw", _pw(pwk, g.dtype),
                       gb.float()).to(g.dtype)
    gpw = torch.einsum("bmhw,bchw->mc", gb.float(), ahat.float())
    return gah, gpw[:, :, None, None]


def stage_bwd_dw_plain(gah, ahat, rstd_a, x, dwk):
    """Plain version of ``stage_bwd_dw``: (d loss/d x in x's dtype,
    d loss/d dwk in fp32). In bf16, as the TPU kernel: d a rounded, each of
    the nine transposed taps a product with the weight rounded to bf16,
    summed in bf16 in tap order, then the pad adjoint's sums in bf16."""
    ga = _inorm_bwd(gah, ahat, rstd_a)
    B, C, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1), mode="reflect")
    gaf = ga.float()
    gdw = torch.stack([(gaf * xp[:, :, i:i + h, j:j + w]).sum(dim=(0, 2, 3))
                       for i in range(3) for j in range(3)], dim=1)
    if x.dtype == torch.float32:
        gxp = F.conv_transpose2d(ga, dwk, groups=C)
    else:
        wl = dwk.reshape(C, 9).to(x.dtype)
        gxp = ga.new_zeros(B, C, h + 2, w + 2)
        for t in range(9):
            i, j = divmod(t, 3)
            gxp[:, :, i:i + h, j:j + w] += ga * wl[:, t, None, None]
    return _rpad1_adjoint(gxp), gdw.reshape(dwk.shape)


def sep_stage_reference(x, dwk, pwk, residual=None, relu=False):
    """The stage in plain PyTorch; its backward is autograd's."""
    return stage_fwd_plain(x, dwk, pwk, residual, relu)[0]


# How close the bf16 kernels stay to their plain versions: a bf16 output
# within BF16_ULPS bf16 ulps of its largest value and at most BF16_SHARE of
# its elements apart at all (the kernels round where the plain versions
# round; only fp32 sums in another order move a value to its other bf16
# neighbour), an fp32 weight gradient within BF16_DW of its largest value
# (the first two measured by kernels.bf16_err).
BF16_ULPS, BF16_SHARE, BF16_DW = 2.0, 0.01, 1e-3


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _dims(x, pwk):
    b, c, h, w = x.shape
    if h < 2 or w < 2:
        raise ValueError(f"reflect padding needs H, W >= 2, got {h}x{w}")
    return b, c, pwk.shape[0], h, w


def _suffix(t: torch.Tensor) -> str:
    """The entry points' suffix for an activation's dtype; raises for a
    dtype the kernels do not take."""
    if t.dtype not in _SUFFIX:
        raise ValueError(f"the stage kernels take float32 or bfloat16 "
                         f"activations, got {t.dtype}")
    return _SUFFIX[t.dtype]


def _on(dev: torch.device):
    """A context in which dev is the current CUDA device: none to enter
    where it is already (the common case, and a cost the host pays every
    call)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """The SM count of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _pw_grad_partials(B: int, C: int, M: int, H: int, W: int, sms: int,
                      sfx: str) -> int:
    """Partials of the pointwise weight gradient's ordered split-k sum, as
    the dtype's kernel library sizes the split for the shape and the SM
    count."""
    return getattr(kernels.library(_LIBRARY[sfx]),
                   f"gcc_stage_bwd_pw{sfx}_partials")(B, C, M, H, W, sms)


@functools.lru_cache(maxsize=None)
def _dw_grad_partials(B: int, sfx: str) -> int:
    """Per-plane partials of the depthwise weight gradient's ordered sum over
    B samples: B in fp32; in bf16 as the library sizes them (0 where one
    launch sums them)."""
    if not sfx:
        return B
    return kernels.library(_LIBRARY[sfx]).gcc_stage_bwd_dw_bf16_partials(B)


def stage_fwd(x, dwk, pwk, residual=None, relu=False):
    """Forward of one stage: (y, a-hat, b-hat, 1/std of a, 1/std of b)."""
    if not x.is_cuda:
        return stage_fwd_plain(x, dwk, pwk, residual, relu)
    B, C, M, H, W = _dims(x, pwk)
    dev, dt, sfx = x.device, x.dtype, _suffix(x)
    kernels.check(dev, "x", x, (B, C, H, W), dt)
    kernels.check(dev, "dwk", dwk, (C, 1, 3, 3))
    kernels.check(dev, "pwk", pwk, (M, C, 1, 1))
    if residual is not None:
        kernels.check(dev, "residual", residual, (B, M, H, W), dt)
    with _on(dev):
        y = torch.empty(B, M, H, W, device=dev, dtype=dt)
        ahat = torch.empty_like(x)
        bhat = torch.empty_like(y)
        rstd_a = torch.empty(B, C, device=dev)
        rstd_b = torch.empty(B, M, device=dev)
        p = kernels.ptr
        # the bf16 entry point sizes its product's tiles by the SM count
        sms = (_sms(dev.index),) if sfx else ()
        kernels.launch(_LIBRARY[sfx], f"gcc_stage_fwd{sfx}", p(x), p(dwk),
                       p(pwk), p(residual), p(y), p(ahat), p(bhat),
                       p(rstd_a), p(rstd_b), B, C, M, H, W, int(relu), *sms)
    LAUNCHES[f"stage_fwd{sfx}"] += 1
    return y, ahat, bhat, rstd_a, rstd_b


def stage_bwd_pw(g, ahat, bhat, rstd_b, pwk, relu):
    """Backward through relu, IN2 and the pointwise conv:
    (d loss/d a-hat (B, C, H, W), d loss/d pwk (M, C, 1, 1))."""
    if not g.is_cuda:
        return stage_bwd_pw_plain(g, ahat, bhat, rstd_b, pwk, relu)
    B, C, M, H, W = _dims(ahat, pwk)
    dev, dt, sfx = g.device, g.dtype, _suffix(g)
    kernels.check(dev, "g", g, (B, M, H, W), dt)
    kernels.check(dev, "ahat", ahat, (B, C, H, W), dt)
    kernels.check(dev, "bhat", bhat, (B, M, H, W), dt)
    kernels.check(dev, "rstd_b", rstd_b, (B, M))
    kernels.check(dev, "pwk", pwk, (M, C, 1, 1))
    sms = _sms(dev.index)
    with _on(dev):
        gah = torch.empty_like(ahat)
        gpw = torch.empty_like(pwk)
        # scratch: gb (B, M, H, W) in g's dtype, then the dW partials
        gb_bytes = -(-g.numel() * g.element_size() // 256) * 256
        parts = _pw_grad_partials(B, C, M, H, W, sms, sfx)
        scratch = torch.empty(gb_bytes + parts * M * C * 4, device=dev,
                              dtype=torch.uint8)
        gb = scratch.data_ptr()
        p = kernels.ptr
        kernels.launch(_LIBRARY[sfx], f"gcc_stage_bwd_pw{sfx}", p(g),
                       p(ahat), p(bhat), p(rstd_b), p(pwk), gb, p(gah),
                       gb + gb_bytes, p(gpw), B, C, M, H, W, int(relu), sms)
    LAUNCHES[f"stage_bwd_pw{sfx}"] += 1
    return gah, gpw


def stage_bwd_dw(gah, ahat, rstd_a, x, dwk):
    """Backward through IN1, the depthwise conv and the reflect pad:
    (d loss/d x (B, C, H, W), d loss/d dwk (C, 1, 3, 3))."""
    if not gah.is_cuda:
        return stage_bwd_dw_plain(gah, ahat, rstd_a, x, dwk)
    B, C, _, H, W = _dims(x, dwk)
    dev, dt, sfx = x.device, x.dtype, _suffix(x)
    kernels.check(dev, "gah", gah, (B, C, H, W), dt)
    kernels.check(dev, "ahat", ahat, (B, C, H, W), dt)
    kernels.check(dev, "rstd_a", rstd_a, (B, C))
    kernels.check(dev, "x", x, (B, C, H, W), dt)
    kernels.check(dev, "dwk", dwk, (C, 1, 3, 3))
    with _on(dev):
        gx = torch.empty_like(x)
        parts = _dw_grad_partials(B, sfx)
        gdw_part = torch.empty(parts, C, 9, device=dev) if parts else None
        gdw = torch.empty_like(dwk)
        p = kernels.ptr
        kernels.launch(_LIBRARY[sfx], f"gcc_stage_bwd_dw{sfx}", p(gah),
                       p(ahat), p(rstd_a), p(x), p(dwk), p(gx), p(gdw_part),
                       p(gdw), B, C, H, W)
    LAUNCHES[f"stage_bwd_dw{sfx}"] += 1
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
        ctx.biases = [None if b is None else (b.shape, b.dtype)
                      for b in (dwb, pwb)]
        return y

    @staticmethod
    def backward(ctx, g):
        x, dwk, pwk, ahat, bhat, rstd_a, rstd_b = ctx.saved_tensors
        gah, gpw = stage_bwd_pw(g.contiguous(), ahat, bhat, rstd_b, pwk,
                                ctx.relu)
        gx, gdw = stage_bwd_dw(gah, ahat, rstd_a, x, dwk)
        gdwb, gpwb = (None if b is None else g.new_zeros(b[0], dtype=b[1])
                      for b in ctx.biases)
        return (gx, gdw, gpw, gdwb, gpwb, g if ctx.has_res else None, None)


def fused_sep_stage(x: torch.Tensor, dwk: torch.Tensor, pwk: torch.Tensor,
                    residual: Optional[torch.Tensor] = None,
                    relu: bool = False, dwb: Optional[torch.Tensor] = None,
                    pwb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused stage, differentiable through the kernels' backward: dx in
    x's dtype, the weight gradients in float32. ``dwb``/``pwb`` are the
    inert biases: not read, zero gradients."""
    return _FusedSepStage.apply(x, dwk, pwk, dwb, pwb, residual, relu)


def fused_mobile_block(x: torch.Tensor, sep1, sep2) -> torch.Tensor:
    """One MobileResnet residual block (CycleGAN.py:112-120) from two
    SeparableConv modules: x + IN(pw2(IN(dw2(rpad(relu(IN(pw1(IN(dw1(rpad(x)))))))))))."""
    r = fused_sep_stage(x, sep1.depthwise.weight, sep1.pointwise.weight, None,
                        True, sep1.depthwise.bias, sep1.pointwise.bias)
    return fused_sep_stage(r, sep2.depthwise.weight, sep2.pointwise.weight, x,
                           False, sep2.depthwise.bias, sep2.pointwise.bias)
