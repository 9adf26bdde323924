"""Plain PyTorch nets of the GCC families, written from their published
layer equations (SJLeo/GCC models/Pix2Pix.py, models/CycleGAN.py): the
U-Net generator with zero-width block elision, the PatchGAN with and
without DARTS mask gates, the MobileResnet generator, and the 1x1
student-to-teacher transforms.

Nets are functions of a flat parameter dict (name -> tensor); ``*_spec``
gives each net's parameter names and shapes. The names are those the
port's modules register, so one set of seed-made tensors loads into both.
Every conv goes through a precision object (``precision.Exact`` computes
in fp32); norms, losses and everything else run in fp32. Nothing here
imports the program.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
EPS = 1e-5  # BatchNorm2d / InstanceNorm2d default


# ---------------------------------------------------------------- the U-Net

def unet_default_cfgs(ngf: int, n: int) -> List[int]:
    """Unpruned filter_cfgs: downs [0..n-1], then ups innermost -> depth 1."""
    return ([ngf * min(2 ** k, 8) for k in range(n)]
            + [ngf * min(2 ** (k - 1), 8) for k in range(n - 1, 0, -1)])


def unet_depths(f: Sequence[int], n: int) -> List[int]:
    """Depths whose blocks exist (Pix2Pix.py:87-103): the innermost iff
    f[n-1] and f[n] are non-zero, a middle depth d in [4, n-2] iff f[d] and
    f[2n-1-d] are, depths 0..3 always."""
    def exists(d):
        if d == n - 1:
            return f[n - 1] != 0 and f[n] != 0
        if 4 <= d <= n - 2:
            return f[d] != 0 and f[2 * n - 1 - d] != 0
        return True
    return [d for d in range(n) if exists(d)]


def unet_plan(f: Sequence[int], n: int, in_nc: int = 3, out_nc: int = 3):
    """(depths, {d: (in, out) of down d}, {d: (in, out) of up d},
    widths of the four captured features)."""
    depths = unet_depths(f, n)
    downs, ups, width = {}, {}, in_nc
    for d in depths:
        downs[d] = (width, f[d])
        width = f[d]
    feats = {0: f[1], 1: f[3]}
    for d in reversed(depths):
        if d == 3:
            feats[2] = width
        if d == 1:
            feats[3] = width
        out = out_nc if d == 0 else f[2 * n - 1 - d]
        ups[d] = (width, out)
        if d > 0:
            width = f[max(dd for dd in depths if dd < d)] + out
    return depths, downs, ups, [feats[i] for i in range(4)]


def unet_spec(f: Sequence[int], n: int, in_nc: int = 3, out_nc: int = 3
              ) -> Dict[str, Tuple[int, ...]]:
    depths, downs, ups, _ = unet_plan(f, n, in_nc, out_nc)
    spec = {}
    for d in depths:
        ci, co = downs[d]
        spec[f"down_{d}.weight"] = (co, ci, 4, 4)
        if d not in (0, n - 1):
            spec[f"down_norm_{d}.weight"] = (co,)
            spec[f"down_norm_{d}.bias"] = (co,)
    for d in reversed(depths):
        ci, co = ups[d]
        spec[f"up_{d}.weight"] = (ci, co, 4, 4)
        if d == 0:
            spec["up_0.bias"] = (co,)
        else:
            spec[f"up_norm_{d}.weight"] = (co,)
            spec[f"up_norm_{d}.bias"] = (co,)
    return spec


def unet(P: Params, x: torch.Tensor, f: Sequence[int], n: int, prec,
         keep: Optional[Callable] = None, train: bool = True):
    """(tanh output, [g_feat_0..3]). ``keep(shape)`` draws a dropout keep
    mask (rate 0.5) for up depths 4..n-2 in train mode; None: no dropout.
    Train mode normalises by batch statistics, eval mode by the running
    statistics at their initial values (mean 0, variance 1)."""
    depths = unet_depths(f, n)
    feats, skips, h = [None] * 4, {}, x
    for d in depths:
        if d > 0:
            h = F.leaky_relu(h, 0.2)
        h = prec.conv(h, P[f"down_{d}.weight"], None, 2, 1)
        if d not in (0, n - 1):
            h = batch_norm(h, P, f"down_norm_{d}", train)
            if d in (1, 3):
                feats[d // 2] = h
        skips[d] = h
    for d in reversed(depths):
        h = torch.relu(h)
        if d in (1, 3):
            feats[3 - d // 2] = h
        if d == 0:
            return torch.tanh(prec.conv_t(h, P["up_0.weight"], P["up_0.bias"],
                                          2, 1, 0)), feats
        h2 = batch_norm(prec.conv_t(h, P[f"up_{d}.weight"], None, 2, 1, 0),
                        P, f"up_norm_{d}", train)
        if keep is not None and train and 4 <= d <= n - 2:
            h2 = torch.where(keep(h2.shape), h2 / 0.5, torch.zeros_like(h2))
        h = torch.cat([skips[max(dd for dd in depths if dd < d)], h2], 1)
    raise AssertionError("unreachable")


def batch_norm(x: torch.Tensor, P: Params, name: str, train: bool):
    """BatchNorm2d with affine: batch statistics (biased variance) in train
    mode; in eval mode the running statistics at their initial values."""
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if train:
        return F.batch_norm(x, None, None, w, b, True, 0.0, EPS)
    zeros = torch.zeros_like(w)
    return F.batch_norm(x, zeros, torch.ones_like(w), w, b, False, 0.0, EPS)


# -------------------------------------------------------------- the PatchGAN

def patchgan_spec(in_nc: int, ndf: int, masked: bool, norm: str,
                  n_layers: int = 3) -> Dict[str, Tuple[int, ...]]:
    """NLayerDiscriminator (Pix2Pix.py:267-348): a masked D always uses
    BatchNorm (CycleGAN.py:185); convs before an InstanceNorm keep a bias."""
    norm = "batch" if masked else norm
    spec = {"conv_0.weight": (ndf, in_nc, 4, 4), "conv_0.bias": (ndf,)}
    if masked:
        spec["mask_0.alpha"] = (ndf,)
    nf = 1
    for i in range(1, n_layers + 1):
        nf_prev, nf = nf, min(2 ** i, 8)
        spec[f"conv_{i}.weight"] = (ndf * nf, ndf * nf_prev, 4, 4)
        if norm == "instance":
            spec[f"conv_{i}.bias"] = (ndf * nf,)
        else:
            spec[f"norm_{i}.weight"] = (ndf * nf,)
            spec[f"norm_{i}.bias"] = (ndf * nf,)
        if masked:
            spec[f"mask_{i}.alpha"] = (ndf * nf,)
    spec["conv_out.weight"] = (1, ndf * nf, 4, 4)
    spec["conv_out.bias"] = (1,)
    return spec


class _StraightThrough(torch.autograd.Function):
    """DifferentiableOp's mask (sign(alpha - t) + 1) / 2 with the gradient
    passed to alpha unchanged (models/DifferentiableOp.py:22-32)."""

    @staticmethod
    def forward(ctx, alpha, threshold):
        return (torch.sign(alpha - threshold) + 1.0) / 2.0

    @staticmethod
    def backward(ctx, g):
        return g, None


def patchgan(P: Params, x: torch.Tensor, masked: bool, norm: str, prec,
             threshold: float = 0.5, n_layers: int = 3):
    """(prediction map, [post-norm features of stages 1 and n_layers])."""
    norm = "batch" if masked else norm

    def gate(h, name):
        if not masked:
            return h
        m = _StraightThrough.apply(P[f"{name}.alpha"], threshold)
        return h * m[None, :, None, None]

    h = gate(F.leaky_relu(prec.conv(x, P["conv_0.weight"], P["conv_0.bias"],
                                    2, 1), 0.2), "mask_0")
    feats = []
    for i in range(1, n_layers + 1):
        h = prec.conv(h, P[f"conv_{i}.weight"], P.get(f"conv_{i}.bias"),
                      2 if i < n_layers else 1, 1)
        h = batch_norm(h, P, f"norm_{i}", True) if norm == "batch" \
            else F.instance_norm(h, eps=EPS)
        if i in (1, n_layers):
            feats.append(h)
        h = F.leaky_relu(gate(h, f"mask_{i}"), 0.2)
    return prec.conv(h, P["conv_out.weight"], P["conv_out.bias"], 1, 1), feats


# ------------------------------------------------------ the MobileResnet

def mobile_resnet_default_cfg(ngf: int, n_blocks: int = 9) -> List[int]:
    return ([ngf, ngf * 2, ngf * 4] + [ngf * 4] * (2 * n_blocks)
            + [ngf * 2, ngf])


def mobile_resnet_spec(cfg: Sequence[int], n_blocks: int = 9,
                       in_nc: int = 3, out_nc: int = 3
                       ) -> Dict[str, Tuple[int, ...]]:
    """CycleGAN.py:77-138: conv7, two stride-2 convs, separable residual
    blocks (a block of layer-1 width 0 is elided), two transpose convs,
    conv7; every conv with a bias."""
    spec = {}

    def conv(name, co, ci, k):
        spec[f"{name}.weight"] = (co, ci, k, k)
        spec[f"{name}.bias"] = (co,)

    conv("conv_in", cfg[0], in_nc, 7)
    conv("down_0", cfg[1], cfg[0], 3)
    conv("down_1", cfg[2], cfg[1], 3)
    width = cfg[2]
    for b in range(n_blocks):
        l1, l2 = cfg[3 + 2 * b], cfg[4 + 2 * b]
        if l1 == 0:
            continue
        for sep, ci, co in ((1, width, l1), (2, l1, l2)):
            conv(f"block_{b}_sep{sep}.depthwise", ci, 1, 3)
            conv(f"block_{b}_sep{sep}.pointwise", co, ci, 1)
    u0, u1 = cfg[3 + 2 * n_blocks], cfg[4 + 2 * n_blocks]
    spec["up_0.weight"], spec["up_0.bias"] = (width, u0, 3, 3), (u0,)
    spec["up_1.weight"], spec["up_1.bias"] = (u0, u1, 3, 3), (u1,)
    conv("conv_out", out_nc, u1, 7)
    return spec


def mobile_resnet(P: Params, x: torch.Tensor, cfg: Sequence[int], prec,
                  n_blocks: int = 9):
    """(tanh output, [relu after down_1, outputs of blocks 2, 5, 8])."""
    def cna(h, name, stride, pad):  # conv, InstanceNorm, relu
        h = prec.conv(h, P[f"{name}.weight"], P[f"{name}.bias"], stride, pad)
        return torch.relu(F.instance_norm(h, eps=EPS))

    def sep(h, name):
        c = h.shape[1]
        h = prec.conv(F.pad(h, (1, 1, 1, 1), mode="reflect"),
                      P[f"{name}.depthwise.weight"],
                      P[f"{name}.depthwise.bias"], 1, 0, groups=c)
        return prec.conv(F.instance_norm(h, eps=EPS),
                         P[f"{name}.pointwise.weight"],
                         P[f"{name}.pointwise.bias"], 1, 0)

    h = cna(F.pad(x, (3, 3, 3, 3), mode="reflect"), "conv_in", 1, 0)
    h = cna(h, "down_0", 2, 1)
    h = cna(h, "down_1", 2, 1)
    feats = [h]
    for b in range(n_blocks):
        if cfg[3 + 2 * b] != 0:
            r = torch.relu(F.instance_norm(sep(h, f"block_{b}_sep1"),
                                           eps=EPS))
            h = h + F.instance_norm(sep(r, f"block_{b}_sep2"), eps=EPS)
        if b in (2, 5, 8):
            feats.append(h)
    for name in ("up_0", "up_1"):
        h = prec.conv_t(h, P[f"{name}.weight"], P[f"{name}.bias"], 2, 1, 1)
        h = torch.relu(F.instance_norm(h, eps=EPS))
    h = prec.conv(F.pad(h, (3, 3, 3, 3), mode="reflect"),
                  P["conv_out.weight"], P["conv_out.bias"], 1, 0)
    return torch.tanh(h), feats


# ------------------------------------------------------ the 1x1 transforms

def transforms_spec(in_widths: Sequence[int], out_widths: Sequence[int]
                    ) -> Dict[str, Tuple[int, ...]]:
    """Student-to-teacher width adapters (Pix2Pix.py:402-415), bias-free."""
    return {f"tf_{i}.weight": (co, ci, 1, 1)
            for i, (ci, co) in enumerate(zip(in_widths, out_widths))}


def transforms(P: Params, feats: Sequence[torch.Tensor], prec):
    return [prec.conv(f, P[f"tf_{i}.weight"], None, 1, 0)
            for i, f in enumerate(feats)]
