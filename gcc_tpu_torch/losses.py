"""Loss functions: GAN objectives and distillation (port of gcc_tpu/losses.py:18-127).

GAN modes replicate models/GANLoss.py:38-59 exactly:
  lsgan   : MSE vs target label
  vanilla : BCE-with-logits vs target label
  hinge   : D: -E[min(+-pred - 1, 0)]; G: -E[pred] (target must be real)
  wgangp  : -+E[pred]

The slice runs in fp32, where the JAX package's ``gram_pair_err`` takes the
direct gram path; its bf16 kernel-matrix identity comes with the port's bf16
work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

GAN_MODES = ("lsgan", "vanilla", "hinge", "wgangp")


def gan_loss(pred: torch.Tensor, target_is_real: bool, gan_mode: str,
             for_discriminator: bool = True) -> torch.Tensor:
    pred = pred.float()
    if gan_mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return torch.mean(torch.square(pred - target))
    if gan_mode == "vanilla":
        # BCEWithLogits: softplus(-x) for target 1, softplus(x) for target 0
        z = pred if target_is_real else -pred
        return torch.mean(F.softplus(-z))
    if gan_mode == "hinge":
        if for_discriminator:
            signed = pred - 1.0 if target_is_real else -pred - 1.0
            return -torch.mean(torch.clamp(signed, max=0.0))
        if not target_is_real:
            raise ValueError("the generator's hinge loss needs a real target")
        return -torch.mean(pred)
    if gan_mode == "wgangp":
        return -torch.mean(pred) if target_is_real else torch.mean(pred)
    raise NotImplementedError(f"gan mode {gan_mode} not implemented")


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a.float() - b.float()))


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(a.float() - b.float()))


def gram(x: torch.Tensor) -> torch.Tensor:
    """Gram matrix G = f f^T / (c*h*w), f = (B, C, H*W) (Pix2Pix.py:733-740).
    Input NCHW; output (B, C, C) in float32."""
    b, c, h, w = x.shape
    f = x.float().reshape(b, c, h * w)
    return torch.bmm(f, f.transpose(1, 2)) / (c * h * w)


def sqrt_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sqrt(MSE(a, b)) used by pix2pix/sagan/srgan distillation
    (Pix2Pix.py:542-543). A tiny floor keeps the gradient finite at 0."""
    return torch.sqrt(torch.clamp(mse(a, b), min=1e-12))


def gram_pair_err(f: torch.Tensor, t: torch.Tensor,
                  use_sqrt: bool = True) -> torch.Tensor:
    """err(gram(f), gram(t)): the per-pair gram distillation term
    (Pix2Pix.py:541-543)."""
    return (sqrt_mse if use_sqrt else mse)(gram(f), gram(t))


def tv_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Total-variation loss (models/GANLoss.py:76-93), NCHW input."""
    b, c, h, w = x.shape
    count_h = (h - 1) * w * c
    count_w = h * (w - 1) * c
    h_tv = torch.sum(torch.square(x[:, :, 1:, :] - x[:, :, :-1, :]))
    w_tv = torch.sum(torch.square(x[:, :, :, 1:] - x[:, :, :, :-1]))
    return weight * 2.0 * (h_tv / count_h + w_tv / count_w) / b
