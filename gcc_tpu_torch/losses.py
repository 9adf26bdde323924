"""Loss functions: GAN objectives and distillation (port of gcc_tpu/losses.py:18-127).

GAN modes replicate models/GANLoss.py:38-59 exactly:
  lsgan   : MSE vs target label
  vanilla : BCE-with-logits vs target label
  hinge   : D: -E[min(+-pred - 1, 0)]; G: -E[pred] (target must be real)
  wgangp  : -+E[pred]

Every loss is float32 whatever its inputs' dtype. Every mean over the batch
is ``parallel.mesh.batch_mean``: under a data-parallel mesh the global
batch's mean, on every rank, before any nonlinearity (``sqrt_mse``'s sqrt,
``gram_pair_err``'s); torch.mean otherwise. ``gram_pair_err`` takes the
JAX package's kernel-matrix identity for bf16 features with 2 h w <= c, the
direct grams otherwise (fp32 always).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gcc_tpu_torch.parallel.mesh import all_reduce_sum, batch_mean, global_batch

GAN_MODES = ("lsgan", "vanilla", "hinge", "wgangp")


def gan_loss(pred: torch.Tensor, target_is_real: bool, gan_mode: str,
             for_discriminator: bool = True) -> torch.Tensor:
    pred = pred.float()
    if gan_mode == "lsgan":
        target = 1.0 if target_is_real else 0.0
        return batch_mean(torch.square(pred - target))
    if gan_mode == "vanilla":
        # BCEWithLogits: softplus(-x) for target 1, softplus(x) for target 0
        z = pred if target_is_real else -pred
        return batch_mean(F.softplus(-z))
    if gan_mode == "hinge":
        if for_discriminator:
            signed = pred - 1.0 if target_is_real else -pred - 1.0
            return -batch_mean(torch.clamp(signed, max=0.0))
        if not target_is_real:
            raise ValueError("the generator's hinge loss needs a real target")
        return -batch_mean(pred)
    if gan_mode == "wgangp":
        return -batch_mean(pred) if target_is_real else batch_mean(pred)
    raise NotImplementedError(f"gan mode {gan_mode} not implemented")


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return batch_mean(torch.abs(a.float() - b.float()))


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return batch_mean(torch.square(a.float() - b.float()))


def gram(x: torch.Tensor) -> torch.Tensor:
    """Gram matrix G = f f^T / (c*h*w), f = (B, C, H*W) (Pix2Pix.py:733-740).
    Input NCHW; output (B, C, C) in float32. A bf16 input is taken as float32
    copies: its products are exact there and sum in float32, as the JAX
    einsum's preferred_element_type=f32 does (a bf16 bmm would return bf16)."""
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
    (Pix2Pix.py:541-543).

    For bf16 f and t with 2 h w <= c (rank-deficient grams, larger than the
    features), the JAX package's Frobenius identity (gcc_tpu/losses.py:
    96-110): ||Gf - Gt||^2 = ||Kff||^2 - 2 ||Kft||^2 + ||Ktt||^2 with the
    (hw, hw) kernel matrices Kxy = x^T y, floored at 0, on float32 copies of
    the bf16 features. Every other case takes the direct grams."""
    b, c, h, w = f.shape
    n = h * w
    if f.dtype == torch.bfloat16 and t.dtype == torch.bfloat16 and 2 * n <= c:
        fr = f.float().reshape(b, c, n)
        tr = t.float().reshape(b, c, n)

        def sq_k(x, y):  # ||x^T y||_F^2 per sample
            return torch.bmm(x.transpose(1, 2), y).square().sum(dim=(1, 2))

        per = sq_k(fr, fr) - 2.0 * sq_k(fr, tr) + sq_k(tr, tr)
        m = batch_mean(per.clamp(min=0.0)) / (float(c) * n) ** 2 / (c * c)
        return torch.sqrt(torch.clamp(m, min=1e-12)) if use_sqrt else m
    return (sqrt_mse if use_sqrt else mse)(gram(f), gram(t))


def tv_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Total-variation loss (models/GANLoss.py:76-93), NCHW input."""
    b, c, h, w = x.shape
    count_h = (h - 1) * w * c
    count_w = h * (w - 1) * c
    h_tv = all_reduce_sum(torch.sum(torch.square(x[:, :, 1:, :]
                                                 - x[:, :, :-1, :])))
    w_tv = all_reduce_sum(torch.sum(torch.square(x[:, :, :, 1:]
                                                 - x[:, :, :, :-1])))
    return weight * 2.0 * (h_tv / count_h + w_tv / count_w) / global_batch(b)
