"""Shared engine machinery (port of gcc_tpu/engines/common.py:38-321): the
engine state, discriminator pair forwards, Adam with an external LR,
sparsity gradient injection, distillation helpers and the discrepancy EMA.

The JAX engine's train step is a pure function of (params, batch); here the
nets are ``nn.Module``s updated in place. Gradients are taken with
``torch.autograd.grad`` over an explicit parameter list, which plays the
part of the JAX package's parameter partitions: nothing accumulates in
``.grad`` and no other net's parameters are touched.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from gcc_tpu_torch.losses import gan_loss, gram_pair_err, mse, sqrt_mse
from gcc_tpu_torch.ops.layers import BatchNorm, Conv, ConvTranspose


@dataclasses.dataclass
class GANState:
    """One engine's training state: nets (name -> module, updated in place),
    their Adam states, the teacher-discrepancy EMA scalars and the step."""

    step: int
    nets: Dict[str, nn.Module]
    opts: Dict[str, "Adam"]
    ema: Dict[str, torch.Tensor]


def weight_params(net: nn.Module) -> List[nn.Parameter]:
    """Every parameter except MaskGate alphas (the JAX 'params' collection)."""
    return [p for n, p in net.named_parameters() if not n.endswith("alpha")]


def arch_params(net: nn.Module) -> List[nn.Parameter]:
    """The MaskGate alphas (the JAX 'arch' collection)."""
    return [p for n, p in net.named_parameters() if n.endswith("alpha")]


def grads_of(loss: torch.Tensor, params: Sequence[torch.Tensor]
             ) -> List[torch.Tensor]:
    """d loss / d params; a parameter the loss does not reach gets zeros,
    as jax.grad gives."""
    gs = torch.autograd.grad(loss, list(params), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]


def d_pair(net: nn.Module, x_a: torch.Tensor, x_b: torch.Tensor,
           fused: bool = False, update_stats: bool = True
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Discriminator forwards on an update's (fake, real) input pair.

    fused=False: the reference's two sequential train-mode forwards
    (models/Pix2Pix.py:464-477): per-half BatchNorm batches, running stats
    updated by each. fused=True (--fused_d_batch): one forward over the pair
    interleaved on a new axis 1 and flattened into the batch, so BatchNorm
    sees the mixed 2B batch (see PARITY.md); per-sample outputs otherwise
    identical. Returns (p_a, p_b).
    """
    if not fused:
        p_a, _ = net(x_a, update_stats)
        p_b, _ = net(x_b, update_stats)
        return p_a, p_b
    n = x_a.shape[0]
    both = torch.stack([x_a, x_b], dim=1).reshape((2 * n,) + x_a.shape[1:])
    p, _ = net(both, update_stats)
    p = p.reshape((n, 2) + p.shape[1:])
    return p[:, 0], p[:, 1]


# ---------------------------------------------------------------------------
# Optimization
# ---------------------------------------------------------------------------

class Adam:
    """Adam direction with the LR applied per step (torch-equivalent; the
    JAX package's optax.scale_by_adam(b1, b2, eps=1e-8) then p - lr*u), so
    epoch schedules need no optimizer rebuild (utils/util.py:288-303)."""

    def __init__(self, params: Sequence[torch.Tensor], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor], lr) -> None:
        """p -= lr * m_hat / (sqrt(v_hat) + eps), in place."""
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(lr * (mu / c1) / (torch.sqrt(nu / c2) + self.eps))


def add_sign_sparsity(net: nn.Module, params: Sequence[torch.Tensor],
                      grads: List[torch.Tensor], lambda_weight: float,
                      lambda_scale: float) -> List[torch.Tensor]:
    """grad += lambda * sign(w) on conv kernels (lambda_weight) and on the
    scales of norms named '*norm*'/'*bn*' (lambda_scale), for the entries
    of ``params`` that belong to ``net`` (models/Pix2Pix.py:554-563)."""
    if lambda_weight <= 0.0 and lambda_scale <= 0.0:
        return grads
    lam = {}
    for name, m in net.named_modules():
        if lambda_weight > 0.0 and isinstance(m, (Conv, ConvTranspose)):
            lam[id(m.weight)] = lambda_weight
        elif lambda_scale > 0.0 and isinstance(m, BatchNorm) and (
                "norm" in name or "bn" in name):
            lam[id(m.weight)] = lambda_scale
    return [g + lam[id(p)] * torch.sign(p) if id(p) in lam else g
            for p, g in zip(params, grads)]


# ---------------------------------------------------------------------------
# Distillation (models/Pix2Pix.py:528-548)
# ---------------------------------------------------------------------------

def distill_losses(feats: Sequence[torch.Tensor],
                   targets: Sequence[torch.Tensor], use_sqrt: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Content + gram sums over paired features; targets are detached.
    pix2pix uses sqrt(MSE)."""
    err = sqrt_mse if use_sqrt else mse
    content = feats[0].new_zeros(())
    gram_l = feats[0].new_zeros(())
    for f, t in zip(feats, targets):
        t = t.detach()
        content = content + err(f, t)
        gram_l = gram_l + gram_pair_err(f, t, use_sqrt)
    return content, gram_l


# ---------------------------------------------------------------------------
# Teacher discrepancy EMA (models/Pix2Pix.py:489-511)
# ---------------------------------------------------------------------------

def discrepancy(pred_fake: torch.Tensor, gan_mode: str) -> torch.Tensor:
    """|GANLoss(pred_fake, True, G-side) - GANLoss(pred_fake, False, D-side)|."""
    fake_real = gan_loss(pred_fake, True, gan_mode, for_discriminator=False)
    fake = gan_loss(pred_fake, False, gan_mode, for_discriminator=True)
    return torch.abs(fake_real - fake)


def ema_update(prev: torch.Tensor, new: torch.Tensor, beta) -> torch.Tensor:
    """EMA with first-call bootstrap: prev == 0 means uninitialised — the
    reference's own semantics (models/Pix2Pix.py:504-508)."""
    return torch.where(prev == 0.0, new, beta * new + (1.0 - beta) * prev)


class CombinedStepMixin:
    """The cooperative train step followed by the darts arch step, as the
    reference runs them per iteration (train.py:144-151)."""

    def train_arch_step(self, state: GANState, batch, val_batch, lr: float,
                        ema_beta: float, arch_lr: Optional[float] = None):
        state, m = self.train_step(state, batch, lr)
        state, am = self.arch_step(state, val_batch, ema_beta, arch_lr)
        return state, {**m, **am}
