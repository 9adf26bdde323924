"""What the cooperative iterations share, in plain PyTorch: Adam with the
LR given per step, the GAN losses, online distillation's content and gram
terms, the teacher-discrepancy EMA, and the dropout masks' seeds.

Everything is fp32. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Leaf = Tuple[str, str]  # (net, parameter name)


class Adam:
    """p -= lr * m_hat / (sqrt(v_hat) + eps) over a list of leaves; keeps
    the norm of each leaf's first gradient (what the first step's moments
    hold, divided by 1 - b1)."""

    def __init__(self, nets: Dict[str, Dict[str, torch.Tensor]],
                 leaves: Sequence[Leaf], b1: float, b2: float = 0.999,
                 eps: float = 1e-8):
        self.leaves, self.b1, self.b2, self.eps = list(leaves), b1, b2, eps
        self.count = 0
        params = [nets[n][k] for n, k in self.leaves]
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.first_grad_norms = None

    def params(self, nets) -> List[torch.Tensor]:
        return [nets[n][k] for n, k in self.leaves]

    @torch.no_grad()
    def step(self, nets, grads: Sequence[torch.Tensor], lr: float) -> None:
        self.count += 1
        if self.count == 1:
            self.first_grad_norms = torch.stack(
                [g.float().norm() for g in grads])
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params(nets), grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(lr * (mu / c1) / (torch.sqrt(nu / c2) + self.eps))


def grads_of(loss: torch.Tensor, params: Sequence[torch.Tensor]):
    """d loss / d params; zeros where the loss does not reach a leaf."""
    gs = torch.autograd.grad(loss, list(params), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, gs)]


def gan_loss(pred: torch.Tensor, real: bool, mode: str,
             for_d: bool = True) -> torch.Tensor:
    """models/GANLoss.py:38-59: lsgan is the MSE to the 1/0 label; hinge
    is mean(relu(1 -+ pred)) for D and -mean(pred) for G."""
    if mode == "lsgan":
        return torch.mean(torch.square(pred - (1.0 if real else 0.0)))
    if mode == "hinge":
        if for_d:
            return torch.mean(torch.relu(1.0 - pred if real else 1.0 + pred))
        return -torch.mean(pred)
    raise ValueError(f"gan mode {mode!r}")


def discrepancy(pred_fake: torch.Tensor, mode: str) -> torch.Tensor:
    """|G-side loss of a fake judged real - D-side loss of it judged fake|
    (Pix2Pix.py:489-511)."""
    return torch.abs(gan_loss(pred_fake, True, mode, False)
                     - gan_loss(pred_fake, False, mode, True))


def ema_update(prev: torch.Tensor, new: torch.Tensor, beta: float):
    """The first value is taken as is (prev 0 means unset)."""
    return torch.where(prev == 0.0, new, beta * new + (1.0 - beta) * prev)


def gram(f: torch.Tensor) -> torch.Tensor:
    b, c, h, w = f.shape
    flat = f.reshape(b, c, h * w)
    return torch.bmm(flat, flat.transpose(1, 2)) / (c * h * w)


def distill(feats, targets, use_sqrt: bool):
    """(content, gram) summed over feature pairs: sqrt(MSE) for pix2pix,
    MSE for CycleGAN (CycleGAN.py:513); targets detached."""
    def err(a, b):
        m = F.mse_loss(a, b)
        return torch.sqrt(torch.clamp(m, min=1e-12)) if use_sqrt else m
    content = gram_l = torch.zeros((), device=feats[0].device)
    for f, t in zip(feats, targets):
        t = t.detach()
        content = content + err(f, t)
        gram_l = gram_l + err(gram(f), gram(t))
    return content, gram_l


def l1(a, b):
    return torch.mean(torch.abs(a - b))


class MaskSeeds:
    """The dropout masks' source. One seed a net's forwards is drawn from a
    host generator seeded with the run's seed, as ``int(randint(2**62))``;
    a forward draws its keep masks (uniform >= 0.5) in order from a device
    generator seeded with it. On the meta device the masks are empty."""

    def __init__(self, seed: int):
        self.host = torch.Generator().manual_seed(seed)

    def next(self, device: torch.device):
        seed = int(torch.randint(2 ** 62, (), generator=self.host))

        def masks():
            if device.type == "meta":
                return lambda shape: torch.empty(shape, dtype=torch.bool,
                                                 device=device)
            gen = torch.Generator(device=device).manual_seed(seed)
            return lambda shape: torch.rand(shape, generator=gen,
                                            device=device) >= 0.5
        return masks
