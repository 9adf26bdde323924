"""Shared engine machinery (port of gcc_tpu/engines/common.py:38-327): the
engine state, discriminator pair forwards, Adam with an external LR,
sparsity gradient injection (with CycleGAN's heavy weighting), distillation
helpers and the discrepancy EMA (the replay pool is ops/pool.py).

The JAX engine's train step is a pure function of (params, batch); here the
nets are ``nn.Module``s updated in place. Gradients are taken with
``torch.autograd.grad`` over an explicit parameter list, which plays the
part of the JAX package's parameter partitions: nothing accumulates in
``.grad`` and no other net's parameters are touched.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from gcc_tpu_torch.losses import gan_loss, gram_pair_err, mse, sqrt_mse
from gcc_tpu_torch.ops.layers import BatchNorm, Conv, ConvTranspose, Dense
from gcc_tpu_torch.utils.weights import export_jax_variables, load_jax_variables


@dataclasses.dataclass
class GANState:
    """One engine's training state: nets (name -> module, updated in place),
    their Adam states, the teacher-discrepancy EMA scalars, the step, and
    the generator that seeds dropout masks (the JAX state's ``rng``)."""

    step: int
    nets: Dict[str, nn.Module]
    opts: Dict[str, "Adam"]
    ema: Dict[str, torch.Tensor]
    rng: Optional[torch.Generator] = None

    def state_dict(self) -> dict:
        """Everything a resumed run needs, as numpy arrays and ints: each
        net's parameters and buffers, every optimizer's moments and count,
        the EMA scalars, the step and the dropout generator's state."""
        return {
            "step": int(self.step),
            "nets": {k: {n: _host(t) for n, t in net.state_dict().items()}
                     for k, net in self.nets.items()},
            "opts": {k: o.state_dict() for k, o in self.opts.items()},
            "ema": {k: _host(v) for k, v in self.ema.items()},
            "rng": None if self.rng is None else _host(self.rng.get_state()),
        }

    def load_state_dict(self, sd: dict) -> None:
        """Restore ``state_dict()``'s output in place: the same tensors and
        optimizers take the saved values, so an engine built with the same
        flags continues exactly where the saved run stopped."""
        if set(sd["nets"]) != set(self.nets) \
                or set(sd["opts"]) != set(self.opts):
            raise ValueError(
                f"saved nets {sorted(sd['nets'])} / optimizers "
                f"{sorted(sd['opts'])} do not match this engine's "
                f"{sorted(self.nets)} / {sorted(self.opts)}")
        for k, net in self.nets.items():
            net.load_state_dict({n: torch.from_numpy(np.asarray(a))
                                 for n, a in sd["nets"][k].items()})
        for k, opt in self.opts.items():
            opt.load_state_dict(sd["opts"][k])
        dev = next(iter(self.ema.values())).device if self.ema else "cpu"
        self.ema = {k: torch.from_numpy(np.asarray(v)).to(dev)
                    for k, v in sd["ema"].items()}
        self.step = int(sd["step"])
        if self.rng is not None:
            self.rng.set_state(torch.from_numpy(np.asarray(sd["rng"])))


def _host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of a tensor, on the host."""
    return t.detach().cpu().numpy().copy()


def _load_into(dst: Sequence[torch.Tensor], src, name: str) -> None:
    if len(dst) != len(src):
        raise ValueError(f"{name}: {len(src)} saved tensors for {len(dst)}")
    with torch.no_grad():
        for d, s in zip(dst, src):
            s = torch.from_numpy(np.asarray(s))
            if tuple(s.shape) != tuple(d.shape):
                raise ValueError(f"{name}: saved shape {tuple(s.shape)} for "
                                 f"{tuple(d.shape)}")
            d.copy_(s)


@contextlib.contextmanager
def eval_mode(*nets: nn.Module):
    """The nets in eval mode for the block (running BatchNorm stats, no
    dropout, nothing updated), back in train mode after it; yields them."""
    for net in nets:
        net.eval()
    try:
        yield nets
    finally:
        for net in nets:
            net.train()


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
           fused: bool = False, update_stats: bool = True):
    """Discriminator forwards on an update's input pair.

    fused=False: the reference's two sequential train-mode forwards
    (models/Pix2Pix.py:464-477): per-half BatchNorm batches, running stats
    updated by each. fused=True (--fused_d_batch): one forward over the pair
    interleaved on a new axis 1 and flattened into the batch, so BatchNorm
    sees the mixed 2B batch (see PARITY.md); per-sample outputs otherwise
    identical. Returns (p_a, p_b, the captured features of x_b's forward);
    the fused forward's features are sliced to x_b's half.
    """
    if not fused:
        p_a, _ = net(x_a, update_stats)
        p_b, feats = net(x_b, update_stats)
        return p_a, p_b, feats
    n = x_a.shape[0]
    both = torch.stack([x_a, x_b], dim=1).reshape((2 * n,) + x_a.shape[1:])
    p, feats = net(both, update_stats)
    p = p.reshape((n, 2) + p.shape[1:])
    feats = [f.reshape((n, 2) + f.shape[1:])[:, 1] for f in feats]
    return p[:, 0], p[:, 1], feats


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

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": [_host(t) for t in self.mu],
                "nu": [_host(t) for t in self.nu]}

    def load_state_dict(self, sd: dict) -> None:
        _load_into(self.mu, sd["mu"], "Adam mu")
        _load_into(self.nu, sd["nu"], "Adam nu")
        self.count = int(sd["count"])


class DupAdam:
    """Adam over a group in which some parameters appear twice (port of
    gcc_tpu/engines/common.py:133-172).

    The reference's SAGAN optimizer scans add every SpectralNorm-wrapped conv
    and attention q/k/v conv twice to one param group (models/SAGAN.py:315-346),
    and torch.optim.Adam applies one update per occurrence with shared state:
    two steps with the same gradient, count +2. ``dup[i]`` marks such
    parameters: they take two steps of their own Adam, the others one step
    of a second Adam.
    """

    def __init__(self, params: Sequence[torch.Tensor], dup: Sequence[bool],
                 b1: float = 0.9, b2: float = 0.999):
        self.dup = list(dup)
        self.single = Adam(self._pick(params, False), b1, b2)
        self.double = Adam(self._pick(params, True), b1, b2)

    def _pick(self, xs, want: bool) -> list:
        return [x for x, d in zip(xs, self.dup) if d == want]

    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor], lr) -> None:
        self.single.step(self._pick(params, False), self._pick(grads, False),
                         lr)
        for _ in range(2):
            self.double.step(self._pick(params, True),
                             self._pick(grads, True), lr)

    def state_dict(self) -> dict:
        return {"single": self.single.state_dict(),
                "double": self.double.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.single.load_state_dict(sd["single"])
        self.double.load_state_dict(sd["double"])


def add_sign_sparsity(net: nn.Module, params: Sequence[torch.Tensor],
                      grads: List[torch.Tensor], lambda_weight: float,
                      lambda_scale: float, weight_scale_fn=None
                      ) -> List[torch.Tensor]:
    """grad += lambda * sign(w) on every conv and dense kernel (lambda_weight; the
    spectral convs subclass Conv/ConvTranspose, so their raw kernels count,
    as every JAX 'kernel' leaf does) and on the scales of norms named
    '*norm*'/'*bn*' (lambda_scale), for the entries of ``params`` that belong
    to ``net`` (models/Pix2Pix.py:554-563). ``weight_scale_fn`` of the
    kernel's JAX path ('up_0/kernel') multiplies lambda_weight: CycleGAN's
    heavy sparsity (CycleGAN.py:539-559)."""
    if lambda_weight <= 0.0 and lambda_scale <= 0.0:
        return grads
    lam = {}
    for name, m in net.named_modules():
        if lambda_weight > 0.0 and isinstance(m, (Conv, ConvTranspose,
                                                  Dense)):
            scale = 1.0 if weight_scale_fn is None else weight_scale_fn(
                f"{name.replace('.', '/')}/kernel")
            lam[id(m.weight)] = lambda_weight * scale
        elif lambda_scale > 0.0 and isinstance(m, BatchNorm) and (
                "norm" in name or "bn" in name):
            lam[id(m.weight)] = lambda_scale
    return [g + lam[id(p)] * torch.sign(p) if id(p) in lam else g
            for p, g in zip(params, grads)]


def cyclegan_heavy_sparsity(name: str) -> float:
    """1000x on the first upsample deconv, 2x on the stem, the first down and
    the second up conv (CycleGAN.py:245, 544-559); ``name`` is the kernel's
    JAX path."""
    if name.startswith("up_0/"):
        return 1000.0
    for prefix in ("conv_in/", "down_0/", "up_1/"):
        if name.startswith(prefix):
            return 2.0
    return 1.0


# ---------------------------------------------------------------------------
# Distillation (models/Pix2Pix.py:528-548)
# ---------------------------------------------------------------------------

def distill_losses(feats: Sequence[torch.Tensor],
                   targets: Sequence[torch.Tensor], use_sqrt: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Content + gram sums over paired features; targets are detached.
    pix2pix, SAGAN and SRGAN use sqrt(MSE), CycleGAN plain MSE
    (CycleGAN.py:513)."""
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


class CheckpointMixin:
    """The checkpoint contract of the JAX engines (engines/pix2pix.py:367-385,
    sagan.py:347-356; Pix2Pix.py:636-649): G and D in the JAX layout, the
    epoch, cfg = (filter_cfgs, channel_cfgs) and the metric."""

    def checkpoint_payload(self, state: GANState, epoch: int,
                           metric=None) -> dict:
        return {"G": export_jax_variables(state.nets["g"]),
                "D": export_jax_variables(state.nets["d"]),
                "epoch": epoch,
                "cfg": (self.filter_cfgs, getattr(self, "channel_cfgs", None)),
                "fid": metric}

    def load_net_params(self, state: GANState, ckpt: dict,
                        load_discriminator: bool = True) -> GANState:
        """The checkpoint's G (and D) written into the state's nets."""
        load_jax_variables(state.nets["g"], ckpt["G"])
        if load_discriminator and ckpt.get("D") is not None:
            load_jax_variables(state.nets["d"], ckpt["D"])
        return state
