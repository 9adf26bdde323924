"""Epoch-based LR and EMA-beta schedules (copy of gcc_tpu/utils/schedule.py).

The reference steps torch schedulers once per epoch (utils/util.py:288-303);
the LR is a pure function of the epoch index, applied externally to each
step. scheduler.step() runs at the *end* of epoch e (train.py:172), so epoch
e trains with multiplier(e - 1). The stateful plateau policy is ``Plateau``,
fed with the epoch-end metric by the train loop.
"""

from __future__ import annotations

import math


def _linear_lambda(steps: int, epoch_count: int, n_epochs: int,
                   n_epochs_decay: int) -> float:
    # torch LambdaLR lambda (utils/util.py:290-294): evaluated at epoch=steps
    return 1.0 - max(0, steps + epoch_count - n_epochs) / float(n_epochs_decay + 1)


def multiplier_after_steps(policy: str, steps: int, *, epoch_count: int = 1,
                           n_epochs: int = 100, n_epochs_decay: int = 150,
                           lr_decay_iters: int = 50) -> float:
    if policy == "linear":
        return _linear_lambda(steps, epoch_count, n_epochs, n_epochs_decay)
    if policy == "step":
        return 0.1 ** (steps // lr_decay_iters)
    if policy == "cosine":
        return 0.5 * (1.0 + math.cos(math.pi * steps / n_epochs))
    if policy == "plateau":
        raise ValueError(
            "plateau is stateful (metric-driven); use Plateau, which the "
            "train loop feeds with the epoch-end metric")
    raise NotImplementedError(f"learning rate policy [{policy}] is not implemented")


class Plateau:
    """ReduceLROnPlateau(mode='min', factor=0.2, threshold=0.01, patience=5)
    semantics, matching the torch scheduler the reference constructs
    (utils/util.py:297-298).

    The reference calls ``scheduler.step()`` with no metric
    (models/Pix2Pix.py:608-609), which raises in torch; here the train loop
    feeds the epoch-end eval metric (negated for maximize metrics so smaller
    is always better), as the JAX package does.

    torch details matched: rel threshold (better = m < best*(1-threshold)),
    best init +inf, cooldown 0, min_lr 0, lr update skipped when the change
    is below eps=1e-8.
    """

    def __init__(self, lr: float, factor: float = 0.2,
                 threshold: float = 0.01, patience: int = 5,
                 eps: float = 1e-8):
        self.lr = float(lr)
        self.factor = factor
        self.threshold = threshold
        self.patience = patience
        self.eps = eps
        self.best = math.inf
        self.num_bad = 0

    def step(self, metric: float) -> float:
        """Record one epoch-end metric (smaller = better); returns the LR to
        use from the NEXT epoch on (torch steps at epoch end)."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            new_lr = self.lr * self.factor
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.num_bad = 0
        return self.lr


def lr_for_epoch(cfg, epoch: int, base_lr: float = None) -> float:
    """LR in effect during 1-indexed training epoch ``epoch``."""
    base = cfg.lr if base_lr is None else base_lr
    steps = epoch - cfg.epoch_count  # schedulers stepped at end of each prior epoch
    mult = multiplier_after_steps(
        cfg.lr_policy, max(steps, 0), epoch_count=cfg.epoch_count,
        n_epochs=cfg.n_epochs, n_epochs_decay=cfg.n_epochs_decay,
        lr_decay_iters=cfg.lr_decay_iters)
    return base * mult


def ema_beta_for_epoch(cfg, epoch: int) -> float:
    """adaptive_ema_beta: 1 - epoch/total, updated at end of each epoch
    (models/Pix2Pix.py:602-604). Epoch e trains with the value set at the
    end of epoch e-1 (initially cfg.ema_beta)."""
    prev = epoch - 1
    if prev < cfg.epoch_count:
        return cfg.ema_beta
    return 1.0 - prev / (cfg.n_epochs + cfg.n_epochs_decay)
