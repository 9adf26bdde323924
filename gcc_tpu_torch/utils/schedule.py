"""Epoch-based LR and EMA-beta schedules (copy of gcc_tpu/utils/schedule.py:19-102).

The reference steps torch schedulers once per epoch (utils/util.py:288-303);
the LR is a pure function of the epoch index, applied externally to each
step. scheduler.step() runs at the *end* of epoch e (train.py:172), so epoch
e trains with multiplier(e - 1). The stateful plateau policy is not part of
this slice.
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
    raise NotImplementedError(f"learning rate policy [{policy}] is not implemented")


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
