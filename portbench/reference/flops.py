"""Operations of the reference's work, counted once by
``torch.utils.flop_counter.FlopCounterMode`` on the meta device (shapes
only, nothing computed): one cooperative iteration at a batch, and one
student forward per image. The counts follow the configuration alone, so
a change to how the program computes does not move them. The counter
counts the products (convolutions forward and backward, the grams'
batched matmuls) at 2 operations a multiply-add.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import precision

META = torch.device("meta")


def meta_weights(specs):
    return {net: {k: torch.empty(shape, device=META)
                  for k, shape in spec.items()}
            for net, spec in specs.items()}


def iteration_flops(family, cfg: dict, batch: int, size: int) -> int:
    """Operations of one train step + arch step at ``batch``."""
    it = family.Iteration(cfg, meta_weights(family.specs(cfg)), 0,
                          precision.Exact(), META)
    x = [torch.empty(batch, 3, size, size, device=META) for _ in range(4)]
    h = cfg["hyper"]
    with FlopCounterMode(display=False) as counter:
        it(*x, h["lr"], 1.0, h["arch_lr"])
    return counter.get_total_flops()


def student_flops(family, cfg: dict, size: int) -> int:
    """Operations of the served student's forward on one image."""
    specs = family.specs(cfg)
    net = "g" if "g" in specs else "g_a"
    P = meta_weights({net: specs[net]})[net]
    x = torch.empty(1, 3, size, size, device=META)
    with FlopCounterMode(display=False) as counter:
        family.student(cfg, P, x, precision.Exact())
    return counter.get_total_flops()
