"""Weights and inputs made from the run's seed, on the device, in a few
large calls: one normal draw for every parameter of a cell, sliced and
scaled to each parameter's initialiser (GCC utils/util.py:266-283: convs
N(0, 0.02), BatchNorm scales N(1, 0.02) and shifts N(0, 1), conv biases 0,
mask alphas 1), and each input ring as one uniform draw in [-1, 1).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Spec = Dict[str, Dict[str, Tuple[int, ...]]]


def _init(name: str, z: torch.Tensor) -> torch.Tensor:
    if name.endswith(".alpha"):
        return torch.ones_like(z)
    if "norm" in name.rpartition(".")[0]:
        return 1.0 + 0.02 * z if name.endswith(".weight") else z.clone()
    if name.endswith(".bias"):
        return torch.zeros_like(z)
    return 0.02 * z


def make(specs: Spec, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: {name: fp32 tensor}} for every net of ``specs``."""
    total = sum(_numel(s) for spec in specs.values() for s in spec.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for net, spec in specs.items():
        out[net] = {}
        for name, shape in spec.items():
            n = _numel(shape)
            out[net][name] = _init(name, z[at:at + n].view(shape))
            at += n
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def load(modules: Dict[str, torch.nn.Module],
         weights: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """Copy the weights into the program's modules by name. Raises unless
    every module that has parameters is in ``weights`` with exactly its
    names and shapes: the program builds what the configuration states."""
    for net, module in modules.items():
        have = {k: tuple(p.shape) for k, p in module.named_parameters()}
        if not have:
            continue
        want = {k: tuple(t.shape) for k, t in weights.get(net, {}).items()}
        if have != want:
            diff = sorted(set(have.items()) ^ set(want.items()))[:6]
            raise RuntimeError(f"net {net}: the program's parameters differ "
                               f"from the configuration's: {diff}")
        with torch.no_grad():
            for k, p in module.named_parameters():
                p.copy_(weights[net][k])


def ring(n: int, shape, seed: int, device, dtype) -> torch.Tensor:
    """n input tensors of ``shape`` stacked, uniform in [-1, 1), made in
    fp32 from a generator seeded apart from the weights' and cast to the
    program's compute dtype."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    x = torch.rand((n,) + tuple(shape), generator=gen, device=device)
    return (x * 2 - 1).to(dtype)
