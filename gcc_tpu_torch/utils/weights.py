"""Weights carried across between the JAX package's engine state and the port.

The JAX engine keeps each net as a tree of numpy-convertible arrays,
``{"params": ..., "batch_stats": ..., "arch": ...}``, keyed by Flax module
names. The port's submodules carry the same names, so a module at
``block_3_sep1.depthwise`` reads the JAX node ``block_3_sep1/depthwise``.
Layouts (as in gcc_tpu/utils/torch_export.py:27-41):

  conv kernel HWIO (kh, kw, I/groups, O)   -> OIHW:               (3, 2, 0, 1)
    (the depthwise (3, 3, 1, C) becomes (C, 1, 3, 3) by the same rule)
  transpose-conv kernel HWIO (kh, kw, I, O) -> ConvTranspose2d (I, O, kh, kw):
                                                                   (2, 3, 0, 1)
  BatchNorm params{scale, bias} + batch_stats{mean, var}
                                -> weight, bias, running_mean, running_var
  MaskGate arch{alpha}          -> alpha
  SpectralConv / SpectralConvTranspose: the kernel and bias as above, plus
    spectral{u, v}              -> u, v (the port iterates in the JAX
                                   matricization's order: no permutation)
  SelfAttention params{gamma}   -> gamma (a scalar; q/k/v are plain convs)
  PReLU params{alpha}           -> weight (a scalar)
  Dense kernel (in, out)        -> weight (out, in)
  a replay pool {buffer (P, H, W, C), count}
                                -> ReplayPool buffer (P, C, H, W), count

Both directions are strict: every leaf of the JAX tree is consumed and every
tensor of the port is written.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from gcc_tpu_torch.ops.attention import SelfAttention
from gcc_tpu_torch.ops.layers import BatchNorm, Conv, ConvTranspose, Dense, PReLU
from gcc_tpu_torch.ops.mask import MaskGate
from gcc_tpu_torch.ops.pool import ReplayPool
from gcc_tpu_torch.ops.spectral import SpectralNormed

_CONV_PERM = (3, 2, 0, 1)
_DECONV_PERM = (2, 3, 0, 1)
_INV = {_CONV_PERM: (2, 3, 1, 0), _DECONV_PERM: (2, 3, 0, 1)}


def _node(tree: dict, name: str) -> dict:
    for key in name.split(".") if name else []:
        tree = tree[key]
    return tree


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def _copy(dst: torch.Tensor, src, name: str) -> None:
    src = np.asarray(src, dtype=np.float32)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX shape {src.shape} does not fit "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(src)))


def load_jax_variables(net: nn.Module, variables: Dict[str, dict]) -> None:
    """Write one JAX net's variables into ``net`` in place."""
    if isinstance(net, ReplayPool):
        if set(variables) != {"buffer", "count"}:
            raise ValueError(f"a replay pool holds buffer and count, not "
                             f"{sorted(variables)}")
        _copy(net.buffer, np.transpose(np.asarray(variables["buffer"]),
                                       (0, 3, 1, 2)), "pool.buffer")
        net.count = int(np.asarray(variables["count"]))
        return
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    arch = variables.get("arch", {})
    spectral = variables.get("spectral", {})
    used = 0
    for name, m in net.named_modules():
        if isinstance(m, (Conv, ConvTranspose)):
            node = _node(params, name)
            perm = _CONV_PERM if isinstance(m, Conv) else _DECONV_PERM
            _copy(m.weight, np.transpose(np.asarray(node["kernel"]), perm),
                  f"{name}.weight")
            used += 1
            if m.bias is not None:
                _copy(m.bias, node["bias"], f"{name}.bias")
                used += 1
            if isinstance(m, SpectralNormed):
                st = _node(spectral, name)
                _copy(m.u, st["u"], f"{name}.u")
                _copy(m.v, st["v"], f"{name}.v")
                used += 2
        elif isinstance(m, Dense):
            node = _node(params, name)
            _copy(m.weight, np.transpose(np.asarray(node["kernel"])),
                  f"{name}.weight")
            used += 1
            if m.bias is not None:
                _copy(m.bias, node["bias"], f"{name}.bias")
                used += 1
        elif isinstance(m, SelfAttention):
            _copy(m.gamma, _node(params, name)["gamma"], f"{name}.gamma")
            used += 1
        elif isinstance(m, PReLU):
            _copy(m.weight, _node(params, name)["alpha"], f"{name}.weight")
            used += 1
        elif isinstance(m, BatchNorm):
            node, st = _node(params, name), _node(stats, name)
            _copy(m.weight, node["scale"], f"{name}.weight")
            _copy(m.bias, node["bias"], f"{name}.bias")
            _copy(m.running_mean, st["mean"], f"{name}.running_mean")
            _copy(m.running_var, st["var"], f"{name}.running_var")
            used += 4
        elif isinstance(m, MaskGate):
            _copy(m.alpha, _node(arch, name)["alpha"], f"{name}.alpha")
            used += 1
    total = sum(_count_leaves(v) for v in variables.values())
    if used != total:
        raise ValueError(f"{type(net).__name__}: {used} of the JAX tree's "
                         f"{total} leaves have a counterpart in the port")


def export_jax_variables(net: nn.Module) -> Dict[str, dict]:
    """The JAX-layout variables of one port net, as numpy arrays."""
    if isinstance(net, ReplayPool):
        return {"buffer": np.transpose(net.buffer.detach().cpu().numpy(),
                                       (0, 2, 3, 1)).copy(),
                "count": np.int32(net.count)}
    out: Dict[str, dict] = {}

    def put(coll: str, name: str, leaf: str, t: torch.Tensor, perm=None):
        node = out.setdefault(coll, {})
        for key in name.split(".") if name else []:
            node = node.setdefault(key, {})
        a = t.detach().cpu().numpy()  # shares memory with a CPU tensor
        node[leaf] = (np.transpose(a, _INV[perm]) if perm else a).copy()

    for name, m in net.named_modules():
        if isinstance(m, (Conv, ConvTranspose)):
            perm = _CONV_PERM if isinstance(m, Conv) else _DECONV_PERM
            put("params", name, "kernel", m.weight, perm)
            if m.bias is not None:
                put("params", name, "bias", m.bias)
            if isinstance(m, SpectralNormed):
                put("spectral", name, "u", m.u)
                put("spectral", name, "v", m.v)
        elif isinstance(m, Dense):
            put("params", name, "kernel", m.weight.t())
            if m.bias is not None:
                put("params", name, "bias", m.bias)
        elif isinstance(m, SelfAttention):
            put("params", name, "gamma", m.gamma)
        elif isinstance(m, PReLU):
            put("params", name, "alpha", m.weight)
        elif isinstance(m, BatchNorm):
            put("params", name, "scale", m.weight)
            put("params", name, "bias", m.bias)
            put("batch_stats", name, "mean", m.running_mean)
            put("batch_stats", name, "var", m.running_var)
        elif isinstance(m, MaskGate):
            put("arch", name, "alpha", m.alpha)
    return out


def from_jax_nets(engine, nets: Dict[str, Dict[str, dict]]):
    """The port's step-0 engine state holding the JAX engine's ``state.nets``."""
    ported = engine.build_nets()
    if set(ported) != set(nets):
        raise ValueError(f"nets {sorted(nets)} do not match the engine's "
                         f"{sorted(ported)}")
    for key, net in ported.items():
        load_jax_variables(net, nets[key])
    return engine.state_for({k: v.to(engine.device).train()
                             for k, v in ported.items()})


def to_jax_nets(state) -> Dict[str, Dict[str, dict]]:
    """The reverse mapping: the port state's nets as a JAX ``state.nets``."""
    return {k: export_jax_variables(v) for k, v in state.nets.items()}
