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

The evaluator networks (``metrics/{inception,miou,vgg}.py``) carry the
reference's state-dict names instead; ``evaluator_state_dict`` and
``evaluator_tree`` map them to and from the JAX package's evaluator
parameter trees (what ``gcc_tpu.metrics.*.load_torch_*`` return), strictly
both ways:

  InceptionV3  <block>.<branch>.conv.weight OIHW  <-> <block>/<branch>/weight
               .bn.{weight, bias, running_mean, running_var}
                                       <-> bn_{scale, bias, mean, var}
  DRNSeg       base.0.0 / base.<l>.<3i> (conv-bn-relu stacks)
                                       <-> layer0_0 / layer<l>_<i>/conv, bn_*
               base.<l>.<b>.conv<j>, .bn<j>, .downsample.{0, 1}
                                       <-> layer<l>_<b>/conv<j>, bn<j>_*,
                                           down_conv, bn_down_*
               seg.{weight, bias}      <-> seg_kernel, seg_bias
  VGG19        conv_<idx>.{weight, bias} <-> conv_<idx>/{kernel, bias}
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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


# ------------------------------------------------------- evaluator weights

def read_state_dict(path) -> Dict[str, np.ndarray]:
    """A torch state dict as {key: numpy array}: a file saved by torch (read
    with ``weights_only=True``), an ``.npz`` of one, or an in-memory
    {key: array or tensor} mapping."""
    if isinstance(path, dict):
        items = path.items()
    elif str(path).endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    else:
        items = torch.load(path, map_location="cpu",
                           weights_only=True).items()
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in items}


def clean_state_dict(sd: Dict[str, np.ndarray], ignore: Iterable[str] = ()
                     ) -> Dict[str, np.ndarray]:
    """DataParallel's ``module.`` prefixes stripped; BatchNorm's
    ``num_batches_tracked`` counters and the keys in ``ignore`` dropped."""
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not k.endswith("num_batches_tracked") and k not in ignore:
            out[k] = v
    return out


_BN = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
       ("running_var", "var"))
Leaf = Tuple[str, Tuple[str, ...], bool]  # torch key, JAX path, is a kernel


def _conv_bn(torch_conv: str, torch_bn: str, path: Tuple[str, ...],
             conv_leaf: str, bn: str) -> List[Leaf]:
    return [(torch_conv, path + (conv_leaf,), True)] + [
        (f"{torch_bn}.{t}", path + (f"{bn}_{j}",), False) for t, j in _BN]


def _tree_drn_layers(tree: dict) -> Tuple[int, ...]:
    return tuple(sum(1 for k in tree if k.startswith(f"layer{li}_"))
                 for li in range(1, 9))


def _evaluator_leaves(kind: str, layers: Optional[Sequence[int]] = None
                     ) -> List[Leaf]:
    """Every tensor of one evaluator: (the port's and the reference's state
    dict key, the JAX tree path, whether it is a conv kernel)."""
    if kind == "inception":
        from gcc_tpu_torch.metrics.inception import (BasicConv2d,
                                                     FIDInceptionV3)
        leaves = []
        for name, m in FIDInceptionV3().named_modules():
            if isinstance(m, BasicConv2d):
                leaves += _conv_bn(f"{name}.conv.weight", f"{name}.bn",
                                   tuple(name.split(".")), "weight", "bn")
        return leaves
    if kind == "drn":
        from gcc_tpu_torch.metrics.miou import DRN_D_105_LAYERS
        ly = tuple(layers or DRN_D_105_LAYERS)
        leaves = _conv_bn("base.0.0.weight", "base.0.1", ("layer0_0",),
                          "conv", "bn")
        for li in (1, 2, 7, 8):
            for i in range(ly[li - 1]):
                leaves += _conv_bn(f"base.{li}.{3 * i}.weight",
                                   f"base.{li}.{3 * i + 1}",
                                   (f"layer{li}_{i}",), "conv", "bn")
        inplanes = 32
        for li in range(3, 7):
            planes = (64, 128, 256, 512)[li - 3]
            for b in range(ly[li - 1]):
                pre, node = f"base.{li}.{b}", (f"layer{li}_{b}",)
                for j in (1, 2, 3):
                    leaves += _conv_bn(f"{pre}.conv{j}.weight",
                                       f"{pre}.bn{j}", node, f"conv{j}",
                                       f"bn{j}")
                stride = 2 if li in (3, 4) else 1
                if b == 0 and (stride != 1 or inplanes != planes * 4):
                    leaves += _conv_bn(f"{pre}.downsample.0.weight",
                                       f"{pre}.downsample.1", node,
                                       "down_conv", "bn_down")
                inplanes = planes * 4
        return leaves + [("seg.weight", ("seg_kernel",), True),
                         ("seg.bias", ("seg_bias",), False)]
    if kind == "vgg":
        from gcc_tpu_torch.metrics.vgg import VGG19_CONV_IDX
        return [leaf for idx in VGG19_CONV_IDX for leaf in (
            (f"conv_{idx}.weight", (f"conv_{idx}", "kernel"), True),
            (f"conv_{idx}.bias", (f"conv_{idx}", "bias"), False))]
    raise ValueError(f"unknown evaluator {kind!r}")


def evaluator_state_dict(kind: str, tree: dict) -> Dict[str, np.ndarray]:
    """A JAX evaluator parameter tree as the port's state dict (numpy,
    OIHW kernels); every leaf is consumed and every tensor written."""
    layers = _tree_drn_layers(tree) if kind == "drn" else None
    sd = {}
    for key, path, kernel in _evaluator_leaves(kind, layers):
        try:
            leaf = np.asarray(_node(tree, ".".join(path)))
        except KeyError:
            raise ValueError(f"{kind}: the JAX tree has no "
                             f"{'/'.join(path)}") from None
        sd[key] = np.array(np.transpose(leaf, _CONV_PERM) if kernel
                           else leaf)
    if len(sd) != _count_leaves(tree):
        raise ValueError(f"{kind}: {len(sd)} of the JAX tree's "
                         f"{_count_leaves(tree)} leaves have a counterpart "
                         f"in the port")
    return sd


def evaluator_tree(kind: str, sd: Dict[str, np.ndarray]) -> dict:
    """The reverse: the port's (or the reference's) evaluator state dict as
    the JAX package's parameter tree (numpy, HWIO kernels)."""
    from gcc_tpu_torch.metrics.miou import infer_drn_layers
    sd = clean_state_dict({k: np.asarray(v) for k, v in sd.items()})
    layers = infer_drn_layers(sd) if kind == "drn" else None
    leaves = _evaluator_leaves(kind, layers)
    want = {key for key, _, _ in leaves}
    if set(sd) != want:
        raise ValueError(f"{kind}: missing {sorted(want - set(sd))[:5]}, "
                         f"unexpected {sorted(set(sd) - want)[:5]}")
    tree: dict = {}
    for key, path, kernel in leaves:
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(np.transpose(sd[key], _INV[_CONV_PERM])
                                  if kernel else sd[key])
    return tree
