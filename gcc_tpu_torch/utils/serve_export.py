"""Serving export: pruned generators as self-contained ``torch.export``
artifacts (counterpart of gcc_tpu/utils/hlo_export.py, whose StableHLO
files are XLA's; the port writes ``.pt2`` programs).

``export_generator`` traces ``forward(x) = net(x)[0]`` of one generator into
a ``torch.export.ExportedProgram`` with the weights inside it. The saved
file loads and runs with ``torch.export.load(p).module()(x)``: neither this
package, nor the JAX package, nor the checkpoint is needed. One artifact
serves every batch size: the batch is one symbolic ``Dim``.

Portability rules of the exported program (hlo_export.py:8-17):
- No CUDA kernel of the port is in it. MobileResnet's fused blocks go off
  and every SelfAttention takes the einsum route (``portable``), as the JAX
  package forces its Pallas paths off in the artifact. The port binds its
  kernels through ctypes, which ``torch.export`` cannot trace, and an
  artifact that needed the package's ``.so`` files would not stand alone.
- One artifact serves the CPU and the card: ``load_exported(p, device)``
  moves a program traced on one device to the other
  (``torch.export.passes.move_to_device_pass``), the counterpart of the JAX
  package's multi-platform lowering.

Weight-only int8 (``weight_quant="int8"``): the program holds each conv,
transpose-conv and dense weight as int8 with per-output-channel fp32
scales, grouped exactly as the JAX package groups them, and dequantizes
``q.float() * s`` to the serving dtype inside the traced forward.
"""

from __future__ import annotations

import copy
import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from gcc_tpu_torch.models.generators import MobileResnetGenerator
from gcc_tpu_torch.ops.attention import SelfAttention
from gcc_tpu_torch.ops.layers import Conv, ConvTranspose, Dense
from gcc_tpu_torch.utils.weights import _CONV_PERM, _DECONV_PERM

DIRECTIONS = ("AtoB", "BtoA")
# the JAX Dense kernel (in, out) is the port's (out, in) transposed
_DENSE_PERM = (1, 0)
# torch specializes batch sizes 0 and 1, so a symbolic batch is traced at 2
_TRACE_BATCH = 2


def portable(net: nn.Module) -> nn.Module:
    """A copy of the generator with every CUDA-kernel path forced off
    (hlo_export.py:34-43): MobileResnet's fused blocks, and the flash route
    of every SelfAttention (its threshold raised to 2**31). The engine's
    own net is left as it is."""
    net = copy.deepcopy(net)
    for m in net.modules():
        if isinstance(m, MobileResnetGenerator):
            m.use_fused_blocks = False
        if isinstance(m, SelfAttention):
            m.flash_threshold = 2 ** 31
    return net


def pick_generator(engine, state, direction: str = "AtoB",
                   teacher: bool = False) -> Tuple[nn.Module, str]:
    """(net, key) of the requested generator, as the engines' generate
    dispatches (hlo_export.py:46-59). By capability: a state with
    per-direction generators (``g_a`` and ``g_b``) is CycleGAN-shaped, and
    its direction picks the side; every other engine has one ``g`` (and
    ``tg``). ``engine`` is taken for the JAX signature; the port's nets live
    in ``state``."""
    del engine
    if direction not in DIRECTIONS:
        raise ValueError(f"direction must be one of {DIRECTIONS}, got "
                         f"{direction!r}")
    prefix = "tg" if teacher else "g"
    key = prefix
    if "g_a" in state.nets and "g_b" in state.nets:
        key = f"{prefix}_{'a' if direction == 'AtoB' else 'b'}"
    if key not in state.nets:
        raise ValueError(f"the state holds no {key!r} generator (nets "
                         f"{sorted(state.nets)})")
    return state.nets[key], key


def example_input_shape(cfg) -> Tuple[int, ...]:
    """The family's serving input at batch 1, NCHW (hlo_export.py:62-72):
    SAGAN's z, SRGAN's low-resolution image, else a crop of input_nc
    channels."""
    if cfg.model == "sagan":
        return (1, cfg.z_dim)
    if cfg.model == "srgan":
        s = cfg.image_size // cfg.upscale_factor
        return (1, 3, s, s)
    return (1, getattr(cfg, "input_nc", 3), cfg.crop_size, cfg.crop_size)


def _jax_layout(module: nn.Module) -> Optional[Tuple[int, ...]]:
    """The permutation that takes a weight of ``module`` from the JAX layout
    to the port's (utils/weights.py), or None for a module without one."""
    if isinstance(module, Conv):  # spectral convs and depthwise too
        return _CONV_PERM
    if isinstance(module, ConvTranspose):
        return _DECONV_PERM
    if isinstance(module, Dense):
        return _DENSE_PERM
    return None


def quantize_int8(net: nn.Module) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Per-output-channel symmetric int8 weight-only quantization
    (hlo_export.py:75-117), in the port's layout.

    Every floating parameter with ndim >= 2 is quantized; 1-D and 0-D ones
    (norm affines, biases, SAGAN's gamma, PReLU's slope) and every buffer
    (running stats, spectral vectors) pass through. The channel is the JAX
    layout's last axis, mapped through the weight permutations of
    utils/weights.py: a conv's or a dense layer's output axis 0, a transpose
    conv's axis 1 of (I, O, kh, kw). The scale is max|w| / 127 over every
    other axis (a zero scale becomes 1), q = clip(round(w / s), -127, 127),
    both computed in numpy from the fp32 weights, as the JAX package does,
    so q and s are its bits. Returns {parameter name: (int8 q, fp32 s)},
    s broadcastable against q."""
    owners = dict(net.named_modules())
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    n_params = 0
    for name, p in net.named_parameters():
        n_params += 1
        if p.ndim < 2 or not p.is_floating_point():
            continue
        owner = owners[name.rpartition(".")[0]]
        perm = _jax_layout(owner)
        if perm is None or len(perm) != p.ndim:
            raise ValueError(f"{name}: no JAX layout for a {p.ndim}-d weight "
                             f"of {type(owner).__name__}")
        axis = perm.index(p.ndim - 1)
        axes = tuple(a for a in range(p.ndim) if a != axis)
        w32 = p.detach().cpu().numpy().astype(np.float32)
        s = np.max(np.abs(w32), axis=axes, keepdims=True) / 127.0
        s = np.where(s == 0, 1.0, s).astype(np.float32)
        q = np.clip(np.round(w32 / s), -127, 127).astype(np.int8)
        out[name] = (q, s)
    if n_params and not out:
        warnings.warn(
            "quantize_int8: no parameter was quantized (no floating weight "
            "with ndim >= 2 found) - the exported artifact will not shrink",
            stacklevel=2)
    return out


class _Serving(nn.Module):
    """forward(x) = net(x)[0]: the generated image without the features."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)[0]


class _Int8Serving(nn.Module):
    """The generator with its quantized weights held as int8 ``q`` and fp32
    ``s`` buffers, dequantized to ``dtype`` on every call. The net's own
    parameters of those names are removed, so no float copy of them is in
    the program."""

    def __init__(self, net: nn.Module,
                 quant: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.net, self.dtype, self.names = net, dtype, list(quant)
        for name, (q, s) in quant.items():
            owner, _, leaf = name.rpartition(".")
            del net.get_submodule(owner)._parameters[leaf]
            key = name.replace(".", "__")
            self.register_buffer(f"{key}__q", torch.from_numpy(q).to(device))
            self.register_buffer(f"{key}__s", torch.from_numpy(s).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights = {}
        for name in self.names:
            key = name.replace(".", "__")
            q, s = getattr(self, f"{key}__q"), getattr(self, f"{key}__s")
            weights[name] = (q.float() * s).to(self.dtype)
        return torch.func.functional_call(self.net, weights, (x,))[0]


def export_generator(engine, state, example_shape: Sequence[int], *,
                     direction: str = "AtoB", teacher: bool = False,
                     poly_batch: bool = True,
                     dtype: torch.dtype = torch.float32,
                     weight_quant: Optional[str] = None
                     ) -> torch.export.ExportedProgram:
    """One generator as a self-contained serving program
    (hlo_export.py:120-184), traced on the device its net lives on.

    ``example_shape`` includes the batch; with ``poly_batch`` the batch is
    the symbolic Dim "b" (from 1), else the example's batch is fixed. Every
    floating parameter and buffer of the portable copy is cast to ``dtype``,
    and the input spec is in ``dtype``. ``weight_quant="int8"`` quantizes
    from the net's fp32 weights before that cast (``quantize_int8``) and
    dequantizes inside the program. The copy runs in eval mode: running
    BatchNorm statistics, spectral vectors iterated but not stored, so the
    program mutates no buffer and the engine's state is left as it was."""
    if weight_quant not in (None, "none", "int8"):
        raise ValueError(f"unsupported weight_quant {weight_quant!r} "
                         f"(expected 'int8')")
    net, _ = pick_generator(engine, state, direction, teacher)
    device = next(iter(net.state_dict().values())).device
    net = portable(net).eval().requires_grad_(False)
    quant = quantize_int8(net) if weight_quant == "int8" else None
    net = net.to(dtype)  # floating parameters and buffers only
    serve = _Serving(net) if quant is None else \
        _Int8Serving(net, quant, dtype, device)
    shape = tuple(example_shape)
    if poly_batch:
        shape = (_TRACE_BATCH,) + shape[1:]
    x = torch.zeros(shape, dtype=dtype, device=device)
    dynamic = ({0: torch.export.Dim("b", min=1)},) if poly_batch else None
    return torch.export.export(serve.eval(), (x,), dynamic_shapes=dynamic)


def save_exported(ep: torch.export.ExportedProgram, path: str) -> int:
    """Write the program with ``torch.export.save``; returns its bytes."""
    torch.export.save(ep, path)
    return os.path.getsize(path)


def _program_device(ep: torch.export.ExportedProgram) -> torch.device:
    """The device the program's weights live on."""
    for t in list(ep.state_dict.values()) + list(ep.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def load_exported(path: str, device=None) -> nn.Module:
    """The saved program as a callable module, on ``device`` when given
    (moved there by ``move_to_device_pass`` if it was traced elsewhere),
    else where it was traced. A convenience: ``torch.export.load(path)
    .module()`` loads it without this package."""
    ep = torch.export.load(path)
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is "
                               f"unavailable")
        have = _program_device(ep)
        if have.type != device.type or (device.index is not None
                                        and have.index != device.index):
            from torch.export.passes import move_to_device_pass
            ep = move_to_device_pass(ep, device)
    return ep.module()
