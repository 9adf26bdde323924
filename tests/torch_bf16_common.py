"""Helpers of the bf16 test files of SAGAN, CycleGAN and SRGAN
(tests/test_torch_bf16_{sagan,cyclegan,srgan}.py): the ratio rule of
tests/test_torch_bf16.py, the JAX-layout trees of a step's Adam first
moments, the test-only route of gcc_tpu's attention to its Pallas kernels,
and the fp32-only forwards of the layers that gained a bf16 path, which
hold the fp32 path to its old bits.

The ratio rule: a composed result is held to rms(port_bf16 - jax_bf16) <=
1/4 rms(jax_bf16 - fp32) for the same weights and batch, a single-rounding
layer to one bf16 ulp of gcc_tpu's bf16 output (ulp at the larger magnitude
of the two values).
"""

import contextlib
import copy

import numpy as np
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from gcc_tpu_torch.engines.common import arch_params, weight_params
from gcc_tpu_torch.utils.weights import export_jax_variables

BF = torch.bfloat16
# gcc_tpu's bf16 programs compiled to round where their source rounds
# (tests/test_torch_bf16.py's docstring)
EXACT = {"xla_allow_excess_precision": False}
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True, **EXACT}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def f32(a):
    """A JAX or torch array as float32 numpy, its layout kept."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def bf16_round(a):
    """float32 numpy values rounded to bf16, back as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF).float().numpy()


def rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def ratio(port, jbf, ref32):
    """rms(port - jax_bf16) / rms(jax_bf16 - fp32)."""
    return rms(np.asarray(port) - jbf) / rms(jbf - np.asarray(ref32))


def max_ulps(got, want):
    """max |got - want| in bf16 ulps at the larger magnitude of the two."""
    big = np.maximum(np.abs(got), np.abs(want)).astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 2.0 ** -126))) - 7)
    return float(np.max(np.abs(got.astype(np.float64) - want) / ulp))


def share_apart(got, want):
    return float(np.mean(np.asarray(got) != np.asarray(want)))


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def joint_ratio(port, jbf, ref32, keys):
    """The ratio rule over several results at once."""
    num = sum(np.sum(np.square(np.asarray(port[k], np.float64)
                               - np.asarray(jbf[k], np.float64))) for k in keys)
    den = sum(np.sum(np.square(np.asarray(jbf[k], np.float64)
                               - np.asarray(ref32[k], np.float64)))
              for k in keys)
    return float(np.sqrt(num / den))


def check_ratio(bounds, name, kind, net, got):
    """``got`` within ``bounds[(name, kind, net)]`` (1/4 unless named; None:
    finite only)."""
    bound = bounds.get((name, kind, net), 0.25)
    assert np.isfinite(got), f"{name} {kind} {net}: ratio {got}"
    if bound is not None:
        assert got <= bound, f"{name} {kind} {net}: ratio {got} > {bound}"


def jax_tree(net, values, collect=weight_params, coll="params"):
    """``values`` (one per ``collect(net)`` parameter) in the JAX layout of
    ``net``'s variables."""
    net = copy.deepcopy(net)
    with torch.no_grad():
        for p, v in zip(collect(net), values):
            p.copy_(v)
    return jax.tree_util.tree_map(np.asarray, export_jax_variables(net))[coll]


def arch_moments(net, opt):
    return jax_tree(net, opt.mu, arch_params, "arch")


def state_leaves(state):
    """Every net's parameters and buffers and every optimizer moment of a
    port state, by name, for a bit-for-bit comparison."""
    out = {}
    for n, net in state.nets.items():
        for k, t in net.state_dict().items():
            if isinstance(t, torch.Tensor):
                out[f"{n}.{k}"] = t
    for n, opt in state.opts.items():
        for i, t in enumerate(opt.mu):
            out[f"opt.{n}.mu.{i}"] = t
    return out


# ---------------------------------------------------------------------------
# gcc_tpu's attention through its Pallas kernels (test only)
# ---------------------------------------------------------------------------

class _TpuJax:
    """The jax module as gcc_tpu/ops/attention.py sees it under
    ``pallas_route``: its default backend reads "tpu"."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@contextlib.contextmanager
def pallas_route():
    """gcc_tpu's SelfAttention sends N >= its threshold to
    ops.pallas.attention.flash_attention, as on a TPU, the kernels in
    interpret mode with their default blocks (256, 512). Nothing in gcc_tpu
    changes: two module attributes are swapped for the block."""
    from gcc_tpu.ops import attention as jattn
    from gcc_tpu.ops.pallas import attention as jpallas

    fa = jpallas.flash_attention
    def interpret(q, k, v):
        return fa(q, k, v, jpallas.DEFAULT_BLOCK_Q, jpallas.DEFAULT_BLOCK_K,
                  True)

    old_jax = jattn.jax
    jattn.jax, jpallas.flash_attention = _TpuJax(), interpret
    try:
        yield
    finally:
        jattn.jax, jpallas.flash_attention = old_jax, fa


# ---------------------------------------------------------------------------
# the fp32-only code of the layers that gained a bf16 path
# ---------------------------------------------------------------------------

def _fp32_only_self_attention(self, x):
    from gcc_tpu_torch.ops.flash_attention import (
        attention_reference, flash_attention)
    b, c, h, w = x.shape
    q = self.query_conv(x).reshape(b, -1, h * w)
    k = self.key_conv(x).reshape(b, -1, h * w)
    v = self.value_conv(x).reshape(b, c, h * w)
    attend = flash_attention if h * w >= self.flash_threshold \
        else attention_reference
    return self.gamma * attend(q, k, v).reshape(b, c, h, w) + x


def _fp32_only_spectral_conv(self, x, update_stats=True):
    return F.conv2d(x, self.normalized_weight(update_stats), self.bias,
                    self.stride, self.padding)


def _fp32_only_spectral_conv_transpose(self, x, update_stats=True):
    return F.conv_transpose2d(x, self.normalized_weight(update_stats),
                              self.bias, self.stride, self.padding)


def _fp32_only_prelu(self, x):
    return torch.where(x >= 0, x, self.weight * x)


def _fp32_only_dense(self, x):
    return F.linear(x, self.weight, self.bias)


@torch.no_grad()
def _fp32_only_pool_query(self, images, generator):
    size = self.buffer.shape[0]
    if size == 0:
        return images
    out = []
    for img in images:
        if self.count < size:
            self.buffer[self.count].copy_(img)
            self.count += 1
            out.append(img)
            continue
        swap = float(torch.rand((), generator=generator)) > 0.5
        idx = int(torch.randint(size, (), generator=generator))
        if swap:
            out.append(self.buffer[idx].clone())
            self.buffer[idx].copy_(img)
        else:
            out.append(img)
    return torch.stack(out)


def _fp32_only_flash_backward(ctx, do):
    from gcc_tpu_torch.ops.flash_attention import attn_bwd
    q, k, v, o, lse = ctx.saved_tensors
    do = do.contiguous()
    delta = (do * o).sum(dim=1)
    return attn_bwd(q, k, v, do, lse, delta)


@contextlib.contextmanager
def fp32_only_forwards():
    """The block runs the fp32-only forwards (and B1's fp32-only backward)
    in place of today's, for the layers that gained a bf16 path."""
    from gcc_tpu_torch.ops import attention, flash_attention, layers, pool
    from gcc_tpu_torch.ops import spectral

    swaps = [(attention.SelfAttention, "forward", _fp32_only_self_attention),
             (spectral.SpectralConv, "forward", _fp32_only_spectral_conv),
             (spectral.SpectralConvTranspose, "forward",
              _fp32_only_spectral_conv_transpose),
             (layers.PReLU, "forward", _fp32_only_prelu),
             (layers.Dense, "forward", _fp32_only_dense),
             (pool.ReplayPool, "query", _fp32_only_pool_query),
             (flash_attention._FlashAttention, "backward",
              staticmethod(_fp32_only_flash_backward))]
    old = [(cls, name, cls.__dict__[name]) for cls, name, _ in swaps]
    for cls, name, fn in swaps:
        setattr(cls, name, fn)
    try:
        yield
    finally:
        for cls, name, fn in old:
            setattr(cls, name, fn)


def assert_same_bits(a: dict, b: dict):
    """Two dicts of tensors (or floats) equal key for key, bit for bit."""
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert np.float32(x).tobytes() == np.float32(y).tobytes(), k
