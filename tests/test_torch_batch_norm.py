"""The plain versions of the bf16 BatchNorm kernels (ops/batch_norm.py)
against ``layers.BatchNorm``'s own bf16 code on the CPU, and the rule by
which ``layers.BatchNorm`` takes the kernels.

The forward repeats the layer's arithmetic op for op, so y, the running
statistics and the statistics it returns are the layer's bits. The backward
is the closed form of the layer's autograd graph: dx within one bf16 ulp of
its largest value with at most ``BF16_SHARE`` of its elements apart (both
round once from fp32 values computed in another order), the fp32 weight
gradients within ``GRAD_RTOL`` of their largest value. Shapes: widths 50,
103 and 197 (the pruned student's), planes of 4 (the U-Net's innermost
norms), 16, 64 and 961 (the PatchGAN's 31 x 31, no multiple of 8).

The rule: a train-mode bf16 batch on a card takes the kernels' wrapper; on
the CPU, in fp32, in eval mode, under a data-parallel mesh and under a
row-sharded view the layer runs its own code. A tensor subclass that says
it is on a card stands in for one here, with a spy in place of the wrapper.
"""

import pytest
import torch

from gcc_tpu_torch.ops import batch_norm as bn
from gcc_tpu_torch.ops import kernels, layers
from torch_limits import one_thread  # noqa: F401

SHAPES = [(4, 50, 2, 2), (2, 103, 31, 31), (3, 197, 4, 4), (2, 64, 8, 8),
          (5, 32, 16, 16)]


def _module(c, seed):
    m = layers.BatchNorm(c)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # running statistics away from their start
        m.running_mean.normal_(0.0, 0.5, generator=gen)
        m.running_var.uniform_(0.5, 2.0, generator=gen)
    return m.train()


def _batch(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * 1.5 + 0.3).to(torch.bfloat16)


@pytest.mark.parametrize("update_stats", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_is_the_layers_bf16_code(shape, update_stats):
    m = _module(shape[1], 1)
    x = _batch(shape, 2)
    rm, rv = m.running_mean.clone(), m.running_var.clone()
    with torch.no_grad():
        ref = m(x, update_stats)
        y, mean, invstd = bn.bn_fwd_plain(
            x, m.weight, m.bias, rm if update_stats else None,
            rv if update_stats else None, m.momentum, m.eps)
    assert y.dtype == torch.bfloat16 and torch.equal(y, ref)
    xf = x.float()
    assert torch.equal(mean, xf.mean(dim=(0, 2, 3)))
    var = xf.square().mean(dim=(0, 2, 3)) - mean.square()
    assert torch.equal(invstd, torch.rsqrt(var + m.eps))
    # the statistics against float64
    x64 = x.double()
    torch.testing.assert_close(mean.double(), x64.mean(dim=(0, 2, 3)),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(invstd.double(), torch.rsqrt(
        x64.var(dim=(0, 2, 3), unbiased=False) + m.eps), rtol=1e-5, atol=0)
    # the running statistics: the layer's bits, or untouched
    assert torch.equal(rm, m.running_mean) and torch.equal(rv, m.running_var)
    if not update_stats:
        assert torch.equal(rm, _module(shape[1], 1).running_mean)


def _layer_grads(m, x, g):
    xl = x.clone().requires_grad_(True)
    m.zero_grad()
    m(xl).backward(g)
    return xl.grad, m.weight.grad.clone(), m.bias.grad.clone()


def _close_bf16(got, ref):
    ulps, _, share = kernels.bf16_err(got, ref)
    assert got.dtype == torch.bfloat16 and ulps <= 1.0 and \
        share <= bn.BF16_SHARE, (ulps, share)


def _close_fp32(got, ref):
    tol = bn.GRAD_RTOL * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= tol


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_the_layers_autograd(shape):
    m = _module(shape[1], 3)
    x, g = _batch(shape, 4), _batch(shape, 5)
    dx_ref, dw_ref, db_ref = _layer_grads(m, x, g)
    with torch.no_grad():
        _, mean, invstd = bn.bn_fwd_plain(x, m.weight, m.bias)
        dx, dw, db = bn.bn_bwd_plain(g, x, mean, invstd, m.weight)
        none = bn.bn_bwd_plain(g, x, mean, invstd, m.weight, False, False,
                               False)
    _close_bf16(dx, dx_ref)
    _close_fp32(dw, dw_ref)
    _close_fp32(db, db_ref)
    assert none == (None, None, None)


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("shape", [(4, 50, 2, 2), (2, 103, 31, 31)])
def test_differentiable_form_on_the_cpu_is_the_layer(shape, frozen):
    """``batch_norm_train`` on CPU tensors (the plain versions inside its
    autograd Function) against the layer's own code: forward and running
    statistics bit for bit, gradients as above, no weight gradient where
    the weights are frozen, and no launch counted."""
    m, ours = _module(shape[1], 6), _module(shape[1], 6)
    m.weight.requires_grad_(not frozen)
    ours.weight.requires_grad_(not frozen)
    x, g = _batch(shape, 7), _batch(shape, 8)
    before = dict(bn.LAUNCHES)
    xl, xo = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    ref = m(xl)
    y = bn.batch_norm_train(xo, ours.weight, ours.bias, ours.running_mean,
                            ours.running_var, ours.momentum, ours.eps)
    assert torch.equal(y, ref)
    assert torch.equal(ours.running_mean, m.running_mean)
    assert torch.equal(ours.running_var, m.running_var)
    ref.backward(g)
    y.backward(g)
    _close_bf16(xo.grad, xl.grad)
    _close_fp32(ours.bias.grad, m.bias.grad)
    if frozen:
        assert ours.weight.grad is None
    else:
        _close_fp32(ours.weight.grad, m.weight.grad)
    assert bn.LAUNCHES == before


@pytest.mark.parametrize("shape", [(128, 64, 128, 128), (128, 1024, 31, 31),
                                   (128, 512, 2, 2), (16, 50, 64, 64),
                                   (2, 3, 4, 4)])
def test_the_split_fills_one_wave(shape):
    """The grid holds no more blocks than 132 SMs take at once, each block
    at least MIN_SLOTS slots where the channel has them, and the channels
    with few slots one block each."""
    N, C, H, W = shape
    S = bn.splits(N, C, H * W, 132)
    slots = N * bn.slots_a_plane(H * W)
    assert S >= 1 and (S == 1 or C * S <= bn.BLOCKS_AN_SM * 132)
    assert S == 1 or slots // S >= bn.MIN_SLOTS
    assert bn.slots_a_plane(961) == 121 and bn.slots_a_plane(4) == 2 \
        and bn.slots_a_plane(16384) == 2048


class OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a card."""

    @property
    def is_cuda(self):
        return True


class _Mesh:
    world = 1


@pytest.mark.parametrize("case", ["card", "cpu", "fp32", "eval", "mesh",
                                  "view", "view_eval"])
def test_which_code_the_layer_runs(monkeypatch, case):
    calls = []

    def spy(x, *args):
        calls.append(x)
        return torch.zeros_like(x)

    monkeypatch.setattr(bn, "batch_norm_train", spy)
    m = _module(50, 9)
    x = _batch((2, 50, 4, 4), 10)
    if case != "cpu":
        x = x.as_subclass(OnCard)
    if case == "fp32":
        x = x.float()
    if case in ("eval", "view_eval"):
        m.eval()
    if case == "mesh":
        monkeypatch.setattr(layers, "active", lambda: _Mesh())
        monkeypatch.setattr(layers, "all_reduce_sum", lambda t: t)
    if case.startswith("view"):
        monkeypatch.setattr(layers.spatial, "active", lambda: object())
    plain = _module(50, 9).train(m.training)
    with torch.no_grad():
        if case == "view":
            with pytest.raises(RuntimeError, match="eval only"):
                m(x)
            assert calls == []
            return
        y = m(x)
        if case == "card":
            assert len(calls) == 1 and calls[0] is x
            assert torch.equal(y, torch.zeros_like(x))
            return
        assert calls == []
        # the layer's own code: the plain layer's bits
        ref = plain(x.as_subclass(torch.Tensor))
    assert torch.equal(y.as_subclass(torch.Tensor), ref)
