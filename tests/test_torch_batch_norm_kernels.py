"""The bf16 BatchNorm kernels (csrc/batch_norm_bf16.cu) against their plain
PyTorch versions (ops/batch_norm.py), on the card.

These tests need a CUDA device and nvcc; elsewhere they skip. The file
imports no JAX, so it runs on a machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_batch_norm_kernels.py

Shapes are the families' train-mode norms at a smaller batch: the U-Net
teacher's up_norm_1 (64 x 128^2) and innermost norms (512 x 2^2), the pruned
student's widths 50, 103 and 197, the PatchGAN's three norms at ndf 128 and
64 (31 x 31 planes, no multiple of 8, at 1024 and 512 channels), SAGAN's
four generator norms, SRResNet's and the SRGAN discriminator's. y and dx
within ``BF16_ULPS`` bf16 ulps of their largest value with at most
``BF16_SHARE`` of their elements apart, mean, invstd and the running
statistics within ``STAT_RTOL``, dw and db within ``GRAD_RTOL`` of their
largest value (the kernels sum in another order). Two calls give the same
bits; ``LAUNCHES`` counts the calls; inputs the kernels do not take raise;
fp32 and eval mode on the card run the layer's own code.
"""

import pytest

torch = pytest.importorskip("torch")

from gcc_tpu_torch.ops import batch_norm as bn  # noqa: E402
from gcc_tpu_torch.ops import kernels, layers  # noqa: E402

# (name, N, C, H, W)
SHAPES = [("unet_up_norm_1", 8, 64, 128, 128),
          ("unet_down_norm_6", 128, 512, 2, 2),
          ("student_50", 16, 50, 64, 64), ("student_103", 16, 103, 16, 16),
          ("student_197", 16, 197, 4, 4),
          ("patchgan128_norm_1", 8, 256, 64, 64),
          ("patchgan128_norm_2", 8, 512, 32, 32),
          ("patchgan128_norm_3", 8, 1024, 31, 31),
          ("patchgan64_norm_3", 16, 512, 31, 31),
          ("sagan_bn1", 64, 512, 4, 4), ("sagan_bn4", 64, 64, 32, 32),
          ("srresnet", 16, 64, 24, 24), ("srgan_d", 16, 128, 48, 48)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, N, C, H, W, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dev)

    x = rnd(N, C, H, W, scale=1.5, shift=0.3).to(torch.bfloat16)
    g = rnd(N, C, H, W, scale=0.01).to(torch.bfloat16)
    w, b = rnd(C, scale=0.02, shift=1.0), rnd(C)
    rm, rv = rnd(C, scale=0.5), rnd(C).abs() + 0.5
    return x, g, w, b, rm, rv


def _bf16_ok(got, ref):
    ulps, _, share = kernels.bf16_err(got, ref)
    assert got.dtype == torch.bfloat16 and ulps <= bn.BF16_ULPS and \
        share <= bn.BF16_SHARE, (ulps, share)


def _rel_ok(got, ref, rtol):
    tol = rtol * max(float(ref.abs().max()), 1e-30)
    assert float((got - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernels_match_plain(cuda, case):
    _, N, C, H, W = case
    x, g, w, b, rm, rv = _inputs(cuda, N, C, H, W)
    rm_k, rv_k, rm_p, rv_p = rm.clone(), rv.clone(), rm.clone(), rv.clone()
    before = dict(bn.LAUNCHES)
    y, mean, invstd = bn.bn_fwd(x, w, b, rm_k, rv_k)
    y_p, mean_p, invstd_p = bn.bn_fwd_plain(x, w, b, rm_p, rv_p)
    _bf16_ok(y, y_p)
    _rel_ok(mean, mean_p, bn.STAT_RTOL)
    _rel_ok(invstd, invstd_p, bn.STAT_RTOL)
    _rel_ok(rm_k, rm_p, bn.STAT_RTOL)
    _rel_ok(rv_k, rv_p, bn.STAT_RTOL)
    dx, dw, db = bn.bn_bwd(g, x, mean_p, invstd_p, w)
    dx_p, dw_p, db_p = bn.bn_bwd_plain(g, x, mean_p, invstd_p, w)
    _bf16_ok(dx, dx_p)
    _rel_ok(dw, dw_p, bn.GRAD_RTOL)
    _rel_ok(db, db_p, bn.GRAD_RTOL)
    assert {k: bn.LAUNCHES[k] - before[k] for k in before} == \
        {"bn_fwd_bf16": 1, "bn_bwd_bf16": 1}
    # no atomics: a second call gives the same bits
    again = bn.bn_fwd(x, w, b)
    assert all(torch.equal(a, c) for a, c in zip((y, mean, invstd), again))
    assert all(torch.equal(a, c) for a, c in zip(
        (dx, dw, db), bn.bn_bwd(g, x, mean_p, invstd_p, w)))


@pytest.mark.cuda
def test_what_is_not_asked_for_is_left_alone(cuda):
    x, g, w, b, rm, rv = _inputs(cuda, 4, 50, 31, 31)
    rm0, rv0 = rm.clone(), rv.clone()
    bn.bn_fwd(x, w, b)  # no running statistics: nothing moves
    assert torch.equal(rm, rm0) and torch.equal(rv, rv0)
    _, mean, invstd = bn.bn_fwd_plain(x, w, b)
    dx, dw, db = bn.bn_bwd(g, x, mean, invstd, w, True, False, False)
    assert dw is None and db is None
    _bf16_ok(dx, bn.bn_bwd_plain(g, x, mean, invstd, w)[0])
    dx, dw, db = bn.bn_bwd(g, x, mean, invstd, w, False, True, True)
    assert dx is None
    _rel_ok(dw, bn.bn_bwd_plain(g, x, mean, invstd, w)[1], bn.GRAD_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("update_stats", [True, False])
def test_the_layer_takes_the_kernels_in_bf16_training(cuda, update_stats):
    m = layers.BatchNorm(103)
    m.reset_parameters(torch.Generator().manual_seed(1))
    m.to(cuda)
    ref = layers.BatchNorm(103).to(cuda)
    ref.load_state_dict(m.state_dict())
    x, g = _inputs(cuda, 8, 103, 31, 31)[:2]
    # a view that starts off a 16-byte boundary: the layer copies it
    x_off = torch.cat([x.flatten(), x.flatten()[:1]])[1:].view_as(x)
    x_off.copy_(x)
    before = dict(bn.LAUNCHES)
    xk = x_off.detach().requires_grad_(True)
    y = m.train()(xk, update_stats)
    y.backward(g)
    assert {k: bn.LAUNCHES[k] - before[k] for k in before} == \
        {"bn_fwd_bf16": 1, "bn_bwd_bf16": 1}
    rm, rv = ref.running_mean.clone(), ref.running_var.clone()
    y_p, mean, invstd = bn.bn_fwd_plain(
        x, ref.weight.detach(), ref.bias.detach(),
        rm if update_stats else None, rv if update_stats else None)
    _bf16_ok(y, y_p)
    _rel_ok(m.running_mean, rm, bn.STAT_RTOL)
    _rel_ok(m.running_var, rv, bn.STAT_RTOL)
    if not update_stats:
        assert torch.equal(m.running_mean, ref.running_mean)
    dx_p, dw_p, db_p = bn.bn_bwd_plain(g, x, mean, invstd, ref.weight.detach())
    _bf16_ok(xk.grad, dx_p)
    _rel_ok(m.weight.grad, dw_p, bn.GRAD_RTOL)
    _rel_ok(m.bias.grad, db_p, bn.GRAD_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fp32_train", "bf16_eval"])
def test_fp32_and_eval_run_the_layers_code(cuda, mode):
    m = layers.BatchNorm(64)
    m.reset_parameters(torch.Generator().manual_seed(2))
    m.to(cuda)
    x = _inputs(cuda, 4, 64, 16, 16)[0]
    if mode == "fp32_train":
        x, mean = x.float(), x.float().mean(dim=(0, 2, 3))
        var = (x - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
        m.train()
    else:
        mean, var = m.running_mean, m.running_var
        m.eval()
    before = dict(bn.LAUNCHES)
    with torch.no_grad():
        y = m(x)
    inv = torch.rsqrt(var + m.eps) * m.weight
    ref = ((x.float() - mean[None, :, None, None]) * inv[None, :, None, None]
           + m.bias[None, :, None, None]).to(x.dtype)
    assert bn.LAUNCHES == before and torch.equal(y, ref)


@pytest.mark.cuda
def test_refused_inputs_raise(cuda):
    x, g, w, b, rm, rv = _inputs(cuda, 4, 50, 8, 8)
    with pytest.raises(ValueError):
        bn.bn_fwd(x.half(), w, b)
    with pytest.raises(ValueError):
        bn.bn_fwd(x.float(), w, b)
    with pytest.raises(ValueError):
        bn.bn_fwd(x.transpose(2, 3), w, b)
    with pytest.raises(ValueError, match="16-byte"):
        bn.bn_fwd(x.flatten()[1:1 + 4 * 50 * 7 * 9].view(4, 50, 7, 9), w, b)
    with pytest.raises(ValueError):
        bn.bn_fwd(x, w.to(torch.bfloat16), b)
    with pytest.raises(ValueError):
        bn.bn_fwd(x, w[:49], b)
    with pytest.raises(ValueError):
        bn.bn_fwd(x, w, b, rm)
    with pytest.raises(ValueError):
        bn.bn_fwd(x[0], w, b)
    _, mean, invstd = bn.bn_fwd(x, w, b)
    with pytest.raises(ValueError):
        bn.bn_bwd(g.float(), x, mean, invstd, w)
    with pytest.raises(ValueError):
        bn.bn_bwd(g, x, mean[:10], invstd, w)
