"""The port's fused MobileResnet stage against the JAX package's Pallas stage.

On the CPU the port's ``fused_sep_stage`` runs its kernels' plain versions
(forward, and the backward split as the TPU kernels split it: relu + IN2 +
pointwise, then IN1 + depthwise + reflect-pad adjoint). It is held against
gcc_tpu.ops.pallas.mobile_block.fused_sep_stage in interpret mode on the same
numpy inputs (NHWC for JAX, NCHW for the port), with the bounds of
tests/test_mobile_block.py: 2e-5 forward, 3e-5 * max(|ref|, 1) for each
gradient (fp32; the Pallas stage takes one-pass InstanceNorm statistics, the
port two-pass). The kernels themselves are held against these plain versions
on the card (tests/test_torch_kernels.py, chip_smoke.py). test_pw_precision
holds the precision argument of the forward's split-TF32 tensor-core
product: plain TF32 operands would miss b-hat's bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.ops.pallas.mobile_block import fused_sep_stage as jax_stage  # noqa: E402
from gcc_tpu_torch.models import generators  # noqa: E402
from gcc_tpu_torch.models.generators import MobileResnetGenerator  # noqa: E402
from gcc_tpu_torch.ops import mobile_block as mb  # noqa: E402
from gcc_tpu_torch.ops.layers import init_params  # noqa: E402
from torch_tf32 import mma_partial  # noqa: E402


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


# (B, H, W, C, M, relu, residual): the cases of tests/test_mobile_block.py,
# a non-square plane, and the smallest plane the pad adjoint allows
STAGE_CASES = {
    "relu": (2, 8, 8, 5, 7, True, False),
    "residual": (2, 8, 8, 5, 7, False, True),
    "nonsquare_8x12": (2, 8, 12, 5, 7, True, True),
    "min_5x5": (1, 5, 5, 3, 4, False, True),
}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_stage_forward_and_grads(case):
    B, H, W, C, M, relu, with_res = STAGE_CASES[case]
    R = np.random.RandomState(0)
    x = R.randn(B, H, W, C).astype(np.float32)
    dwk = (R.randn(3, 3, 1, C) * 0.2).astype(np.float32)
    pwk = (R.randn(1, 1, C, M) * 0.2).astype(np.float32)
    res = R.randn(B, H, W, M).astype(np.float32) if with_res else None
    w = np.cos(np.arange(B * H * W * M, dtype=np.float32)).reshape(B, H, W, M)

    jargs = [jnp.asarray(a) for a in (x, dwk, pwk)] + (
        [jnp.asarray(res)] if with_res else [])

    def jloss(*a):
        r = a[3] if with_res else None
        return jnp.sum(jax_stage(a[0], a[1], a[2], r, relu) * w)

    jy = jax_stage(*jargs[:3], jargs[3] if with_res else None, relu)
    jgrads = jax.grad(jloss, argnums=tuple(range(len(jargs))))(*jargs)

    tx = nchw(x).requires_grad_(True)
    tdw = torch.from_numpy(np.ascontiguousarray(
        np.transpose(dwk, (3, 2, 0, 1)))).requires_grad_(True)
    tpw = torch.from_numpy(np.ascontiguousarray(
        np.transpose(pwk, (3, 2, 0, 1)))).requires_grad_(True)
    tres = nchw(res).requires_grad_(True) if with_res else None
    biases = [torch.full((C,), 0.3, requires_grad=True),
              torch.full((M,), -0.2, requires_grad=True)]
    ty = mb.fused_sep_stage(tx, tdw, tpw, tres, relu, *biases)
    np.testing.assert_allclose(nhwc(ty), np.asarray(jy), atol=2e-5, rtol=2e-5)

    inputs = [tx, tdw, tpw] + ([tres] if with_res else []) + biases
    tgrads = torch.autograd.grad((ty * nchw(w)).sum(), inputs)
    ported = [nhwc(tgrads[0]),
              np.transpose(tgrads[1].numpy(), (2, 3, 1, 0)),
              np.transpose(tgrads[2].numpy(), (2, 3, 1, 0))]
    if with_res:
        ported.append(nhwc(tgrads[3]))
    for name, a, b in zip(["gx", "gdw", "gpw", "gres"], ported, jgrads):
        scale = max(float(np.max(np.abs(b))), 1.0)
        np.testing.assert_allclose(a, np.asarray(b), atol=3e-5 * scale,
                                   err_msg=f"{case}: {name} diverged")
    # the inert biases get exact zero gradients, as on the TPU path
    for g in tgrads[-2:]:
        assert float(g.abs().max()) == 0.0


@pytest.mark.parametrize("mode", ["split", "tf32"])
@pytest.mark.parametrize("C,M", [(256, 256), (112, 72), (72, 112)],
                         ids=["teacher", "student_112_72", "student_72_112"])
def test_pw_precision(C, M, mode):
    """The stage forward's pointwise product b = pw . a-hat (64x64 plane,
    a-hat unit-normal, pw at scale 0.2 as chip_smoke.py draws it), then IN,
    emulated as pw_gemm_kernel computes it: per k step of 8, the mma
    products of the operands (split-TF32: lo*hi, hi*lo, hi*hi; or plain
    TF32) into a zeroed accumulator that rounds toward zero after each mma,
    added to b in fp32. Split-TF32 holds b-hat within half the port's bound
    of 1e-4 against float64; plain TF32 misses it at the teacher's and the
    student's widths."""
    R = np.random.RandomState(0)
    a = torch.from_numpy(R.randn(C, 4096).astype(np.float32))
    a = (a - a.mean(-1, keepdim=True)) / a.std(-1, keepdim=True)
    w = torch.from_numpy((R.randn(M, C) * 0.2).astype(np.float32))

    def inorm(b):
        b = b - b.mean(-1, keepdim=True)
        return b / torch.sqrt(b.square().mean(-1, keepdim=True) + mb.EPS)

    b = torch.zeros(M, 4096)
    for k0 in range(0, C, 8):
        b = b + mma_partial(w[:, k0:k0 + 8], a[k0:k0 + 8], mode)
    err = float((inorm(b.double()) - inorm(w.double() @ a.double())).abs().max())
    if mode == "tf32":
        assert err > 1e-4, f"plain TF32 err {err} within 1e-4"
    else:
        assert err < 0.5e-4, f"split-TF32 err {err}"


def _held(err, ref, mode):
    """Split-TF32 holds half the gradients' bound 1e-4 max(|ref|, 1);
    plain TF32 misses the whole bound."""
    tol = 1e-4 * max(float(ref.abs().max()), 1.0)
    if mode == "tf32":
        assert err > tol, f"plain TF32 err {err} within {tol}"
    else:
        assert err < 0.5 * tol, f"split-TF32 err {err} against {tol}"


@pytest.mark.parametrize("mode", ["split", "tf32"])
@pytest.mark.parametrize("C,M", [(256, 256), (112, 72), (72, 112)],
                         ids=["teacher", "student_112_72", "student_72_112"])
def test_pw_grad_input_precision(C, M, mode):
    """The backward's d a-hat = pw^T . gb (K = M; a 64x64 plane, pw at scale
    0.2, gb unit-normal), emulated as pw_gemm_kernel<1,0> computes it: per
    k step of 8, the mma products into a zeroed, truncating fragment, added
    in fp32."""
    R = np.random.RandomState(1)
    wt = torch.from_numpy((R.randn(M, C) * 0.2).astype(np.float32)).t()
    gb = torch.from_numpy(R.randn(M, 4096).astype(np.float32))
    got = torch.zeros(C, 4096)
    for k0 in range(0, M, 8):
        got = got + mma_partial(wt[:, k0:k0 + 8], gb[k0:k0 + 8], mode)
    ref = wt.double() @ gb.double()
    _held(float((got.double() - ref).abs().max()), ref, mode)


@pytest.mark.parametrize("mode", ["split", "tf32"])
def test_pw_grad_weight_precision(mode):
    """The backward's dW = sum_b gb[b] . a-hat[b]^T over 4 samples of 64x64
    (K = 4 * 4096) at M = C = 64 (the error grows with K, not the width), gb
    at scale 0.05 and a-hat unit-normal, emulated as pw_gemm_kernel<0,1> and
    sum_partials_kernel compute it: one partial per (sample, chunk of 64
    pixels, the kernel library's split of this shape on 132 SMs), each the
    fp32 sum of per-k-step truncating fragments; the partials summed in 8
    contiguous ranges, then in order."""
    R = np.random.RandomState(2)
    B, MC, n = 4, 64, 4096
    gb = torch.from_numpy((R.randn(B, MC, n) * 0.05).astype(np.float32))
    ahat = torch.from_numpy(R.randn(B, MC, n).astype(np.float32))
    chunk = 64
    parts = []
    for b in range(B):
        for c0 in range(0, n, chunk):
            acc = torch.zeros(MC, MC)
            for k0 in range(c0, min(n, c0 + chunk), 8):
                acc = acc + mma_partial(gb[b, :, k0:k0 + 8],
                                        ahat[b, :, k0:k0 + 8].t(), mode)
            parts.append(acc)
    Z, got = len(parts), torch.zeros(MC, MC)
    for w in range(8):
        s = torch.zeros(MC, MC)
        for z in range(w * Z // 8, (w + 1) * Z // 8):
            s = s + parts[z]
        got = got + s
    ref = torch.einsum("bmk,bck->mc", gb.double(), ahat.double())
    _held(float((got.double() - ref).abs().max()), ref, mode)


def test_fused_block_equals_unfused_generator():
    """Same parameters, same forward, same kernel grads through the whole
    port MobileResnetGenerator with and without the fused stages."""
    R = np.random.RandomState(7)
    x = torch.from_numpy((R.rand(2, 3, 32, 32) * 2 - 1).astype(np.float32))
    nets = {}
    for fused in (False, True):
        nets[fused] = init_params(
            MobileResnetGenerator(ngf=4, n_blocks=3, use_fused_blocks=fused),
            torch.Generator().manual_seed(0))
    y0, f0 = nets[False](x)
    y1, f1 = nets[True](x)
    np.testing.assert_allclose(y1.detach().numpy(), y0.detach().numpy(),
                               atol=3e-6, rtol=1e-5)
    for a, b in zip(f1, f0):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-5)

    names = [n for n, _ in nets[False].named_parameters()]
    g0 = torch.autograd.grad(torch.sin(y0).sum(),
                             list(nets[False].parameters()))
    g1 = torch.autograd.grad(torch.sin(y1).sum(),
                             list(nets[True].parameters()), allow_unused=True)
    for name, a, b in zip(names, g1, g0):
        if name.endswith("bias") and not name.startswith("conv_out"):
            # every conv bias but conv_out's feeds an affine-free IN: no true
            # gradient; reduction noise unfused, exact zeros in the fused stages
            if "_sep" in name:
                assert float(a.abs().max()) == 0.0, name
            assert float(b.abs().max()) < 5e-3, name
        else:
            scale = max(float(b.abs().max()), 1.0)
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       atol=5e-5 * scale, err_msg=name)


@pytest.mark.parametrize("size,dropout,flag,expect_fused", [
    (32, 0.0, True, True),
    (16, 0.0, True, False),   # below the 20 px floor of the JAX gate
    (32, 0.5, True, False),   # dropout between the stages
    (32, 0.0, None, False),   # auto keeps the JAX package's default: off
])
def test_fused_gates(monkeypatch, size, dropout, flag, expect_fused):
    """The generator takes the fused stages only where the JAX package's
    gates allow it (models/generators.py:219-231); otherwise the unfused
    path runs and the output shape is unchanged."""
    calls = []
    real = generators.fused_mobile_block
    monkeypatch.setattr(generators, "fused_mobile_block",
                        lambda *a: calls.append(1) or real(*a))
    g = init_params(MobileResnetGenerator(ngf=4, n_blocks=2,
                                          dropout_rate=dropout,
                                          use_fused_blocks=flag),
                    torch.Generator().manual_seed(1))
    x = torch.rand(1, 3, size, size, generator=torch.Generator().manual_seed(2))
    y, _ = g(x, generator=torch.Generator().manual_seed(3))
    assert tuple(y.shape) == (1, 3, size, size)
    assert len(calls) == (2 if expect_fused else 0)
