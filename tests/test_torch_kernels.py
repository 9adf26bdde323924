"""The CUDA stage kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip. The file
imports no JAX, so it runs on a machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Shapes are small and ragged (widths off every tile multiple, non-square and
minimum planes, a plane larger than one split-k chunk), complementing the
main-path shapes that chip_smoke.py checks. fp32 with TF32 off; forward
within 1e-4, gradients within 1e-4 * max(|ref|, 1) (reduction order only).
"""

import pytest

torch = pytest.importorskip("torch")

from gcc_tpu_torch.ops import mobile_block as mb  # noqa: E402

# (B, C, M, H, W, relu, residual)
CASES = [(2, 5, 7, 8, 12, True, False), (1, 3, 4, 5, 5, False, True),
         (3, 130, 70, 9, 33, True, True), (2, 24, 48, 40, 40, False, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, scale=False):
    tol = 1e-4 * (max(float(b.abs().max()), 1.0) if scale else 1.0)
    assert float((a - b).detach().abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernels_match_plain(cuda, case):
    B, C, M, H, W, relu, has_res = case
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(cuda)

    x, dwk, pwk = rnd(B, C, H, W), rnd(C, 1, 3, 3, scale=0.2), rnd(M, C, 1, 1, scale=0.2)
    res = rnd(B, M, H, W) if has_res else None
    g = rnd(B, M, H, W)
    before = dict(mb.LAUNCHES)
    out_k = mb.stage_fwd(x, dwk, pwk, res, relu)
    out_p = [t.contiguous() for t in mb.stage_fwd_plain(x, dwk, pwk, res, relu)]
    for a, b in zip(out_k, out_p):
        _close(a, b)
    _, ahat, bhat, rstd_a, rstd_b = out_p
    pw_k = mb.stage_bwd_pw(g, ahat, bhat, rstd_b, pwk, relu)
    pw_p = mb.stage_bwd_pw_plain(g, ahat, bhat, rstd_b, pwk, relu)
    for a, b in zip(pw_k, pw_p):
        _close(a, b, scale=True)
    gah = pw_p[0].contiguous()
    for a, b in zip(mb.stage_bwd_dw(gah, ahat, rstd_a, x, dwk),
                    mb.stage_bwd_dw_plain(gah, ahat, rstd_a, x, dwk)):
        _close(a, b, scale=True)
    assert {k: mb.LAUNCHES[k] - before[k] for k in before} == \
        {"stage_fwd": 1, "stage_bwd_pw": 1, "stage_bwd_dw": 1}
    # no float atomics: a second call gives the same bits
    assert all(torch.equal(a, b) for a, b in zip(
        pw_k, mb.stage_bwd_pw(g, ahat, bhat, rstd_b, pwk, relu)))
    assert all(torch.equal(a, b) for a, b in zip(
        out_k, mb.stage_fwd(x, dwk, pwk, res, relu)))


@pytest.mark.cuda
def test_wrapper_rejects_bad_input(cuda):
    x = torch.zeros(1, 4, 8, 8, device=cuda)
    dwk, pwk = torch.zeros(4, 1, 3, 3, device=cuda), torch.zeros(6, 4, 1, 1, device=cuda)
    with pytest.raises(ValueError):
        mb.stage_fwd(x.double(), dwk.double(), pwk.double())
    with pytest.raises(ValueError):
        mb.stage_fwd(x.transpose(2, 3), dwk, pwk)
    with pytest.raises(ValueError):
        mb.stage_fwd(x, dwk, torch.zeros(6, 5, 1, 1, device=cuda))
    with pytest.raises(ValueError):
        mb.stage_fwd(x, dwk.cpu(), pwk)
