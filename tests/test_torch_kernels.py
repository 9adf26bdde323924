"""The CUDA kernels (B2 stage, B1 flash attention) against their plain
PyTorch versions, on the card.

These tests need a CUDA device and nvcc; elsewhere they skip. The file
imports no JAX, so it runs on a machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

One test runs on the CPU: a library's name follows its source, the shared
headers in csrc/ and the flags, so an edited header is rebuilt.

Shapes are small and ragged (widths off every tile multiple and past one
128-wide GEMM tile, non-square and minimum planes, H*W off a multiple of 4
(4-byte copies), pointwise weight gradients split into many chunks and into
one, a plane larger than the 64x64 that the norms hold in registers and one
whose tiles pass the depthwise backward's shared memory; N off the 64-row
tile, feature widths past one 16-wide chunk and one 64-wide output chunk,
widths whose backward tiles fit only one shared-memory stage), complementing
the main-path shapes that chip_smoke.py checks, and logits up to ~80
(q, k at scale 2). fp32 with TF32 off; B2
forward within 1e-4, B1 forward within 1e-5 * max(|ref|, 1), gradients
within 1e-4 * max(|ref|, 1) (reduction order; the split-TF32 products of
B2 and B1 stay within a few fp32 roundings of fp32 ones,
tests/test_torch_attention.py, tests/test_torch_mobile_block.py).
"""

import pytest

torch = pytest.importorskip("torch")

from gcc_tpu_torch.ops import flash_attention as fa  # noqa: E402
from gcc_tpu_torch.ops import kernels  # noqa: E402
from gcc_tpu_torch.ops import mobile_block as mb  # noqa: E402

# (B, C, M, H, W, relu, residual)
CASES = [(2, 5, 7, 8, 12, True, False), (1, 3, 4, 5, 5, False, True),
         (3, 130, 70, 9, 33, True, True), (2, 24, 48, 40, 40, False, True),
         (2, 72, 112, 20, 20, True, False), (1, 3, 5, 70, 66, True, True),
         (2, 136, 200, 24, 24, True, False), (48, 136, 200, 8, 8, False, True),
         (1, 3, 5, 80, 80, True, False)]


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
    dw_k = mb.stage_bwd_dw(gah, ahat, rstd_a, x, dwk)
    for a, b in zip(dw_k, mb.stage_bwd_dw_plain(gah, ahat, rstd_a, x, dwk)):
        _close(a, b, scale=True)
    assert {k: mb.LAUNCHES[k] - before[k] for k in before} == \
        {"stage_fwd": 1, "stage_bwd_pw": 1, "stage_bwd_dw": 1}
    # no float atomics: a second call gives the same bits
    assert all(torch.equal(a, b) for a, b in zip(
        pw_k, mb.stage_bwd_pw(g, ahat, bhat, rstd_b, pwk, relu)))
    assert all(torch.equal(a, b) for a, b in zip(
        dw_k, mb.stage_bwd_dw(gah, ahat, rstd_a, x, dwk)))
    assert all(torch.equal(a, b) for a, b in zip(
        out_k, mb.stage_fwd(x, dwk, pwk, res, relu)))


@pytest.mark.cuda
def test_pw_grad_chunk(cuda):
    """The dW split: output tiles x (sample, chunk) partials make about two
    blocks an SM at the main path's shapes, several chunks at a small batch
    and one where the batch and tiles fill the card already."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    partials = kernels.library("mobile_block").gcc_stage_bwd_pw_partials
    for B, C, M in [(4, 256, 256), (4, 112, 72), (4, 72, 112)]:
        blocks = -(-M // 128) * -(-C // 128) * partials(B, C, M, 64, 64, sms)
        assert 0.9 * 2 * sms <= blocks <= 2 * sms
    assert partials(2, 136, 200, 24, 24, sms) > 2
    assert partials(48, 136, 200, 8, 8, sms) == 48


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


# (B, N, dq, dv, scale of q and k): scale 2 gives logits up to ~80, where
# an error in S weighs most
ATTN_CASES = [(1, 1, 1, 1, 0.5), (2, 65, 3, 5, 0.5), (3, 130, 25, 200, 0.5),
              (2, 1024, 2, 16, 0.5), (1, 200, 40, 33, 0.5),
              (1, 70, 40, 280, 0.5), (2, 1024, 8, 64, 2.0),
              (2, 1000, 2, 16, 2.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_kernels_match_plain(cuda, case):
    B, N, dq, dv, scale = case
    gen = torch.Generator().manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(cuda)

    q, k = rnd(B, dq, N, scale=scale), rnd(B, dq, N, scale=scale)
    v, do = rnd(B, dv, N), rnd(B, dv, N)
    before = dict(fa.LAUNCHES)
    o, lse = fa.attn_fwd(q, k, v)
    o_p, lse_p = fa.attn_fwd_plain(q, k, v)
    for a, b in ((o, o_p), (lse, lse_p)):
        tol = 1e-5 * max(float(b.abs().max()), 1.0)
        assert float((a - b).abs().max()) <= tol
    delta = (do * o_p).sum(1)
    args = (q, k, v, do, lse_p.contiguous(), delta)
    grads = fa.attn_bwd(*args)
    plain = fa.attn_bwd_plain(*args)
    for a, b in zip(grads, plain):
        _close(a, b, scale=True)
    # the backward on the kernel forward's own lse and O, as autograd runs it
    for a, b in zip(fa.attn_bwd(q, k, v, do, lse, (do * o).sum(1)), plain):
        _close(a, b, scale=True)
    assert {k_: fa.LAUNCHES[k_] - before[k_] for k_ in before} == \
        {"attn_fwd": 1, "attn_bwd": 2}
    # no float atomics: a second call gives the same bits
    assert all(torch.equal(a, b) for a, b in zip((o, lse), fa.attn_fwd(q, k, v)))
    assert all(torch.equal(a, b) for a, b in zip(grads, fa.attn_bwd(*args)))


@pytest.mark.cuda
def test_attention_function_grads(cuda):
    """flash_attention's kernels' backward against autograd through the
    plain softmax, at the student's main-path width."""
    gen = torch.Generator().manual_seed(2)
    q, k = (torch.randn(2, 2, 1024, generator=gen) * 0.5 for _ in range(2))
    v, co = (torch.randn(2, 16, 1024, generator=gen) for _ in range(2))
    leaves = [t.to(cuda).requires_grad_(True) for t in (q, k, v)]
    refs = [t.to(cuda).requires_grad_(True) for t in (q, k, v)]
    co = co.to(cuda)
    grads = torch.autograd.grad((fa.flash_attention(*leaves) * co).sum(),
                                leaves)
    ref = torch.autograd.grad((fa.attention_reference(*refs) * co).sum(), refs)
    for a, b in zip(grads, ref):
        _close(a, b, scale=True)


@pytest.mark.cuda
def test_attention_wrapper_rejects_bad_input(cuda):
    q = torch.zeros(1, 2, 8, device=cuda)
    v = torch.zeros(1, 4, 8, device=cuda)
    with pytest.raises(ValueError):
        fa.attn_fwd(q.double(), q.double(), v.double())
    with pytest.raises(ValueError):
        fa.attn_fwd(q, q, v.transpose(1, 2).contiguous())
    with pytest.raises(ValueError):
        fa.attn_fwd(q, q[:, :1].contiguous(), v)
    with pytest.raises(ValueError):
        fa.attn_fwd(q, q.cpu(), v)
    lse = delta = torch.zeros(1, 8, device=cuda)
    with pytest.raises(ValueError):
        fa.attn_bwd(q, q, v, v.double(), lse, delta)
    with pytest.raises(ValueError):
        fa.attn_bwd(q, q, v, torch.zeros(1, 8, 4, device=cuda).transpose(1, 2),
                    lse, delta)
    with pytest.raises(ValueError):
        fa.attn_bwd(q, q, v, v, torch.zeros(1, 9, device=cuda), delta)


def test_library_name_follows_headers(monkeypatch, tmp_path):
    """Editing a header in csrc/ renames every library, so a stale one is
    never loaded; the name is stable while nothing changes."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    first = kernels._lib_path("a")
    assert kernels._lib_path("a") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert kernels._lib_path("a") != first
    assert kernels._lib_path("a").parent == kernels.BUILD_DIR
