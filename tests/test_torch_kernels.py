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
widths that take the wide kernels, which stream q, k, v and dO in 64-channel
chunks, and lengths whose dq partials group several key tiles), complementing
the main-path shapes that chip_smoke.py checks, and logits up to ~80
(q, k at scale 2). fp32 with TF32 off; B2
forward within 1e-4, B1 forward within 1e-5 * max(|ref|, 1), gradients
within 1e-4 * max(|ref|, 1) (reduction order; the split-TF32 products of
B2 and B1 stay within a few fp32 roundings of fp32 ones,
tests/test_torch_attention.py, tests/test_torch_mobile_block.py). B2's bf16
entry points against the bf16 plain versions: bf16 outputs within 2 bf16
ulps of their largest value with at most 1 % of elements apart (the
kernels round where the plain versions round; fp32 sums in another order
move a few values to their other bf16 neighbour), fp32 weight gradients
within 1e-3 of their largest value (``kernels.bf16_err`` and
``mobile_block``'s bounds, which chip_smoke.py applies too). B1's bf16 entry points
(csrc/flash_attention_bf16.cu, or flash_attention.cu's streaming kernels
for the shapes whose tiles do not fit a block: ``bf16_route``), at every
shape of the fp32 cases too, against
the bf16 plain versions: O, dq, dk and dv within one bf16 ulp of their
largest value with at most 1 % of elements apart, or, for an output
farther than that from its plain version, no farther from the float64
answer than the plain version (``flash_attention.BF16_ULPS``,
``bf16_share_ok``, which chip_smoke.py applies too); lse within the fp32
bound.
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
        {"stage_fwd": 1, "stage_bwd_pw": 1, "stage_bwd_dw": 1,
         "stage_fwd_bf16": 0, "stage_bwd_pw_bf16": 0, "stage_bwd_dw_bf16": 0}
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


# bf16 stages (B, C, M, H, W, relu, residual): the main path's teacher
# stage (B 4, C = M = 256, 64x64) and its student stages (112 -> 72 with
# relu, 72 -> 112 with the residual: partial 128-wide GEMM tiles), both
# with relu and with a residual; CycleGAN's batch-1 teacher stage, off the
# bf16 path until CycleGAN computes in bf16 (ROADMAP Queue A item 4); odd
# widths (C, M off a multiple of 16, and of 8, which takes the GEMM's
# element-wise copies), a ragged plane; planes past the 64x64 whose pixels
# the plane kernels hold in registers (80x80 with x staged in shared
# memory, 128x128; 150x150 read from device memory at every tap), which take
# their pixel-by-pixel route; small planes whose width is a multiple of 8
# (8x8, the tiny CycleGAN's blocks; 16x24), which take the 16-byte route
# with fewer vectors than threads
BF16_CASES = [(4, 256, 256, 64, 64, True, False),
              (4, 256, 256, 64, 64, False, True),
              (4, 112, 72, 64, 64, True, False),
              (4, 72, 112, 64, 64, False, True),
              (1, 256, 256, 64, 64, True, False),
              (1, 256, 256, 64, 64, False, True),
              (2, 24, 40, 20, 20, True, True), (2, 5, 7, 8, 12, True, False),
              (3, 130, 70, 9, 33, False, True),
              (2, 40, 48, 80, 80, True, True),
              (1, 24, 136, 128, 128, False, True),
              (1, 3, 5, 150, 150, True, False),
              (2, 32, 32, 8, 8, True, False), (2, 12, 6, 8, 8, False, True),
              (3, 40, 24, 16, 24, True, True)]


def _close_bf16(name, a, b):
    """A bf16 kernel output against its plain version, within
    mobile_block's BF16_ULPS and BF16_SHARE."""
    assert a.dtype == b.dtype == torch.bfloat16, name
    ulps, _, share = kernels.bf16_err(a, b)
    assert ulps <= mb.BF16_ULPS and share <= mb.BF16_SHARE, (name, ulps, share)


def _close_dw(a, b):
    """An fp32 weight gradient within BF16_DW of its plain version's
    largest value."""
    assert a.dtype == torch.float32
    assert float((a - b).abs().max()) <= mb.BF16_DW * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_kernels_match_plain(cuda, case):
    """The three bf16 entry points against the bf16 plain versions, each on
    the plain version's inputs: bf16 outputs by _close_bf16, the fp32
    weight gradients by _close_dw; a second call repeats the bits;
    the bf16 launch counters move, the fp32 ones do not."""
    B, C, M, H, W, relu, has_res = case
    gen = torch.Generator().manual_seed(1)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(cuda, dtype)

    bf = torch.bfloat16
    x, dwk = rnd(B, C, H, W, dtype=bf), rnd(C, 1, 3, 3, scale=0.2)
    pwk = rnd(M, C, 1, 1, scale=0.2)
    res = rnd(B, M, H, W, dtype=bf) if has_res else None
    g = rnd(B, M, H, W, dtype=bf)
    before = dict(mb.LAUNCHES)
    out_k = mb.stage_fwd(x, dwk, pwk, res, relu)
    out_p = [t.contiguous() for t in mb.stage_fwd_plain(x, dwk, pwk, res, relu)]
    for n, a, b in zip(("y", "a-hat", "b-hat"), out_k[:3], out_p[:3]):
        _close_bf16(n, a, b)
    for a, b in zip(out_k[3:], out_p[3:]):  # the 1/std vectors, fp32
        _close(a, b, scale=True)
    _, ahat, bhat, rstd_a, rstd_b = out_p
    pw_k = mb.stage_bwd_pw(g, ahat, bhat, rstd_b, pwk, relu)
    pw_p = mb.stage_bwd_pw_plain(g, ahat, bhat, rstd_b, pwk, relu)
    _close_bf16("d a-hat", pw_k[0], pw_p[0])
    _close_dw(pw_k[1], pw_p[1])
    gah = pw_p[0].contiguous()
    dw_k = mb.stage_bwd_dw(gah, ahat, rstd_a, x, dwk)
    dw_p = mb.stage_bwd_dw_plain(gah, ahat, rstd_a, x, dwk)
    _close_bf16("dx", dw_k[0], dw_p[0])
    _close_dw(dw_k[1], dw_p[1])
    assert {k: mb.LAUNCHES[k] - before[k] for k in before} == \
        {"stage_fwd": 0, "stage_bwd_pw": 0, "stage_bwd_dw": 0,
         "stage_fwd_bf16": 1, "stage_bwd_pw_bf16": 1, "stage_bwd_dw_bf16": 1}
    assert all(torch.equal(a, b) for a, b in zip(
        out_k, mb.stage_fwd(x, dwk, pwk, res, relu)))
    assert all(torch.equal(a, b) for a, b in zip(
        pw_k, mb.stage_bwd_pw(g, ahat, bhat, rstd_b, pwk, relu)))
    assert all(torch.equal(a, b) for a, b in zip(
        dw_k, mb.stage_bwd_dw(gah, ahat, rstd_a, x, dwk)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(4, 256, 256, 64, True), (1, 72, 112, 64,
                                                             False)])
def test_bf16_entry_points_repeat(cuda, case):
    """gcc_stage_fwd_bf16 and gcc_stage_bwd_pw_bf16 give the same bits on
    the same inputs when called twice with other calls between them (their
    outputs and scratch then lie elsewhere): no float atomics, and the dW
    partials' ordered sum does not depend on what memory held before."""
    B, C, M, S, relu = case
    gen = torch.Generator().manual_seed(5)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen) * scale).to(cuda, dtype)

    x, dwk = rnd(B, C, S, S, dtype=bf), rnd(C, 1, 3, 3, scale=0.2)
    pwk, g = rnd(M, C, 1, 1, scale=0.2), rnd(B, M, S, S, dtype=bf)
    first = mb.stage_fwd(x, dwk, pwk, None, relu)
    grads = mb.stage_bwd_pw(g, first[1], first[2], first[4], pwk, relu)
    keep = [mb.stage_fwd(x[:1, :8].contiguous(), dwk[:8],
                         pwk[:, :8].contiguous(), None, relu)
            for _ in range(2)]  # other memory taken
    again = mb.stage_fwd(x, dwk, pwk, None, relu)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.equal(a, b) for a, b in zip(grads, mb.stage_bwd_pw(
        g, again[1], again[2], again[4], pwk, relu)))
    del keep


@pytest.mark.cuda
def test_bf16_stage_function(cuda):
    """fused_sep_stage on bf16 CUDA tensors: y and dx bf16, the weight
    gradients fp32, through the bf16 kernels; an fp16 activation raises."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 16, 12, 12, generator=gen).to(cuda, torch.bfloat16)
    dwk = (torch.randn(16, 1, 3, 3, generator=gen) * 0.2).to(cuda)
    pwk = (torch.randn(16, 16, 1, 1, generator=gen) * 0.2).to(cuda)
    leaves = [x.clone().requires_grad_(True), dwk.requires_grad_(True),
              pwk.requires_grad_(True)]
    y = mb.fused_sep_stage(leaves[0], leaves[1], leaves[2], leaves[0], True)
    assert y.dtype == torch.bfloat16
    gx, gdw, gpw = torch.autograd.grad(y.float().sum(), leaves)
    assert gx.dtype == torch.bfloat16 and gdw.dtype == gpw.dtype == torch.float32
    with pytest.raises(ValueError):
        mb.stage_fwd(x.half(), dwk, pwk)


# (B, N, dq, dv, scale of q and k): scale 2 gives logits up to ~80, where
# an error in S weighs most. SAGAN D's attn2 at 4x4 (dq 64, dv 512), a q
# wider than the resident forward takes (dq 320), and N past 16 key tiles,
# whose dq partials group 5 and 2 key tiles (N 4160: 13 groups; N 1100: 9)
ATTN_CASES = [(1, 1, 1, 1, 0.5), (2, 65, 3, 5, 0.5), (3, 130, 25, 200, 0.5),
              (2, 1024, 2, 16, 0.5), (1, 200, 40, 33, 0.5),
              (1, 70, 40, 280, 0.5), (2, 1024, 8, 64, 2.0),
              (2, 1000, 2, 16, 2.0), (64, 16, 64, 512, 0.5),
              (2, 300, 320, 320, 0.5), (1, 4160, 8, 64, 0.5),
              (1, 1100, 100, 150, 0.5)]


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
        {"attn_fwd": 1, "attn_bwd": 2, "attn_fwd_bf16": 0, "attn_bwd_bf16": 0}
    # no float atomics: a second call gives the same bits
    assert all(torch.equal(a, b) for a, b in zip((o, lse), fa.attn_fwd(q, k, v)))
    assert all(torch.equal(a, b) for a, b in zip(grads, fa.attn_bwd(*args)))


@pytest.mark.cuda
def test_attention_dq_groups(cuda):
    """The backward's dq scratch holds at most 16 key-tile groups, whatever
    N is: one group a key tile up to 16 tiles."""
    assert [fa.dq_groups(n) for n in (1, 64, 1000, 1024, 1025, 1100, 4160,
                                      16384, 65536)] == \
        [1, 1, 16, 16, 9, 9, 13, 16, 16]


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


# bf16 (B, N, dq, dv, scale of q and k): chip_smoke.py phase 18's shapes
# (the main path's teacher and student, ragged, many-tile, wide-logit, D's
# attn2 at threshold 16, wide q, long N), ragged ones off the 8-element
# vector loads (N % 8 != 0: 2-byte loads), then every fp32 ATTN_CASES shape
# not among them
ATTN_BF16_CASES = [(64, 1024, 8, 64, 0.5), (64, 1024, 2, 16, 0.5),
                   (2, 1000, 25, 200, 0.5), (2, 4096, 8, 64, 0.5),
                   (16, 1024, 8, 64, 2.0), (64, 16, 64, 512, 0.5),
                   (4, 1024, 320, 320, 0.5), (1, 16384, 8, 64, 0.5),
                   (3, 301, 5, 33, 0.5), (2, 65, 3, 5, 0.5)]
ATTN_BF16_CASES += [c for c in ATTN_CASES if c not in ATTN_BF16_CASES]
# (dq, dv) -> the kernels that take bf16 (forward, backward): the tiles of
# flash_attention_bf16.cu up to its shared memory, flash_attention.cu's
# streaming kernels past it
ATTN_BF16_ROUTES = {(8, 64): ("tiles", "tiles"), (2, 16): ("tiles", "tiles"),
                    (25, 200): ("tiles", "tiles"),
                    (40, 280): ("tiles", "tiles"),
                    (100, 150): ("tiles", "tiles"),
                    (64, 512): ("tiles", "wide"),
                    (272, 64): ("tiles", "tiles"),
                    (273, 64): ("tiles", "wide"),
                    (289, 64): ("wide", "wide"),
                    (320, 320): ("wide", "wide")}


def _close_attn_bf16(got, plain, exact=None):
    ulps, _, _ = kernels.bf16_err(got, plain)
    ok, share, plain_off, got_off = fa.bf16_share_ok(got, plain, exact)
    assert got.dtype == torch.bfloat16
    assert ulps <= fa.BF16_ULPS and ok, (ulps, share, plain_off, got_off)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_BF16_CASES)
def test_attention_bf16_kernels_match_plain(cuda, case):
    """gcc_attn_fwd_bf16 and gcc_attn_bwd_bf16 against the bf16 plain
    versions, the backward also on the kernel forward's own O and lse
    (against the plain backward on the same O and lse); only the bf16
    launch counters move; two calls give the same bits."""
    B, N, dq, dv, scale = case
    gen = torch.Generator().manual_seed(3)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(
            cuda, torch.bfloat16)

    q, k = rnd(B, dq, N, scale=scale), rnd(B, dq, N, scale=scale)
    v, do = rnd(B, dv, N), rnd(B, dv, N)
    before = dict(fa.LAUNCHES)
    o, lse = fa.attn_fwd(q, k, v)
    o_p, lse_p = fa.attn_fwd_plain(q, k, v)
    _close_attn_bf16(o, o_p)
    assert lse.dtype == torch.float32
    assert float((lse - lse_p).abs().max()) <= 1e-5 * max(
        float(lse_p.abs().max()), 1.0)
    for oo, ll in ((o_p, lse_p), (o, lse)):
        args = (q, k, v, do, ll.contiguous(), (do.float() * oo.float()).sum(1))
        grads, plain = fa.attn_bwd(*args), fa.attn_bwd_plain(*args)
        exact = None
        if any(not fa.bf16_share_ok(a, b)[0] for a, b in zip(grads, plain)):
            exact = fa.attn_bwd_plain(*(t.double() for t in args))
        for i, (a, b) in enumerate(zip(grads, plain)):
            _close_attn_bf16(a, b, None if exact is None else exact[i])
    assert {k_: fa.LAUNCHES[k_] - before[k_] for k_ in before} == \
        {"attn_fwd": 0, "attn_bwd": 0, "attn_fwd_bf16": 1, "attn_bwd_bf16": 2}
    assert all(torch.equal(a, b) for a, b in zip((o, lse), fa.attn_fwd(q, k, v)))
    assert all(torch.equal(a, b) for a, b in zip(grads, fa.attn_bwd(*args)))


@pytest.mark.cuda
def test_attention_bf16_routes(cuda):
    """Which kernel takes bf16 inputs of each width: the bf16 tiles wherever
    they fit one block's shared memory, flash_attention.cu's streaming
    kernels past it; the bf16 backward's dq groups give about two blocks an
    SM (4 at the main path's B 64, N 1024 on an H100's 132 SMs), at most
    64."""
    got = {w: (fa.bf16_route(*w, False), fa.bf16_route(*w, True))
           for w in ATTN_BF16_ROUTES}
    assert got == ATTN_BF16_ROUTES
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    want = min(16, -(-2 * sms // 64))
    per = -(-16 // want)
    assert fa.dq_groups_bf16(64, 1024, 8, 64) == -(-16 // per)
    assert fa.dq_groups_bf16(1, 16384, 8, 64) == 64


@pytest.mark.cuda
def test_attention_bf16_function(cuda):
    """flash_attention on bf16 CUDA tensors: bf16 output and gradients
    through the bf16 kernels; an fp16 q, k, v raises."""
    gen = torch.Generator().manual_seed(4)
    q, k = (torch.randn(2, 2, 1024, generator=gen) * 0.5 for _ in range(2))
    v, co = (torch.randn(2, 16, 1024, generator=gen) for _ in range(2))
    leaves = [t.to(cuda, torch.bfloat16).requires_grad_(True)
              for t in (q, k, v)]
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(*leaves)
    grads = torch.autograd.grad((out.float() * co.to(cuda)).sum(), leaves)
    assert out.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    assert {k_: fa.LAUNCHES[k_] - before[k_] for k_ in before} == \
        {"attn_fwd": 0, "attn_bwd": 0, "attn_fwd_bf16": 1, "attn_bwd_bf16": 1}
    half = [t.detach().half() for t in leaves]
    with pytest.raises(ValueError):
        fa.attn_fwd(*half)
    with pytest.raises(ValueError):
        fa.attn_fwd(half[0], half[1].bfloat16(), half[2].bfloat16())


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
