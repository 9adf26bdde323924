"""The arithmetic of kernel B2's bf16 depthwise backward
(``gcc_stage_bwd_dw_bf16`` in csrc/mobile_block_bf16.cu), on the CPU.

* (a) The kernel takes the transposed taps in Hopper's native bf16x2
  arithmetic (``mul.rn.bf16x2``, ``add.rn.bf16x2``: one rounding to nearest
  even of the exact result) where the TPU kernel rounds the fp32 result,
  ``round_bf16(fp32(a * b))`` and ``round_bf16(fp32(a + b))``. Over ~10^6
  bf16 pairs that span every exponent, subnormals, zeros of both signs and
  exponent gaps 0 .. 30, the two agree bit for bit, the exact result taken
  in float64 and rounded by a bit-level routine (tests/torch_bf16_pairs.py;
  tests/test_torch_kernels.py runs the card's instructions on the same
  pairs).
* (b) dx: the taps of each pixel in the kernel's order (tap order, then the
  pad adjoint's column folds and row folds, every sum rounded; the kernel
  takes two neighbouring pixels an instruction, which does not change a
  pixel's sequence), emulated, equal ``stage_bwd_dw_plain``'s dx bit for bit
  on planes whose rows and columns 1 and W - 2 take the folds, a 3-row
  plane (both row folds onto row 1) and a 3-column one.
* (c) dW_dw: each plane's nine sums in the kernel's strip order (thread t
  sums column t % W over its rows with fused multiply-adds, then the warp
  tree and the warps in order), and the cluster's sum of B <= 8 planes in
  sample order from 0, give the bits of ``sum_partials``' order for Z = 1 ..
  8 partials, and stay within ``mobile_block.BF16_DW`` of float64.

No JAX: the plain version is the reference (tests/test_torch_bf16.py holds
it to gcc_tpu). One torch thread; a few seconds.
"""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_bf16_pairs as bp
from gcc_tpu_torch.ops import kernels
from gcc_tpu_torch.ops import mobile_block as mb
from torch_limits import one_thread  # noqa: E402,F401

BF = torch.bfloat16
THREADS, WARPS = 256, 8


def test_native_ops_equal_the_fp32_forms():
    a, b = bp.bf16_pairs()
    ea = (a >> 7) & 0xFF
    eb = (b >> 7) & 0xFF
    both = (ea > 0) & (eb > 0)
    # the set holds what the identity could fail on
    assert ((ea == 0) & ((a & 0x7F) != 0)).any()  # subnormals
    assert (a == 0).any() and (a == 0x8000).any()  # +0 and -0
    assert set(np.abs(ea.astype(int) - eb)[both]) >= set(range(31))
    assert np.array_equal(bp.emulated_mul(a, b), bp.exact_mul(a, b))
    assert np.array_equal(bp.emulated_add(a, b), bp.exact_add(a, b))


def rnd(t):
    """fp32 to bf16 and back: one round to nearest even."""
    return t.to(BF).float()


def emulated_dx(ga, dwk):
    """dx of ga (B, C, H, W) bf16 in the kernel's order."""
    _, _, H, W = ga.shape
    w = rnd(dwk.reshape(-1, 9))[None, :, :, None, None]  # (1, C, 9, 1, 1)
    pad = F.pad(ga.float(), (1, 1, 1, 1))

    def at(di, dj):  # ga(i + di, j + dj) at every pixel, 0 off the plane
        return pad[:, :, 1 + di:1 + di + H, 1 + dj:1 + dj + W]

    def taps(terms):  # a fold: its taps' sum in tap order, each sum rounded
        s = torch.zeros_like(terms[0][1])
        for wt, v in terms:
            s = rnd(s + rnd(wt * v))
        return s

    g = torch.zeros_like(pad[:, :, 1:-1, 1:-1])
    for t in range(9):
        g = rnd(g + rnd(w[:, :, t] * at(1 - t // 3, 1 - t % 3)))
    wc = w[..., 0]  # (1, C, 9, 1): a column's weights
    for col, dj, k0 in ((1, -1, 0), (W - 2, 1, 2)):  # padded column 0, W + 1
        fold = taps([(wc[:, :, 3 * k + k0], at(1 - k, dj)[..., col])
                     for k in range(3)])
        g[..., col] = rnd(g[..., col] + fold)
    wr = w[:, :, :, 0]  # (1, C, 9, 1): a row's weights
    for row, u in ((1, 0), (H - 2, 2)):  # padded row 0, H + 1
        rr = u - 1  # ga's row that reaches the padded row, from the pixel's
        fold = taps([(wr[:, :, 3 * u + jj], at(rr, 1 - jj)[:, :, row])
                     for jj in range(3)])
        fold[..., 1] = rnd(fold[..., 1] + rnd(wr[:, :, 3 * u, 0] *
                                              at(rr, -1)[:, :, row, 1]))
        fold[..., W - 2] = rnd(fold[..., W - 2] + rnd(
            wr[:, :, 3 * u + 2, 0] * at(rr, 1)[:, :, row, W - 2]))
        g[:, :, row] = rnd(g[:, :, row] + fold)
    return g.to(BF)


def inputs(B, C, H, W, seed):
    gen = torch.Generator().manual_seed(seed)
    x, gah, ahat = (torch.randn(B, C, H, W, generator=gen).to(BF)
                    for _ in range(3))
    rstd = torch.rand(B, C, generator=gen) + 0.5
    dwk = torch.randn(C, 1, 3, 3, generator=gen) * 0.2
    return gah, ahat, rstd, x, dwk


@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (2, 3, 8, 12),
                                   (1, 4, 16, 24), (1, 3, 64, 64),
                                   (2, 3, 3, 8), (2, 3, 8, 3)])
def test_dx_order_equals_plain(shape):
    gah, ahat, rstd, x, dwk = inputs(*shape, seed=sum(shape))
    ga = mb._inorm_bwd(gah, ahat, rstd)
    got = emulated_dx(ga, dwk)
    want = mb.stage_bwd_dw_plain(gah, ahat, rstd, x, dwk)[0]
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def fma(a, b, c):
    """a * b + c rounded once to fp32 (a, b bf16 values: the product is
    exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def block_total(s):
    """block_sums of per-thread values s (..., THREADS): each warp's
    xor-shuffle tree, then the warp sums in order from 0."""
    lanes = torch.arange(32)
    v = s.reshape(*s.shape[:-1], WARPS, 32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    total = torch.zeros(s.shape[:-1])
    for w in range(WARPS):
        total = total + v[..., w, 0]
    return total


def plane_dw(ga, x):
    """Each plane's nine dW_dw sums (B, C, 9) in the kernel's strip order:
    thread t (t < W segs) sums column t % W, rows (t // W) rows ..; the
    window of reflect-padded x around each pixel."""
    B, C, H, W = ga.shape
    segs = max(1, THREADS // W)
    rows = -(-H // segs)
    xp = F.pad(x.float(), (1, 1, 1, 1), mode="reflect")
    acc = torch.zeros(B, C, 9, THREADS)
    for t in range(min(THREADS, W * segs)):
        j, i0 = t % W, t // W * rows
        for i in range(i0, min(H, i0 + rows)):
            gc = ga[:, :, i, j].float()[..., None]
            acc[..., t] = fma(gc, xp[:, :, i:i + 3, j:j + 3].reshape(B, C, 9),
                              acc[..., t])
    return block_total(acc)


def sum_partials(part):
    """sum_partials_kernel's order over part (Z, ...): warp w sums z in
    [w Z / 8, (w + 1) Z / 8) from 0, then the warp sums in order from 0."""
    Z = part.shape[0]
    total = torch.zeros(part.shape[1:])
    for w in range(WARPS):
        s = torch.zeros(part.shape[1:])
        for z in range(w * Z // WARPS, (w + 1) * Z // WARPS):
            s = s + part[z]
        total = total + s
    return total


def cluster_sum(part):
    """Rank 0's sum of the cluster's partials: sample order, from 0."""
    t = torch.zeros(part.shape[1:])
    for z in range(part.shape[0]):
        t = t + part[z]
    return t


def test_dw_orders():
    gah, ahat, rstd, x, dwk = inputs(8, 3, 64, 64, seed=3)
    ga = mb._inorm_bwd(gah, ahat, rstd)
    part = plane_dw(ga, x)  # (B, C, 9)
    xp = F.pad(x.double(), (1, 1, 1, 1), mode="reflect")
    exact = torch.stack([(ga.double() * xp[:, :, i:i + 64, j:j + 64]).sum(
        dim=(2, 3)) for i in range(3) for j in range(3)], dim=-1)  # (B, C, 9)
    plain = mb.stage_bwd_dw_plain(gah, ahat, rstd, x, dwk)[1].reshape(3, 9)
    # zeros of both signs among the partials: 0 + -0 is +0 in both orders
    signed = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 2.5, -2.5, -0.0, 0.0])
    for Z in range(1, 9):
        for p in (part[:Z], signed[:Z, None]):
            got, want = cluster_sum(p), sum_partials(p)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        ref = exact[:Z].sum(0)
        err = float((cluster_sum(part[:Z]).double() - ref).abs().max())
        assert err <= mb.BF16_DW * float(ref.abs().max())
    full = cluster_sum(part)
    assert float((full - plain).abs().max()) <= mb.BF16_DW * float(
        plain.abs().max())


def test_entry_point_lives_in_the_bf16_library():
    """The bf16 depthwise backward is mobile_block_bf16.cu's, on native
    bf16x2 arithmetic; mobile_block.cu holds fp32 only."""
    assert "gcc_stage_bwd_dw_bf16" in kernels.SIGNATURES["mobile_block_bf16"]
    assert not any("bf16" in fn for fn in kernels.SIGNATURES["mobile_block"])
    def code(name):  # the source without its comments
        text = (kernels.CSRC / name).read_text()
        return re.sub(r"//[^\n]*", "", text)

    assert "bf16" not in code("mobile_block.cu")
    bf16 = code("mobile_block_bf16.cu")
    assert "int gcc_stage_bwd_dw_bf16(" in bf16
    assert '"mul.rn.bf16x2' in bf16 and '"add.rn.bf16x2' in bf16
    assert "fma.rn.bf16x2" not in bf16
