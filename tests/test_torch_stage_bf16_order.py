"""The sum orders of kernel B2's bf16 forward and pointwise backward
(csrc/mobile_block_bf16.cu), emulated in PyTorch on the CPU.

The kernels round where the plain versions (ops/mobile_block.py) round;
only the order of their fp32 sums differs:

* the InstanceNorm statistics: thread t sums pixels ``t + u * 256`` in
  turn, then a warp's xor-shuffle tree, then the eight warp sums in order;
  ``s += d * d`` and ``s += g * t`` as one fused multiply-add, as nvcc
  contracts them. The new plane kernels hold 8 neighbouring pixels a
  thread and copy the plane to shared memory to sum in this order, the
  order of the kernels they replace;
* the products: k steps of 16 in k order. The new kernels sum each step
  straight into the fp32 accumulator (m16n8k16 mma with C = the sum),
  modelled as the exact sum of the accumulator and the step's 16 exact
  products truncated toward zero, as the tensor cores truncate; the
  kernels they replace summed each step into a zeroed fragment (the same
  model) and added that in fp32 with rounding. dW_pw over runs of 32-pixel
  tiles of the (sample, pixel) axis (the new grid) or per (sample, chunk)
  (before), the partials summed by eight warps over contiguous ranges and
  then in warp order.

At the teacher's C = M = 256 and the student's widths these orders keep
every bf16 output within ``mobile_block.BF16_ULPS`` bf16 ulps of the plain
version's largest value and ``BF16_SHARE`` of its elements apart, dW_pw
within ``BF16_DW`` of its largest value, and the new orders are no farther
from the float64 answer (the same rounding points, exact sums) than the
replaced ones by more than those bounds. The file also checks that the
build covers the new source. No JAX: the plain versions are the reference,
and tests/test_torch_bf16.py holds them to gcc_tpu.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gcc_tpu_torch.ops import kernels
from gcc_tpu_torch.ops import mobile_block as mb

THREADS, VEC, VPT, WARPS = 256, 8, 2, 8  # VPT vectors of VEC: 16 pixels a thread
BK, BM, SMS, BLOCKS_PER_SM = 32, 128, 132, 2  # the kernels' tiles, an H100
BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rnd(t):
    """t rounded to bf16, as fp32."""
    return t.to(BF).float()


def fma(a, b, c):
    """a * b + c rounded once to fp32."""
    return (a.double() * b.double() + c.double()).float()


def truncate(x):
    """float64 x to fp32, rounded toward zero."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def accumulate(steps, order):
    """The fp32 sum of k steps (..., j, ...) given as float64 exact sums
    along dim 0: "new" straight into the accumulator, "old" each step
    truncated alone and added with rounding."""
    acc = torch.zeros(steps.shape[1:])
    for j in range(steps.shape[0]):
        if order == "new":
            acc = truncate(acc.double() + steps[j])
        else:
            acc = acc + truncate(steps[j])
    return acc


def per_thread(x):
    """x (..., n) -> (..., steps, THREADS): the values each thread adds in
    turn, pixels t + u THREADS, zero where it holds none."""
    n = x.shape[-1]
    steps = VPT * VEC
    return F.pad(x, (0, THREADS * steps - n)).reshape(*x.shape[:-1], steps,
                                                        THREADS)


def tree(s):
    """A block's total of per-thread sums s (..., THREADS): the xor-shuffle
    tree of each warp, then the warp sums in order (block_sums)."""
    lanes = torch.arange(32)
    v = s.reshape(*s.shape[:-1], WARPS, 32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    total = torch.zeros(s.shape[:-1])
    for w in range(WARPS):
        total = total + v[..., w, 0]
    return total


def stats(x):
    """(mean, 1/std) of each plane of x (..., n), fp32, in the kernels'
    order."""
    n = x.shape[-1]
    vals = per_thread(x)
    valid = per_thread(torch.ones_like(x)) > 0
    s = torch.zeros(vals.shape[:-2] + (THREADS,))
    for i in range(vals.shape[-2]):
        s = s + vals[..., i, :]
    mean = tree(s) / n
    d = torch.where(valid, vals - mean[..., None, None], torch.zeros(()))
    v = torch.zeros_like(s)
    for i in range(vals.shape[-2]):
        v = fma(d[..., i, :], d[..., i, :], v)
    return mean, 1.0 / torch.sqrt(tree(v) / n + mb.EPS)


def inorm(x, order):
    """IN of fp32 planes (..., n): normalised (fp32, before rounding), 1/std;
    order "f64": exact statistics."""
    if order == "f64":
        xd = x.double()
        mean = xd.mean(-1, keepdim=True)
        r = 1.0 / torch.sqrt((xd - mean).square().mean(-1, keepdim=True)
                             + mb.EPS)
        return ((xd - mean) * r).float(), r[..., 0].float()
    mean, r = stats(x)
    return (x - mean[..., None]) * r[..., None], r


def inorm_bwd(g, t, r, order, relu):
    """gb = r (g - mean(g) - t mean(g t)) of planes (..., n), g masked by
    t > 0 when relu; the kernel forms g - gm - t gym as one fused
    multiply-add. order "f64": exact sums."""
    if relu:
        g = torch.where(t > 0, g, torch.zeros(()))
    n = g.shape[-1]
    if order == "f64":
        gd, td = g.double(), t.double()
        gm, gym = gd.mean(-1, keepdim=True), (gd * td).mean(-1, keepdim=True)
        return (r.double()[..., None] * (gd - gm - td * gym)).float()
    vg, vt = per_thread(g), per_thread(t)
    s0 = torch.zeros(vg.shape[:-2] + (THREADS,))
    s1 = torch.zeros_like(s0)
    for i in range(vg.shape[-2]):
        s0 = s0 + vg[..., i, :]
        s1 = fma(vg[..., i, :], vt[..., i, :], s1)
    gm, gym = (tree(s0) / n)[..., None], (tree(s1) / n)[..., None]
    return r[..., None] * fma(-t, gym.expand_as(t), g - gm)


def product(a, x, order):
    """a (Mo, K) . x (B, K, N), both exact in bf16, by 16-deep k steps in k
    order (accumulate); "f64": exact."""
    if order == "f64":
        return torch.einsum("mk,bkn->bmn", a.double(), x.double()).float()
    mo, k = a.shape
    kp = -(-k // 16) * 16
    a4 = F.pad(a, (0, kp - k)).double().reshape(mo, kp // 16, 16)
    x4 = F.pad(x, (0, 0, 0, kp - k)).double().reshape(
        x.shape[0], kp // 16, 16, x.shape[2])
    return accumulate(torch.einsum("mjk,bjkn->jbmn", a4, x4), order)


def ordered_sum(parts):
    """sum_partials_kernel's order over parts (Z, ...): warp w sums z in
    [w Z / 8, (w + 1) Z / 8), then the warp sums in order."""
    z = parts.shape[0]
    total = torch.zeros(parts.shape[1:])
    for w in range(WARPS):
        s = torch.zeros(parts.shape[1:])
        for i in range(w * z // WARPS, (w + 1) * z // WARPS):
            s = s + parts[i]
        total = total + s
    return total


def grad_runs(B, C, M, n, order):
    """The dW partials' pixel ranges, [(sample, first, end), ...] a
    partial: "new" as grad_per in csrc/mobile_block_bf16.cu sizes them on
    an H100's 132 SMs (runs of 32-pixel tiles across samples); "old" as
    pw_grad_chunk sized the kernels it replaces (chunks of a sample)."""
    tps = -(-n // BK)
    if order == "old":
        tiles = -(-M // BM) * -(-C // BM)
        splits = max(1, min(tps, BLOCKS_PER_SM * SMS // (tiles * B)))
        chunk = -(-(-(-n // splits)) // BK) * BK
        return [[(b, p, min(n, p + chunk))] for b in range(B)
                for p in range(0, n, chunk)]
    T, kd = B * tps, -(-M // BK)
    wide = 4 * -(-C // BM) * -(-n // 256) * B >= 3 * SMS  # 128 x 256 tiles
    bn = 256 if wide else BM
    units = -(-C // BM) * -(-n // bn) * B * kd + -(-M // BM) * -(-C // bn) * T
    slots = (1 if wide else BLOCKS_PER_SM) * SMS
    per = max(kd, -(-units // slots), -(-T // max(1, (8 << 20) // (4 * M * C))))
    per = min(per, T)
    runs = []
    for s0 in range(0, T, per):
        runs.append([(t // tps, t % tps * BK, min(n, (t % tps + 1) * BK))
                     for t in range(s0, min(T, s0 + per))])
    return runs


def grad_weight(gb, ah, order):
    """dW_pw (M, C) = sum over samples and pixels of gb (B, M, n) . a-hat
    (B, C, n)^T, in the kernels' order; "f64": exact."""
    if order == "f64":
        return torch.einsum("bmn,bcn->mc", gb.double(), ah.double()).float()
    B, M, n = gb.shape
    parts = []
    for run in grad_runs(B, ah.shape[1], M, n, order):
        steps = []
        for b, p0, p1 in run:
            L = -(-(p1 - p0) // 16) * 16
            g4 = F.pad(gb[b, :, p0:p1], (0, L - (p1 - p0))).double()
            a4 = F.pad(ah[b, :, p0:p1], (0, L - (p1 - p0))).double()
            steps.append(torch.einsum("mjk,cjk->jmc", g4.reshape(M, -1, 16),
                                      a4.reshape(a4.shape[0], -1, 16)))
        parts.append(accumulate(torch.cat(steps), order))
    return ordered_sum(torch.stack(parts))


def inputs(B, C, M, S, seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    return (f(B, C, S, S).to(BF), f(C, 1, 3, 3) * 0.2, f(M, C, 1, 1) * 0.2,
            f(B, M, S, S).to(BF), f(B, M, S, S).to(BF))


def forward(x, dwk, pwk, res, relu, order):
    """(y, a-hat, b-hat) in bf16, (B, ch, n) planes."""
    B, C, H, W = x.shape
    a = rnd(mb._dw_taps(x, dwk)).reshape(B, C, H * W)
    ahat = rnd(inorm(a, order)[0])
    pw = rnd(pwk[:, :, 0, 0])
    b = rnd(product(pw, ahat, order))
    t, _ = inorm(b, order)
    bhat = rnd(t)
    y = torch.relu(bhat) if relu else bhat
    if res is not None:
        y = y + res.float().reshape(y.shape)
    return [v.to(BF) for v in (y, ahat, bhat)]


def backward(g, ahat, bhat, rstd_b, pwk, relu, order):
    """(d a-hat in bf16, dW_pw fp32) on (B, ch, n) planes."""
    gb = rnd(inorm_bwd(g.float(), bhat.float(), rstd_b, order, relu))
    pw = rnd(pwk[:, :, 0, 0])
    gah = rnd(product(pw.t(), gb, order))
    return gah.to(BF), grad_weight(gb, ahat.float(), order)


def planes(t):
    return t.reshape(t.shape[0], t.shape[1], -1)


def farther(got, old, exact, ulps, share):
    """got (the new order) is no farther from exact than old by more than
    the bounds."""
    gu, _, gs = kernels.bf16_err(got, exact)
    ou, _, os_ = kernels.bf16_err(old, exact)
    assert gu - ou <= ulps and gs - os_ <= share, (gu, ou, gs, os_)


# (B, C, M, plane side, relu, residual): the teacher stage (C = M = 256,
# one sample of 64x64, both register vectors of every thread in use), the
# student's stages (112 -> 72 with relu, 72 -> 112 with the residual), and
# a plane whose last vectors are partial (48x48: 288 vectors)
CASES = [(1, 256, 256, 64, True, False), (2, 112, 72, 64, True, False),
         (2, 72, 112, 64, False, True), (1, 256, 256, 48, False, True)]


@pytest.mark.parametrize("case", CASES)
def test_forward_orders(case):
    B, C, M, S, relu, has_res = case
    x, dwk, pwk, res, _ = inputs(B, C, M, S, seed=0)
    res = res if has_res else None
    plain = [planes(t) for t in mb.stage_fwd_plain(x, dwk, pwk, res, relu)[:3]]
    new, old, exact = (forward(x, dwk, pwk, res, relu, o)
                       for o in ("new", "old", "f64"))
    for name, got, ref, was, ex in zip(("y", "a-hat", "b-hat"), new, plain,
                                       old, exact):
        ulps, _, share = kernels.bf16_err(got, ref)
        assert ulps <= mb.BF16_ULPS and share <= mb.BF16_SHARE, (
            name, ulps, share)
        farther(got, was, ex, mb.BF16_ULPS, mb.BF16_SHARE)


@pytest.mark.parametrize("case", CASES)
def test_backward_pointwise_orders(case):
    B, C, M, S, relu, _ = case
    x, dwk, pwk, _, g = inputs(B, C, M, S, seed=1)
    _, ahat, bhat, _, rstd_b = mb.stage_fwd_plain(x, dwk, pwk, None, relu)
    gah_p, gpw_p = mb.stage_bwd_pw_plain(g, ahat, bhat, rstd_b, pwk, relu)
    args = (planes(g), planes(ahat), planes(bhat), rstd_b, pwk, relu)
    (gah, gpw), (gah_o, gpw_o), (gah_x, gpw_x) = (
        backward(*args, o) for o in ("new", "old", "f64"))
    ulps, _, share = kernels.bf16_err(gah, planes(gah_p))
    assert ulps <= mb.BF16_ULPS and share <= mb.BF16_SHARE, (ulps, share)
    farther(gah, gah_o, gah_x, mb.BF16_ULPS, mb.BF16_SHARE)
    top = float(gpw_p.abs().max())
    assert float((gpw - gpw_p[:, :, 0, 0]).abs().max()) <= mb.BF16_DW * top
    assert (float((gpw - gpw_x).abs().max())
            <= float((gpw_o - gpw_x).abs().max()) + mb.BF16_DW * top)


def test_grad_runs_cover_the_axis():
    """Every (sample, pixel) of dW's sum lies in exactly one run, in both
    splits, at the teacher and at CycleGAN's batch 1; the new split writes
    fewer partials."""
    for B, C, M, n in ((4, 256, 256, 4096), (1, 256, 256, 4096),
                       (4, 112, 72, 4096), (3, 130, 70, 9 * 33)):
        counts = {}
        for order in ("new", "old"):
            seen = np.zeros((B, n), int)
            runs = grad_runs(B, C, M, n, order)
            for run in runs:
                for b, p0, p1 in run:
                    seen[b, p0:p1] += 1
            assert (seen == 1).all(), (B, C, M, n, order)
            counts[order] = len(runs)
        assert counts["new"] <= counts["old"]
    assert len(grad_runs(4, 256, 256, 4096, "new")) == 32


def test_build_covers_the_bf16_library(monkeypatch, tmp_path):
    """SIGNATURES registers mobile_block_bf16.cu's entry points (so build()
    compiles it with the others), the bf16 wrappers launch from it, and its
    library's name follows its source and the shared headers."""
    assert set(kernels.SIGNATURES["mobile_block_bf16"]) == {
        "gcc_stage_fwd_bf16", "gcc_stage_bwd_pw_bf16_partials",
        "gcc_stage_bwd_pw_bf16"}
    assert not {"gcc_stage_fwd_bf16", "gcc_stage_bwd_pw_bf16"} & set(
        kernels.SIGNATURES["mobile_block"])
    assert mb._LIBRARY["_bf16"] == "mobile_block_bf16"
    assert (kernels.CSRC / "mobile_block_bf16.cu").exists()
    path = kernels._lib_path("mobile_block_bf16")
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libmobile_block_bf16_")
    for name in ("mobile_block_bf16.cu", "bf16_mma.cuh", "stage_common.cuh",
                 "tf32_mma.cuh"):
        (tmp_path / name).write_bytes((kernels.CSRC / name).read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    first = kernels._lib_path("mobile_block_bf16")
    (tmp_path / "stage_common.cuh").write_text("// edited\n")
    assert kernels._lib_path("mobile_block_bf16") != first
