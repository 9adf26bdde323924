"""The arithmetic of kernel B1's bf16 forward and backward
(gcc_tpu_torch/csrc/flash_attention_bf16.cu), emulated on the CPU.

The kernels take bf16 q, k, v and dO. S = q^T k and dP = dO v^T have two
bf16 operands: one bf16 ``mma`` each, products exact, sums in fp32. P and
dS are fp32 and meet bf16 operands in P V^T, dV = P^T dO, dK = dS^T q and
dQ = dS k; the kernels split them into bf16 terms, hi = bf16(x) and
lo = bf16(x - hi), one ``mma`` a term. The tensor cores round what they
accumulate toward zero (``torch_tf32.rz32`` after every mma). Each step
below mirrors the kernels: 16-channel (or 16-key) mma steps, the forward's
per-key-tile partial added to O in fp32 after the online softmax's
rescale, the backward's per-16-channel partials of S and dP, its
per-query-tile partials of dK and dV for each half of the 64 queries (two
warps), and dq summed over key tiles in order.

The emulated outputs are held to the port's bf16 rule against the plain
versions (``flash_attention.BF16_ULPS``, ``BF16_SHARE``, ``bf16_share_ok``):
two bf16 terms hold it; one term, P or dS rounded once to bf16, misses it.
Torch and numpy only, no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gcc_tpu_torch.ops import flash_attention as fa  # noqa: E402
from gcc_tpu_torch.ops import kernels  # noqa: E402
from torch_tf32 import rz32  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401

N, TILE = 1024, 64  # the main path's attn2 length; the kernels' key tile
# (dq, dv) of the SAGAN main path's attn2: teacher, student
WIDTHS = {"teacher": (8, 64), "student": (2, 16)}
TERMS = 2  # the kernels' split of P and dS: hi and lo


def _bf16(x):
    return x.bfloat16().float()


def _split(x, terms):
    """x as ``terms`` bf16 values (fp32 tensors): hi, then what hi leaves."""
    parts, rest = [], x
    for _ in range(terms):
        parts.append(_bf16(rest))
        rest = rest - parts[-1]
    return parts


def _mma(parts, b, acc=None):
    """acc + (sum of parts) @ b as the kernels' mma chain: per 16-wide step
    of k, the smallest term first, each mma rounded toward zero."""
    acc = torch.zeros(parts[0].shape[0], b.shape[1], dtype=torch.float64) \
        if acc is None else acc.double()
    for k0 in range(0, b.shape[0], 16):
        for x in reversed(parts):
            acc = rz32(acc + x[:, k0:k0 + 16].double()
                       @ b[k0:k0 + 16].double())
    return acc.float()


def _partials(a, b):
    """a @ b with a zeroed partial a 16-wide step of k, added in fp32."""
    out = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, b.shape[0], 16):
        out = out + _mma([a[:, k0:k0 + 16]], b[k0:k0 + 16])
    return out


def _inputs(dq, dv, scale, seed, B=2):
    R = np.random.RandomState(seed)

    def rnd(d, s=1.0):
        return torch.from_numpy((R.randn(B, d, N) * s).astype(np.float32)
                                ).bfloat16()

    return rnd(dq, scale), rnd(dq, scale), rnd(dv), rnd(dv)


def emulate_fwd(q, k, v, terms):
    """gcc_attn_fwd_bf16's arithmetic: (O bf16, lse fp32)."""
    outs, lses = [], []
    for qb, kb, vb in zip(q.float(), k.float(), v.float()):
        s = _mma([qb.T.contiguous()], kb)  # (queries, keys)
        o = torch.zeros(N, vb.shape[0])
        m = torch.full((N, 1), -float("inf"))
        l = torch.zeros(N, 1)
        for j in range(0, N, TILE):
            st = s[:, j:j + TILE]
            mn = torch.maximum(m, st.max(-1, keepdim=True).values)
            alpha, p = torch.exp(m - mn), torch.exp(st - mn)
            l, m = l * alpha + p.sum(-1, keepdim=True), mn
            o = o * alpha + _mma(_split(p, terms),
                                 vb[:, j:j + TILE].T.contiguous())
        outs.append((o / l).T)
        lses.append((m + torch.log(l))[:, 0])
    return torch.stack(outs).bfloat16(), torch.stack(lses)


def emulate_bwd(q, k, v, do, lse, delta, terms):
    """gcc_attn_bwd_bf16's arithmetic: (dq, dk, dv) bf16, one key-tile
    group a key tile."""
    grads = []
    for qb, kb, vb, dob, lb, db in zip(q.float(), k.float(), v.float(),
                                       do.float(), lse, delta):
        # transposed, as the kernel holds them: rows keys, columns queries
        st = _partials(kb.T.contiguous(), qb)
        pt = torch.exp(st - lb[None])
        dpt = _partials(vb.T.contiguous(), dob)
        dst = pt * (dpt - db[None])
        dk_h = [torch.zeros(N, qb.shape[0]) for _ in range(2)]
        dv_h = [torch.zeros(N, vb.shape[0]) for _ in range(2)]
        for i in range(0, N, TILE):
            for h in range(2):  # the two warps of a key group
                cols = slice(i + 32 * h, i + 32 * h + 32)
                dv_h[h] = dv_h[h] + _mma(_split(pt[:, cols], terms),
                                         dob[:, cols].T.contiguous())
                dk_h[h] = dk_h[h] + _mma(_split(dst[:, cols], terms),
                                         qb[:, cols].T.contiguous())
        dq = torch.zeros(N, qb.shape[0])
        ds = dst.T.contiguous()
        for j in range(0, N, TILE):
            dq = dq + _mma(_split(ds[:, j:j + TILE], terms),
                           kb[:, j:j + TILE].T.contiguous())
        grads.append((dq.T, (dk_h[0] + dk_h[1]).T, (dv_h[0] + dv_h[1]).T))
    return tuple(torch.stack(g).bfloat16() for g in zip(*grads))


def _rule(got, plain, exact=None):
    """(within the bf16 rule, ulps of max |plain|, share apart)."""
    ulps, _, _ = kernels.bf16_err(got, plain)
    ok, share, _, _ = fa.bf16_share_ok(got, plain, exact)
    return ulps <= fa.BF16_ULPS and ok, ulps, share


@pytest.mark.parametrize("terms", [1, TERMS])
@pytest.mark.parametrize("scale", [0.5, 2.0])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_fwd_split(width, scale, terms):
    """O from P split into ``terms`` bf16 terms against attn_fwd_plain: two
    terms hold the rule (measured: 0.05-0.25 % of O apart, within 0.5
    ulps; three: 0.02-0.05 %); one term puts 8-42 % of O apart; lse within
    1e-5."""
    dq, dv = WIDTHS[width]
    q, k, v, _ = _inputs(dq, dv, scale, seed=11)
    o, lse = emulate_fwd(q, k, v, terms)
    o_p, lse_p = fa.attn_fwd_plain(q, k, v)
    assert float((lse - lse_p).abs().max()) <= 1e-5 * max(
        float(lse_p.abs().max()), 1.0)
    ok, ulps, share = _rule(o, o_p)
    if terms == TERMS:
        assert ok, (ulps, share)
    else:
        assert not ok and share > 0.05, (ulps, share)


def _bwd_case(scale, terms):
    dq, dv = WIDTHS["teacher"]
    q, k, v, do = _inputs(dq, dv, scale, seed=12, B=1)
    o, lse = fa.attn_fwd_plain(q, k, v)
    args = (q, k, v, do, lse, (do.float() * o.float()).sum(1))
    return args, emulate_bwd(*args, terms), fa.attn_bwd_plain(*args)


@pytest.mark.parametrize("terms", [1, TERMS])
@pytest.mark.parametrize("grad", ["dk", "dv"])
def test_bwd_dk_dv_split(grad, terms):
    """dk and dv at the teacher's shape (q, k scale 0.5) from P and dS split
    into ``terms`` bf16 terms: two hold the rule against attn_bwd_plain
    (measured: 0.31 % of dk and 0.25 % of dv apart, within 0.25 ulps), one
    misses it (43 % and 45 % apart)."""
    _, got, plain = _bwd_case(0.5, terms)
    i = {"dk": 1, "dv": 2}[grad]
    ok, ulps, share = _rule(got[i], plain[i])
    if terms == TERMS:
        assert ok, (ulps, share)
    else:
        assert not ok and share > 0.1, (ulps, share)


@pytest.mark.parametrize("terms", [1, TERMS])
def test_bwd_dq_wide_logit(terms):
    """dq at wide_logit's q, k scale 2 (ill-conditioned: ds = p (dP - delta)
    cancels): with two terms within the rule (measured: 0.70 % apart,
    0.125 ulps; 1.11 % from the float64 answer's rounding, the plain
    version 1.07 %); with one, 48 % apart and 48 % from that rounding."""
    args, got, plain = _bwd_case(2.0, terms)
    exact = fa.attn_bwd_plain(*(t.double() for t in args))[0]
    ok, ulps, share = _rule(got[0], plain[0], exact)
    if terms == TERMS:
        assert ok, (ulps, share)
    else:
        assert not ok, (ulps, share)
