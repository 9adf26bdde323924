"""bf16 operand pairs and bit-level rounding, for the tests of the arithmetic
of kernel B2's bf16 depthwise backward (csrc/mobile_block_bf16.cu):
tests/test_torch_stage_bf16_dw.py on the CPU, tests/test_torch_kernels.py
on the card. numpy only.

The kernel's transposed taps use Hopper's ``mul.rn.bf16x2`` and
``add.rn.bf16x2``, where the TPU kernel computes ``round_bf16(fp32(a * b))``
and ``round_bf16(fp32(a + b))``.
``emulated_mul``/``emulated_add`` are those fp32 forms, ``exact_mul``/
``exact_add`` a single round to nearest even of the exact result.
"""

import numpy as np

U64 = np.uint64


def _finite(rng, exp_field, m):
    """m bf16 bit patterns with the given exponent fields (0 .. 254; 0 gives
    zeros and subnormals), random signs and mantissas."""
    sign = rng.integers(0, 2, m, dtype=np.uint16) << 15
    man = rng.integers(0, 128, m, dtype=np.uint16)
    return sign | (np.asarray(exp_field, np.uint16) << 7) | man


def bf16_pairs(n=1 << 20, seed=0):
    """(a, b): n pairs of finite bf16 bit patterns (uint16) that span the
    whole exponent range: a quarter uniform over every finite pattern
    (subnormals and zeros of both signs among them), a quarter whose
    exponents differ by 0 .. 30 (b subnormal where that passes the smallest
    normal), a quarter whose exact products lie around the smallest normal
    (2^-160 .. 2^-110) or past the largest (2^120 .. 2^136), and a quarter
    with a zero of either sign or a subnormal on one side."""
    rng = np.random.default_rng(seed)
    q = n // 4
    ea = rng.integers(0, 255, q)
    uniform = (_finite(rng, ea, q), _finite(rng, rng.integers(0, 255, q), q))
    ea = rng.integers(1, 255, q)
    gap = rng.integers(0, 31, q)
    gaps = (_finite(rng, ea, q), _finite(rng, np.maximum(ea - gap, 0), q))
    ea = rng.integers(1, 255, q)
    target = np.where(rng.integers(0, 2, q) == 0, rng.integers(-160, -109, q),
                      rng.integers(120, 137, q))
    eb = np.clip(target + 254 - ea, 0, 254)  # (ea - 127) + (eb - 127) = target
    products = (_finite(rng, ea, q), _finite(rng, eb, q))
    m = n - 3 * q
    zero = rng.integers(0, 2, m, dtype=np.uint16) << 15
    sub = _finite(rng, np.zeros(m, np.int64), m)
    side = np.where(rng.integers(0, 2, m) == 0, zero, sub).astype(np.uint16)
    other = _finite(rng, rng.integers(0, 255, m), m)
    edges = (side, other)
    a = np.concatenate([uniform[0], gaps[0], products[0], edges[0]])
    b = np.concatenate([uniform[1], gaps[1], products[1], edges[1]])
    swap = rng.integers(0, 2, n) == 1  # either operand may be the small one
    return np.where(swap, b, a), np.where(swap, a, b)


def to_f32(bits):
    """bf16 bit patterns as float32 values (exact)."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def f32_to_bf16(f):
    """float32 to bf16 bits, round to nearest even (__float2bfloat16_rn for
    finite values and infinities)."""
    u = np.asarray(f, np.float32).view(np.uint32).astype(U64)
    return ((u + U64(0x7FFF) + ((u >> U64(16)) & U64(1))) >> U64(16)).astype(
        np.uint16)


def rne_bf16(x):
    """float64 to bf16 bits, one round to nearest even, bit by bit: keep the
    top 8 significant bits (down to 2^-133, bf16's subnormal step), round
    the rest half to even, past the largest bf16 to infinity."""
    x = np.asarray(x, np.float64)
    bits = x.view(U64)
    sign = ((bits >> U64(63)) << U64(15)).astype(np.uint16)
    e = ((bits >> U64(52)) & U64(0x7FF)).astype(np.int64) - 1023
    m = (bits & U64((1 << 52) - 1)) | U64(1 << 52)  # x = m 2^(e - 52)
    lsb = np.maximum(e - 7, -133)  # exponent of the result's last bit
    drop = np.minimum(lsb - (e - 52), 63).astype(U64)
    q = m >> drop
    rem = m & ((U64(1) << drop) - U64(1))
    half = U64(1) << (drop - U64(1))
    q = q + ((rem > half) | ((rem == half) & ((q & U64(1)) == U64(1))))
    with np.errstate(over="ignore"):
        val = np.ldexp(q.astype(np.float64), lsb).astype(np.float32)
    out = (val.view(np.uint32) >> np.uint32(16)).astype(np.uint16) | sign
    return np.where(x == 0, sign, out).astype(np.uint16)


def emulated_mul(a, b):
    """round_bf16(fp32(a * b)) of bf16 bit patterns."""
    with np.errstate(over="ignore", under="ignore"):
        return f32_to_bf16(to_f32(a) * to_f32(b))


def emulated_add(a, b):
    """round_bf16(fp32(a + b)) of bf16 bit patterns."""
    with np.errstate(over="ignore"):
        return f32_to_bf16(to_f32(a) + to_f32(b))


def exact_mul(a, b):
    """a * b rounded once: the product of two bf16 values is exact in
    float64 (16 significant bits, exponents within float64's normal range)."""
    return rne_bf16(to_f32(a).astype(np.float64) * to_f32(b).astype(np.float64))


def exact_add(a, b):
    """a + b rounded once: exact in float64 while the exponents differ by at
    most 44; past that float64's rounding moves the sum by less than 2^-97
    of the larger operand, which cannot bring it to a bf16 tie (the smaller
    operand alone is below 2^-44 of the larger, so both sums round to it)."""
    return rne_bf16(to_f32(a).astype(np.float64) + to_f32(b).astype(np.float64))
