"""The port's attention and spectral norm against the JAX package's.

* The plain pieces of kernel B1 (gcc_tpu_torch.ops.flash_attention) against
  the Pallas flash attention of gcc_tpu.ops.pallas.attention run in
  interpret mode, forward and jax.grad, as tests/test_ops.py:261-313 runs
  it: forward within 2e-5, gradients within 1e-4 (fp32; blockwise online
  softmax against a materialised N x N matrix, reduction order only).
* The fused backward's plain version (attn_bwd_plain: dq, dk and dv from one
  p and ds) against jax.vjp of the Pallas flash attention in interpret mode,
  within 1e-5 * max(|ref|, 1).
* The port's differentiable flash_attention (its own backward, on CPU
  tensors through attn_bwd_plain) against autograd through the plain
  softmax.
* The precision argument of the CUDA backward: its products emulated with
  TF32 operands (float32 bits masked to 10 mantissa bits) miss the port's
  gradient bound of 1e-4 * max(|ref|, 1); split-TF32 ("3xTF32") holds it.
  The same for the CUDA forward (S in fp32, P V^T split-TF32) against O's
  bound of 1e-5 * max(|ref|, 1), up to logits of ~80.
* SelfAttention against the JAX module through both of the port's routes,
  with gamma non-zero: at gamma = 0 attention adds nothing and its q/k/v
  gradients vanish, so a broken backward would pass.
* SpectralConv / SpectralConvTranspose: outputs and the u/v power-iteration
  state over 3 forwards within 1e-5, in train mode with and without
  update_stats and in eval mode.

Arrays are made with numpy: (B, N, d) and NHWC for JAX, transposed to the
port's channel-major (B, d, N) and NCHW at the boundary.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.ops.attention import SelfAttention as JaxSelfAttention  # noqa: E402
from gcc_tpu.ops.pallas.attention import flash_attention as jax_flash  # noqa: E402
from gcc_tpu.ops.spectral import (  # noqa: E402
    SpectralConv as JaxSpectralConv,
    SpectralConvTranspose as JaxSpectralConvTranspose,
)
from gcc_tpu_torch.ops import flash_attention as fa  # noqa: E402
from gcc_tpu_torch.ops.attention import SelfAttention  # noqa: E402
from gcc_tpu_torch.ops.spectral import (  # noqa: E402
    SpectralConv, SpectralConvTranspose,
)
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    export_jax_variables, load_jax_variables,
)
from torch_tf32 import mma_partial, tf32  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401

# (B, N, dq, dv): multi-tile with a ragged tail, the JAX package's own case,
# the student's main-path shape, and widths past one feature/output chunk
CASES = [(2, 130, 8, 8), (2, 300, 16, 24), (1, 1024, 2, 16), (1, 130, 25, 200)]


def _cm(a):
    """(B, N, d) numpy -> channel-major (B, d, N) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 2, 1))))


def _tok(t):
    """channel-major tensor -> (B, N, d) numpy."""
    return np.transpose(t.detach().numpy(), (0, 2, 1))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _qkv(case, seed):
    B, N, dq, dv = case
    R = np.random.RandomState(seed)
    q = (R.randn(B, N, dq) * 0.3).astype(np.float32)
    k = (R.randn(B, N, dq) * 0.3).astype(np.float32)
    v = R.randn(B, N, dv).astype(np.float32)
    co = R.randn(B, N, dv).astype(np.float32)
    return q, k, v, co


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}-N{}-dq{}-dv{}".format(*c))
def test_plain_pieces_match_pallas(case):
    q, k, v, co = _qkv(case, 0)
    out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, 64, 64, True),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(co))

    o, lse = fa.attn_fwd_plain(_cm(q), _cm(k), _cm(v))
    np.testing.assert_allclose(_tok(o), np.asarray(out), atol=2e-5)
    s = np.einsum("bic,bjc->bij", q.astype(np.float64), k.astype(np.float64))
    mx = s.max(-1, keepdims=True)
    lse64 = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), lse64, atol=2e-5)

    do = _cm(co)
    delta = (do * o).sum(1)
    dq = fa.attn_bwd_dq_plain(_cm(q), _cm(k), _cm(v), do, lse, delta)
    dk, dv = fa.attn_bwd_dkv_plain(_cm(q), _cm(k), _cm(v), do, lse, delta)
    for name, a, b in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        np.testing.assert_allclose(_tok(a), np.asarray(b), atol=1e-4,
                                   err_msg=name)


# (B, N, dq, dv, block): a ragged N with several 16-blocks, and one 64-block
BWD_CASES = [(2, 40, 8, 8, 16), (1, 130, 2, 16, 64)]


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: "B{}-N{}-dq{}-dv{}-blk{}".format(*c))
def test_fused_bwd_plain_matches_pallas(case):
    *shape, blk = case
    q, k, v, co = _qkv(shape, 4)
    out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, blk, blk, True),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(co))
    o, lse = fa.attn_fwd_plain(_cm(q), _cm(k), _cm(v))
    do = _cm(co)
    got = fa.attn_bwd_plain(_cm(q), _cm(k), _cm(v), do, lse,
                            (do * o).sum(1))
    for name, a, b in zip(("dq", "dk", "dv"), got, refs):
        b = np.asarray(b)
        np.testing.assert_allclose(_tok(a), b, rtol=0, err_msg=name,
                                   atol=1e-5 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("case", CASES + [(3, 64, 1, 3)],
                         ids=lambda c: "B{}-N{}-dq{}-dv{}".format(*c))
def test_function_grads_match_autograd(case):
    """flash_attention's custom backward (the wrappers' plain route on CPU
    tensors) against autograd through softmax(q k^T) v."""
    q, k, v, co = _qkv(case, 1)
    leaves = [_cm(a).requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*leaves)
    grads = torch.autograd.grad((out * _cm(co)).sum(), leaves)
    ref_leaves = [_cm(a).requires_grad_(True) for a in (q, k, v)]
    ref = fa.attention_reference(*ref_leaves)
    ref_grads = torch.autograd.grad((ref * _cm(co)).sum(), ref_leaves)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    for name, a, b in zip("qkv", grads, ref_grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0, msg=name)
    assert all(n == 0 for n in fa.LAUNCHES.values())


def test_function_backward_runs_fused_plain(monkeypatch):
    """On CPU tensors flash_attention's backward is one attn_bwd_plain call
    (the fused backward's plain version), whose gradients match autograd
    through attention_reference within 1e-5 * max(|ref|, 1)."""
    calls = []
    plain = fa.attn_bwd_plain
    monkeypatch.setattr(fa, "attn_bwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    q, k, v, co = _qkv((2, 96, 4, 12), 5)
    leaves = [_cm(a).requires_grad_(True) for a in (q, k, v)]
    grads = torch.autograd.grad((fa.flash_attention(*leaves) * _cm(co)).sum(),
                                leaves)
    ref_leaves = [_cm(a).requires_grad_(True) for a in (q, k, v)]
    ref = fa.attention_reference(*ref_leaves)
    ref_grads = torch.autograd.grad((ref * _cm(co)).sum(), ref_leaves)
    assert calls == [1]
    for name, a, b in zip("qkv", grads, ref_grads):
        tol = 1e-5 * max(float(b.abs().max()), 1.0)
        torch.testing.assert_close(a, b, atol=tol, rtol=0, msg=name)


def _emulated_mm(a, b, mode):
    """a @ b with the operands as the kernel would feed the tensor cores,
    each product exact and summed in float64."""
    if mode == "fp32":
        return (a.double() @ b.double()).float()
    ah, bh = tf32(a), tf32(b)
    if mode == "tf32":
        return (ah.double() @ bh.double()).float()
    al, bl = tf32(a - ah), tf32(b - bh)  # split-TF32: x = hi + lo
    return (al.double() @ bh.double() + ah.double() @ bl.double()
            + ah.double() @ bh.double()).float()


@pytest.mark.parametrize("mode", ["fp32", "split", "tf32"])
def test_split_tf32_precision(mode):
    """The fused backward's six products (S, dP, dV, dK, dQ) emulated at
    B 1, N 256, dq 8, dv 64 (q, k at scale 0.5, the kernel's card tests'
    inputs) against float64: fp32 and split-TF32 operands hold the port's
    gradient bound of 1e-4 * max(|ref|, 1) with a wide margin, plain TF32
    misses it on every gradient."""
    R = np.random.RandomState(6)
    B, N, dq, dv = 1, 256, 8, 64
    q, k = (torch.from_numpy((R.randn(B, dq, N) * 0.5).astype(np.float32))
            for _ in range(2))
    v, do = (torch.from_numpy(R.randn(B, dv, N).astype(np.float32))
             for _ in range(2))
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    s64 = torch.einsum("bci,bcj->bij", q64, k64)
    lse64 = torch.logsumexp(s64, -1)
    p64 = torch.exp(s64 - lse64[..., None])
    delta64 = (do64 * torch.einsum("bij,bcj->bci", p64, v64)).sum(1)
    refs = fa.attn_bwd_plain(q64, k64, v64, do64, lse64, delta64)

    lse, delta = lse64.float(), delta64.float()
    qt, kt, dot = (t.transpose(1, 2) for t in (q, k, do))  # (B, N, d)
    p = torch.exp(_emulated_mm(qt, k, mode) - lse[..., None])
    ds = p * (_emulated_mm(dot, v, mode) - delta[..., None])
    got = (_emulated_mm(ds, kt, mode).transpose(1, 2),
           _emulated_mm(ds.transpose(1, 2), qt, mode).transpose(1, 2),
           _emulated_mm(p.transpose(1, 2), dot, mode).transpose(1, 2))
    for name, a, b in zip(("dq", "dk", "dv"), got, refs):
        err = float((a.double() - b).abs().max())
        tol = 1e-4 * max(float(b.abs().max()), 1.0)
        if mode == "tf32":
            assert err > tol, f"{name}: plain TF32 err {err} within {tol}"
        else:
            assert err < tol / 10, f"{name}: {mode} err {err}, tol {tol}"


# (dq, dv) of the SAGAN main path's attn2: teacher, student
FWD_WIDTHS = {"teacher": (8, 64), "student": (2, 16)}


@pytest.mark.parametrize("mode", ["kernel", "tf32"])
@pytest.mark.parametrize("scale", [0.5, 2.0])
@pytest.mark.parametrize("width", sorted(FWD_WIDTHS))
def test_fwd_precision(width, scale, mode):
    """The CUDA forward emulated at N 1024 against float64, q and k at scale
    0.5 (max |S| ~ 5) and 2.0 (max |S| ~ 60-80): "kernel" does what
    gcc_attn_fwd does, S = q^T k in fp32, the online softmax over 64-key
    tiles, each tile's P V^T from split-TF32 operands into a zeroed partial
    (truncating accumulation) and O = alpha O + partial in fp32; it holds O
    within half the port's bound of 1e-5 * max(|ref|, 1). Plain TF32
    operands in both products miss the bound."""
    dq, dv = FWD_WIDTHS[width]
    R = np.random.RandomState(7)
    N = 1024
    q, k = (torch.from_numpy((R.randn(dq, N) * scale).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(R.randn(dv, N).astype(np.float32))
    ref = torch.softmax(q.double().T @ k.double(), -1) @ v.double().T

    s = _emulated_mm(q.T, k, "fp32" if mode == "kernel" else mode)
    o = torch.zeros(N, dv)
    m = torch.full((N, 1), -float("inf"))
    l = torch.zeros(N, 1)
    for j in range(0, N, 64):
        st = s[:, j:j + 64]
        mn = torch.maximum(m, st.max(-1, keepdim=True).values)
        alpha, p = torch.exp(m - mn), torch.exp(st - mn)
        l, m = l * alpha + p.sum(-1, keepdim=True), mn
        o = o * alpha + mma_partial(p, v[:, j:j + 64].T.contiguous(),
                                    "split" if mode == "kernel" else mode)
    err = float(((o / l).double() - ref).abs().max())
    tol = 1e-5 * max(float(ref.abs().max()), 1.0)
    if mode == "tf32":
        assert err > tol, f"plain TF32 err {err} within {tol}"
    else:
        assert err < tol / 2, f"kernel's arithmetic: err {err}, tol {tol}"


@pytest.mark.parametrize("route", ["flash", "einsum"])
def test_self_attention_matches_jax(route):
    """32x32 input (N = 1024, the G's attn2), C 16 -> cq 2, gamma 0.5:
    output, and the gradients of every parameter and of the input."""
    R = np.random.RandomState(2)
    x = R.randn(2, 32, 32, 16).astype(np.float32)
    w = R.randn(2, 32, 32, 16).astype(np.float32)
    jm = JaxSelfAttention()
    v = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(0),
                                                 jnp.asarray(x)))
    v["params"]["gamma"] = np.float32(0.5)

    def jloss(params, xx):
        return jnp.sum(jm.apply({"params": params}, xx) * w)

    jy = np.asarray(jm.apply(v, jnp.asarray(x)))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(v["params"], jnp.asarray(x))

    tm = SelfAttention(16, flash_threshold=1024 if route == "flash" else 2 ** 30)
    load_jax_variables(tm, v)
    xt = _nchw(x).requires_grad_(True)
    y = tm(xt)
    np.testing.assert_allclose(_nhwc(y), jy, atol=2e-5)
    params = dict(tm.named_parameters())
    names = sorted(params)
    gs = torch.autograd.grad((y * _nchw(w)).sum(), [params[n] for n in names]
                             + [xt])
    with torch.no_grad():  # the port's grads, exported in the JAX layout
        for n, g in zip(names, gs):
            params[n].copy_(g)
    gtree = export_jax_variables(tm)["params"]
    for path in ("query_conv", "key_conv", "value_conv"):
        for leaf in ("kernel", "bias"):
            b = np.asarray(jgp[path][leaf])
            np.testing.assert_allclose(gtree[path][leaf], b,
                                       atol=1e-4 * max(1.0, np.abs(b).max()),
                                       err_msg=f"{path}/{leaf}")
    b = float(jgp["gamma"])
    assert abs(float(gtree["gamma"]) - b) <= 1e-4 * max(1.0, abs(b))
    b = np.asarray(jgx)
    np.testing.assert_allclose(_nhwc(gs[-1]), b,
                               atol=1e-4 * max(1.0, np.abs(b).max()))
    # gamma != 0: the q/k gradients are live
    assert np.abs(np.asarray(jgp["query_conv"]["kernel"])).max() > 1e-3


@pytest.mark.parametrize("kind", ["conv", "transpose"])
@pytest.mark.parametrize("mode", ["train", "frozen", "eval"])
def test_spectral_forwards_and_state(kind, mode):
    """Three forwards: outputs and u/v after each within 1e-5. 'train' stores
    the iterated vectors (JAX: spectral mutable), 'frozen' is a train-mode
    forward with update_stats=False and 'eval' an eval-mode forward (JAX:
    not mutable): both leave u/v as they were. The first forward's kernel
    gradient (through W only; u, v are constants) within 1e-5 * max|ref|
    (it scales with 1/sigma, here ~50)."""
    R = np.random.RandomState(3)
    if kind == "conv":
        jm, tm = JaxSpectralConv(6), SpectralConv(5, 6)
        xs = [R.randn(2, 8, 8, 5).astype(np.float32) for _ in range(3)]
    else:
        jm, tm = JaxSpectralConvTranspose(6), SpectralConvTranspose(5, 6)
        xs = [R.randn(2, 4, 4, 5).astype(np.float32) for _ in range(3)]
    v = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(4),
                                                 jnp.asarray(xs[0])))
    load_jax_variables(tm, v)
    tm.train(mode != "eval")
    mutable = ["spectral"] if mode == "train" else []
    for step, x in enumerate(xs):
        if mutable:
            jy, mut = jm.apply(v, jnp.asarray(x), mutable=mutable)
            v = {**v, **jax.tree_util.tree_map(np.array, mut)}
        else:
            jy = jm.apply(v, jnp.asarray(x))
        y = tm(_nchw(x), update_stats=mode != "frozen")
        np.testing.assert_allclose(_nhwc(y), np.asarray(jy), atol=1e-5,
                                   err_msg=f"forward {step}")
        for leaf in ("u", "v"):
            np.testing.assert_allclose(getattr(tm, leaf).numpy(),
                                       v["spectral"][leaf], atol=1e-5,
                                       err_msg=f"forward {step} {leaf}")
        if step == 0:
            gw = R.randn(*np.asarray(jy).shape).astype(np.float32)
            jg = jax.grad(lambda p: jnp.sum(jm.apply(
                {**v, "params": p}, jnp.asarray(x)) * gw))(v["params"])
            (tg,) = torch.autograd.grad(
                (tm(_nchw(x), update_stats=False) * _nchw(gw)).sum(),
                [tm.weight])
            with torch.no_grad():
                saved = tm.weight.clone()
                tm.weight.copy_(tg)
            got = export_jax_variables(tm)["params"]["kernel"]
            with torch.no_grad():
                tm.weight.copy_(saved)
            b = np.asarray(jg["kernel"])
            np.testing.assert_allclose(got, b,
                                       atol=1e-5 * max(1.0, np.abs(b).max()))
