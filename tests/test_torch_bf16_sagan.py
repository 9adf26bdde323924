"""SAGAN in bf16 (``--compute_dtype bfloat16``, the JAX package's default)
against gcc_tpu's bf16 run on the CPU, and kernel B1's bf16 plain versions
against gcc_tpu's Pallas attention kernels in interpret mode.

Same weights (every attention gamma non-zero: at gamma 0 attention adds
nothing), same numpy batches, both sides in bf16 with fp32 parameters, by
tests/torch_bf16_common.py's rules: a single-rounding layer within one bf16
ulp of gcc_tpu's output, a composed result at rms(port_bf16 - jax_bf16) <=
1/4 rms(jax_bf16 - fp32) unless STEP_BOUNDS names it with its cause.
gcc_tpu's programs are compiled with xla_allow_excess_precision off.

Routes. The port sends attention of N >= 1024 through flash_attention (its
plain versions here, B1's bf16 kernels on the card); gcc_tpu on the CPU
takes its einsum path at every N (gcc_tpu/ops/attention.py:40-41). Here
gcc_tpu's SelfAttention is sent to its Pallas kernels in interpret mode by
a test-only swap (torch_bf16_common.pallas_route), so the generators' attn2
at N = 1024 runs the TPU path on both sides, and D's attention and G's attn1
(N <= 256) the einsum path on both.

The cooperative iteration (STEP_BOUNDS, the step and the trajectory):
tests/test_torch_bf16_sagan_step.py.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.config import Config as JaxConfig  # noqa: E402
from gcc_tpu.engines.sagan import SAGANEngine as JaxEngine  # noqa: E402
from gcc_tpu.models.discriminators import SAGANDiscriminator as JaxD  # noqa: E402
from gcc_tpu.models.generators import SAGANGenerator as JaxG  # noqa: E402
from gcc_tpu.ops import attention as jattn  # noqa: E402
from gcc_tpu.ops import spectral as jspec  # noqa: E402
from gcc_tpu.ops.pallas import attention as jpallas  # noqa: E402
from gcc_tpu_torch.engines.common import weight_params  # noqa: E402
from gcc_tpu_torch.models.discriminators import SAGANDiscriminator  # noqa: E402
from gcc_tpu_torch.models.generators import SAGANGenerator  # noqa: E402
from gcc_tpu_torch.ops import flash_attention as fa  # noqa: E402
from gcc_tpu_torch.ops.attention import SelfAttention  # noqa: E402
from gcc_tpu_torch.ops.spectral import (  # noqa: E402
    SpectralConv, SpectralConvTranspose,
)
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    export_jax_variables, from_jax_nets, load_jax_variables,
)
from gcc_tpu_torch.ops.kernels import bf16_err  # noqa: E402
from torch_bf16_common import (  # noqa: E402
    BF, EXACT, assert_same_bits, bf16_round, f32, jax_tree, joint_ratio,
    leaves, max_ulps, nchw, nhwc, pallas_route, fp32_only_forwards, ratio, rms,
    share_apart, state_leaves,
)
from torch_limits import one_thread  # noqa: E402,F401
from torch_bf16_sagan_common import (  # noqa: E402
    G_CFG, KW, LR, _gammas, _np, setup,
)


# ---------------------------------------------------------------------------
# kernel B1: the bf16 plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def test_b1_plain_matches_pallas_bf16():
    """attn_fwd_plain and attn_bwd_plain on bf16 q, k, v and dO against
    gcc_tpu.ops.pallas.attention.flash_attention(q, k, v, 256, 512, True)
    and its jax.vjp, at B 2, N 300 (padded to 512: the key sentinel column
    and the padded queries' lse are live), dq 4, dv 32. O, dq, dk and dv are
    bf16, within one bf16 ulp of the tensor's largest value and at most 1 %
    of their elements apart, B1's bf16 bounds on the card (kernels.bf16_err);
    lse (fp32, from _fwd_impl) within 1e-6 relative. Measured: O 0.25 ulps
    with 0.03 % of elements apart, dq 0.03 and 0.04 %, dk 0.0001 and 0.04 %,
    dv 0.06 and 0.02 %."""
    B, N, dq, dv = 2, 300, 4, 32
    rng = np.random.RandomState(0)
    q, k = (bf16_round(rng.randn(B, N, dq) * 0.5) for _ in range(2))
    v, g = (bf16_round(rng.randn(B, N, dv)) for _ in range(2))
    jq, jk, jv, jg = (jnp.asarray(a).astype(jnp.bfloat16)
                      for a in (q, k, v, g))

    def jax_run(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: jpallas.flash_attention(
            q, k, v, 256, 512, True), q, k, v)
        lse = jpallas._fwd_impl(q, k, v, 256, 512, True)[1][:, :q.shape[1]]
        return (out, lse) + vjp(g)

    want = jax.jit(jax_run).lower(jq, jk, jv, jg).compile(EXACT)(
        jq, jk, jv, jg)
    assert all(w.dtype == jnp.bfloat16 for i, w in enumerate(want) if i != 1)

    def cm(a):  # (B, N, d) -> channel-major (B, d, N) bf16
        return torch.from_numpy(np.ascontiguousarray(
            np.transpose(a, (0, 2, 1)))).to(BF)

    tq, tk, tv, tg = (cm(a) for a in (q, k, v, g))
    o, lse = fa.attn_fwd_plain(tq, tk, tv)
    delta = (tg.float() * o.float()).sum(1)
    grads = fa.attn_bwd_plain(tq, tk, tv, tg, lse, delta)
    assert o.dtype == BF and lse.dtype == torch.float32
    assert all(t.dtype == BF for t in grads)
    np.testing.assert_allclose(lse.numpy(), f32(want[1]), rtol=1e-6)
    for name, got, w in zip(("O", "dq", "dk", "dv"), (o,) + grads,
                            (want[0],) + tuple(want[2:])):
        ulps, _, share = bf16_err(got.transpose(1, 2),
                                  torch.tensor(f32(w)))
        assert ulps <= 1.0 and share <= 0.01, (name, ulps, share)


# ---------------------------------------------------------------------------
# single-rounding layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["conv", "conv_transpose"])
def test_spectral_within_one_ulp(case):
    """A spectral conv and transposed conv in train mode on a bf16 input:
    the output within one bf16 ulp of gcc_tpu's (measured 0: bit for bit),
    the iterated u and v (fp32) within 1e-6. The bias is rounded to bf16 and
    added in bf16 (gcc_tpu/ops/spectral.py:86-93): with layers.add_bias's
    fp32 add rounded once instead, 83 % (conv) and 96 % (transposed) of the
    outputs differ from gcc_tpu's, which this test would see."""
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 8, 8, 6) * 2).astype(np.float32)
    if case == "conv":
        jmod, port = jspec.SpectralConv(5, (4, 4), (2, 2), 1), \
            SpectralConv(6, 5)
    else:
        jmod, port = jspec.SpectralConvTranspose(5, (4, 4), (2, 2), 1), \
            SpectralConvTranspose(6, 5)
    v = _np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["params"]["kernel"] = v["params"]["kernel"] * 5
    v["params"]["bias"] = rng.randn(5).astype(np.float32)
    load_jax_variables(port, v)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, mut = jax.jit(lambda v, x: jmod.apply(v, x, mutable=["spectral"])
                        ).lower(v, xb).compile(EXACT)(v, xb)
    assert want.dtype == jnp.bfloat16
    got = port.train()(nchw(f32(xb)).to(BF))
    assert got.dtype == BF
    assert max_ulps(nhwc(got), f32(want)) <= 1.0
    spectral = export_jax_variables(port)["spectral"]
    for k in ("u", "v"):
        np.testing.assert_allclose(spectral[k], np.asarray(mut["spectral"][k]),
                                   atol=1e-6)
    # the other rounding point is visible to this test
    with torch.no_grad():
        raw = (port(nchw(f32(xb)).to(BF)) - port.bias.to(BF)[None, :, None,
                                                             None])
        other = (raw.float() + port.bias[None, :, None, None]).to(BF)
    assert share_apart(nhwc(other), f32(want)) >= 0.5


def _attention(route, rng, hw=8, c=16):
    """(gcc_tpu's SelfAttention, its variables, the port's, NHWC input) for
    a route: 'flash' at a threshold of N (gcc_tpu through pallas_route),
    'einsum' above it."""
    x = (rng.randn(2, hw, hw, c)).astype(np.float32)
    thr = hw * hw if route == "flash" else 2 ** 30
    jmod = jattn.SelfAttention(use_pallas_threshold=thr)
    v = _np(jmod.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    v["params"]["gamma"] = np.float32(-0.3)
    for conv in ("query_conv", "key_conv", "value_conv"):
        v["params"][conv]["kernel"] = v["params"][conv]["kernel"] * 20
        v["params"][conv]["bias"] = (rng.randn(
            *v["params"][conv]["bias"].shape) * 0.1).astype(np.float32)
    port = SelfAttention(c, thr)
    load_jax_variables(port, v)
    return jmod, v, port, x


@pytest.mark.parametrize("route", ["einsum", "flash"])
def test_self_attention_within_one_ulp(route):
    """SelfAttention (N 64, C 16, gamma -0.3) on a bf16 input, on each
    route against gcc_tpu's same route: within one bf16 ulp. The einsum
    route rounds the softmax to bf16 before its product with v, the flash
    route keeps p in fp32 and rounds O (attention.py:45-51; pallas
    attention.py:70). Measured: 0 ulps (bit for bit) on both."""
    jmod, v, port, x = _attention(route, np.random.RandomState(3))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with pallas_route():
        want = jax.jit(lambda v, x: jmod.apply(v, x)).lower(v, xb).compile(
            EXACT)(v, xb)
    before = dict(fa.LAUNCHES)
    got = port(nchw(f32(xb)).to(BF))
    assert got.dtype == BF and fa.LAUNCHES == before  # the CPU launches none
    assert max_ulps(nhwc(got), f32(want)) <= 1.0


def test_flash_and_einsum_routes_in_bf16():
    """The port's two routes from the same weights at N 1024 (C 16): in fp32
    they agree within 1e-5; in bf16 they differ by the rounding of p (the
    einsum route rounds the softmax to bf16, the flash route does not).
    Measured: the bf16 routes 0.5 bf16 ulp of the largest output apart at
    most, in 6.0 % of the outputs, rms 0.40 of the einsum route's bf16 -
    fp32 difference: the rounding of p is much of bf16's error, and why the
    composed steps below send gcc_tpu's attention of N 1024 to its Pallas
    kernels rather than compare the port's flash route with gcc_tpu's einsum
    route."""
    rng = np.random.RandomState(4)
    _, v, flash, x = _attention("flash", rng, hw=32)
    einsum = SelfAttention(16, 2 ** 30)
    load_jax_variables(einsum, v)
    with torch.no_grad():
        xt = nchw(bf16_round(x))
        f32_f, f32_e = flash(xt), einsum(xt)
        bf_f, bf_e = flash(xt.to(BF)), einsum(xt.to(BF))
    assert float((f32_f - f32_e).abs().max()) <= 1e-5
    ulps, _, share = bf16_err(bf_f, bf_e)
    assert ulps <= 1.0 and share <= 0.1
    assert rms(nhwc(bf_f) - nhwc(bf_e)) <= 0.5 * rms(nhwc(bf_e) - nhwc(f32_e))


# ---------------------------------------------------------------------------
# network forwards
# ---------------------------------------------------------------------------

NETS = {
    "g_teacher": (lambda: JaxG(ngf=8, z_dim=8), lambda: SAGANGenerator(
        ngf=8, z_dim=8)),
    "g_student": (lambda: JaxG(ngf=8, z_dim=8, filter_cfgs=G_CFG),
                  lambda: SAGANGenerator(ngf=8, z_dim=8, filter_cfgs=G_CFG)),
    "d_masked": (lambda: JaxD(ndf=8, masked=True, threshold=0.1),
                 lambda: SAGANDiscriminator(ndf=8, masked=True,
                                            threshold=0.1)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_bf16(name):
    """Each net's train-mode output and captured features in bf16 from the
    same variables (gammas non-zero, the masked D's alphas on both sides of
    its threshold), the generators' attn2 on the Pallas route in gcc_tpu:
    ratio <= 1/4 each, and bf16. Measured: at most 6.3e-4 (the teacher's
    output); the D's outputs and features are gcc_tpu's bit for bit."""
    jmake, tmake = NETS[name]
    jmod = jmake()
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8).astype(np.float32) if name.startswith("g") else \
        (rng.rand(2, 64, 64, 3) * 2 - 1).astype(np.float32)
    v = _gammas(_np(jmod.init({"params": jax.random.PRNGKey(1)},
                              jnp.asarray(x))))
    if name == "d_masked":
        for node in v["arch"].values():
            node["alpha"] = rng.uniform(0, 0.3, node["alpha"].shape).astype(
                np.float32)
    port = tmake().train()
    load_jax_variables(port, v)

    def jax_run(dt):
        xd = jnp.asarray(x).astype(dt)
        with pallas_route():
            out, mut = jax.jit(lambda v, x: jmod.apply(
                v, x, train=True, mutable=["batch_stats", "spectral",
                                           "intermediates"])).lower(
                v, xd).compile(EXACT)(v, xd)
        feats = mut["intermediates"]
        return [out] + [feats[k][0] for k in sorted(feats)]

    jb, j32 = jax_run(jnp.bfloat16), jax_run(jnp.float32)
    xt = torch.from_numpy(bf16_round(x)) if name.startswith("g") else \
        nchw(bf16_round(x))
    with torch.no_grad():
        out, feats = port(xt.to(BF))
    assert out.dtype == BF and all(f.dtype == BF for f in feats)
    for i, (p, b, r) in enumerate(zip([out] + feats, jb, j32)):
        got = ratio(f32(p) if p.dim() == 1 else nhwc(p), f32(b), f32(r))
        assert got <= 0.25, f"{name} output {i}: ratio {got}"


# ---------------------------------------------------------------------------
# (continued) where the step's named differences come from
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["tg", "g"])
def test_generator_backward_bf16(which):
    """A generator's backward alone: gcc_tpu's jax.vjp and the port's
    autograd of the step's train-mode generator forward, from the same bf16
    cotangent, on the step's weights and z (attn2 on the Pallas route in
    gcc_tpu): every parameter gradient together at ratio <= 1/4. Measured:
    0.16 (teacher) and 0.11 (student). The teacher's gradients in the
    composed step (STEP_BOUNDS) read in addition the cotangent that the
    teacher D's bf16 backward hands the fake."""
    from gcc_tpu.engines.common import apply_net
    eng, nets0, batches = setup(0.0)
    (z, _), _ = batches()
    jeng = JaxEngine(JaxConfig(**KW), filter_cfgs=G_CFG)
    mod = jeng.TG if which == "tg" else jeng.G
    jn = jax.tree_util.tree_map(jnp.asarray, nets0[which])
    ct = bf16_round(np.random.RandomState(3).randn(2, 64, 64, 3))

    def run(params, z, c):
        out, vjp = jax.vjp(lambda p: apply_net(
            mod, {**jn, "params": p}, z, train=True, update_stats=False)[0],
            params)
        return vjp(c.astype(out.dtype))[0]

    want = {}
    for dt in (jnp.bfloat16, jnp.float32):
        zz = jnp.asarray(z).astype(dt)
        with pallas_route():
            g = jax.jit(run).lower(jn["params"], zz, jnp.asarray(ct)).compile(
                EXACT)(jn["params"], zz, jnp.asarray(ct))
        want[dt] = dict(leaves(_np(g)))
    net = from_jax_nets(eng, nets0).nets[which]
    params = weight_params(net)
    out, _ = net(torch.from_numpy(z).to(BF), update_stats=False)
    grads = torch.autograd.grad(out, params, nchw(ct).to(BF))
    port = dict(leaves(jax_tree(net, grads)))
    assert joint_ratio(port, want[jnp.bfloat16], want[jnp.float32],
                       sorted(port)) <= 0.25


# ---------------------------------------------------------------------------
# the port alone: the dtype stays bf16, and the entry points cast to it
# ---------------------------------------------------------------------------

def test_activations_stay_bf16(monkeypatch):
    """Forward hooks on every module of G, D, the teacher G and D and the
    TransformConvs: each output tensor of one train_step + arch_step on a
    bf16 batch is bf16, and the generators' attn2 (N 1024) goes through
    flash_attention with bf16 q, k and v."""
    from gcc_tpu_torch.ops import attention
    eng, nets0, batches = setup(LR)
    state = from_jax_nets(eng, nets0)
    seen, bad, flash = [], [], []

    def hook(mod, inp, out):
        for t in out if isinstance(out, (list, tuple)) else [out]:
            if isinstance(t, torch.Tensor):
                seen.append(type(mod).__name__)
                if t.dtype != BF:
                    bad.append((type(mod).__name__, t.dtype))

    for net in state.nets.values():
        for m in net.modules():
            m.register_forward_hook(hook)
    orig = attention.flash_attention

    def recorded(q, k, v):
        flash.append((q.dtype, k.dtype, v.dtype))
        return orig(q, k, v)

    monkeypatch.setattr(attention, "flash_attention", recorded)
    (z, real), (zv, realv) = batches()
    state, m = eng.train_arch_step(
        state, {"z": torch.from_numpy(z).to(BF), "real_img": nchw(real).to(BF)},
        {"z": torch.from_numpy(zv).to(BF), "real_img": nchw(realv).to(BF)},
        LR, 0.9)
    assert not bad, bad[:5]
    assert {"SpectralConvTranspose", "SpectralConv", "BatchNorm",
            "SelfAttention", "MaskGate", "ConvTranspose", "Conv",
            "TransformConvs"} <= set(seen)
    assert flash and all(d == (BF, BF, BF) for d in flash)
    assert all(v.dtype == torch.float32 for v in m.values())


def test_set_input_on_both_loader_paths(tmp_path):
    """The batches SAGAN's engine gets with default flags. The host path:
    cli.train's set_input against gcc_tpu.cli.train.set_input on a float32
    numpy batch, z and real_img both bf16 and equal bit for bit. The device
    cache, asked for bf16 as it is on a card: z stays float32 as drawn,
    real_img is bf16, in both packages (equal z, real_img within one bf16
    ulp), so gcc_tpu's generator computes in fp32 there, and the port's
    too: a quirk of the JAX package (ROADMAP Queue C)."""
    from gcc_tpu import config as jconfig
    from gcc_tpu.cli.train import set_input as jax_set_input
    from gcc_tpu.data import device_cache as jcache
    from gcc_tpu.data import packed as jpacked
    from gcc_tpu_torch import config as tconfig
    from gcc_tpu_torch.cli.train import set_input
    from gcc_tpu_torch.data import device_cache, packed
    from torch_data_roots import cfg_kw, write_root

    argv = ["--model", "sagan"]
    rng = np.random.RandomState(4)
    batch = {"z": rng.randn(2, 8).astype(np.float32),
             "real_img": (rng.rand(2, 8, 8, 3) * 2 - 1).astype(np.float32)}
    want = jax_set_input(jconfig.parse(argv), dict(batch))
    got = set_input(tconfig.parse(argv), dict(batch), "cpu")
    assert got["z"].dtype == got["real_img"].dtype == BF
    np.testing.assert_array_equal(f32(got["z"]), f32(want["z"]))
    np.testing.assert_array_equal(nhwc(got["real_img"]),
                                  f32(want["real_img"]))

    kw = cfg_kw(write_root(str(tmp_path / "src"), "sa"), "sa")
    kw["dataroot"] = packed.pack_dataset(tconfig.Config(**kw),
                                         out_dir=str(tmp_path / "p"),
                                         num_threads=2)
    ours = device_cache.DeviceCacheLoader(
        packed.PackedDataset(tconfig.Config(**kw), seed=3), 2, "cpu",
        dtype=BF, seed=3)
    theirs = jcache.DeviceCacheLoader(
        jpacked.PackedDataset(jconfig.Config(**kw), seed=3), 2,
        dtype=jnp.bfloat16, seed=3)
    a, b = next(iter(ours)), next(iter(theirs))
    assert a["z"].dtype == torch.float32 and b["z"].dtype == jnp.float32
    assert a["real_img"].dtype == BF and b["real_img"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(a["z"].numpy(), np.asarray(b["z"]))
    assert max_ulps(nhwc(a["real_img"]), f32(b["real_img"])) <= 1.0
    jg = JaxG(ngf=4, z_dim=8, image_size=32)
    v = jg.init(jax.random.PRNGKey(0), b["z"])
    assert jg.apply(v, b["z"], train=False).dtype == jnp.float32
    g = SAGANGenerator(ngf=4, image_size=32, z_dim=8).eval()
    load_jax_variables(g, _np(v))
    with torch.no_grad():
        assert g(a["z"])[0].dtype == torch.float32


def test_fp32_step_unchanged():
    """The fp32 path keeps its bits: one train_step + arch_step in fp32
    with today's layers and with their fp32-only forwards
    (torch_bf16_common.fp32_only_forwards), every loss, parameter, buffer and
    first moment equal bit for bit."""
    eng, nets0, batches = setup(LR)
    (z, real), (zv, realv) = batches()
    b = {"z": torch.from_numpy(z), "real_img": nchw(real)}
    bv = {"z": torch.from_numpy(zv), "real_img": nchw(realv)}
    out = []
    for old in (False, True):
        state = from_jax_nets(eng, nets0)
        with (fp32_only_forwards() if old else contextlib.nullcontext()):
            state, m = eng.train_arch_step(state, b, bv, LR, 0.9)
        out.append({**{f"loss.{k}": v for k, v in m.items()},
                    **state_leaves(state)})
    assert_same_bits(*out)


def test_cli_logs_bfloat16_for_every_family():
    """cli.train's check_knobs with default flags logs that the run computes
    in bfloat16, for each family; --compute_dtype float32 logs float32."""
    import logging
    from gcc_tpu_torch import config as tconfig
    from gcc_tpu_torch.cli import train as ttrain

    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    logger = logging.getLogger("bf16-families")
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    for model in ("pix2pix", "cyclegan", "sagan", "srgan"):
        for dt in ("bfloat16", "float32"):
            lines.clear()
            argv = ["--model", model] + (["--compute_dtype", dt]
                                         if dt == "float32" else [])
            ttrain.check_knobs(tconfig.parse(argv), logger)
            assert lines[0].startswith(
                f"port: computes in {dt} (--compute_dtype {dt})"), lines
