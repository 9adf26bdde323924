"""SRGAN in bf16 (``--compute_dtype bfloat16``, the JAX package's default)
against gcc_tpu's bf16 run on the CPU.

Same weights, same numpy batches, both sides in bf16 with fp32 parameters,
by tests/torch_bf16_common.py's rules: a single-rounding layer within one
bf16 ulp of gcc_tpu's output, a composed result at rms(port_bf16 -
jax_bf16) <= 1/4 rms(jax_bf16 - fp32) unless STEP_BOUNDS names it with its
cause. gcc_tpu's programs are compiled with xla_allow_excess_precision off.

What runs in bf16. gcc_tpu's SRGAN engine feeds its discriminators and the
VGG19 perceptual term imagenet-normalised images, and to_imagenet_norm
subtracts and divides by numpy float32 constants (gcc_tpu/metrics/vgg.py:
65-72), which promote a bf16 image to float32: the generators compute in
bf16, the discriminators and VGG19 in fp32. The port's to_imagenet_norm
promotes the same way (test_imagenet_norm_promotes_to_fp32). The
configuration is tests/test_torch_srgan.py's (ngf 8 / ndf 8, teacher 8/8,
32 px from 8 px, batch 2, vanilla GAN, a pruned student with block 7
elided, the perceptual term on seeded random VGG19 weights).

The cooperative iteration (STEP_BOUNDS, the step and the trajectory):
tests/test_torch_bf16_srgan_step.py.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.metrics.vgg import load_torch_vgg19 as jax_load_vgg  # noqa: E402
from gcc_tpu.metrics.vgg import to_imagenet_norm as jax_imagenet  # noqa: E402
from gcc_tpu.models.discriminators import (  # noqa: E402
    SRGANDiscriminator as JaxSRD,
)
from gcc_tpu.models.generators import SRResNet as JaxSRResNet  # noqa: E402
from gcc_tpu.ops import layers as jl  # noqa: E402
from gcc_tpu_torch.metrics.vgg import (  # noqa: E402
    TruncatedVGG19, load_torch_vgg19, to_imagenet_norm,
)
from gcc_tpu_torch.models.discriminators import SRGANDiscriminator  # noqa: E402
from gcc_tpu_torch.models.generators import SRResNet  # noqa: E402
from gcc_tpu_torch.ops import layers  # noqa: E402
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    from_jax_nets, load_jax_variables,
)
from torch_bf16_common import (  # noqa: E402
    BF, EXACT, assert_same_bits, bf16_round, f32, max_ulps, nchw, nhwc,
    fp32_only_forwards, ratio, state_leaves,
)
from torch_limits import one_thread  # noqa: E402,F401
from torch_bf16_srgan_common import (  # noqa: E402
    FILTERS, LR, _np, setup, vgg_state_dict,
)


# ---------------------------------------------------------------------------
# single-rounding layers
# ---------------------------------------------------------------------------

def _layer(case, rng):
    """(gcc_tpu's module, its variables, the port's, input)."""
    if case == "prelu":
        x = (rng.randn(2, 6, 6, 5) * 2).astype(np.float32)
        v = {"params": {"alpha": np.float32(0.3)}}
        port = layers.PReLU()
        jmod = jl.PReLU()
    elif case == "dense":
        x = (rng.randn(4, 24) * 2).astype(np.float32)
        jmod, port = jl.Dense(3), layers.Dense(24, 3)
        v = {"params": {"kernel": rng.randn(24, 3).astype(np.float32) * 0.3,
                        "bias": rng.randn(3).astype(np.float32)}}
    else:  # sub-pixel conv: conv, pixel shuffle, PReLU
        x = rng.randn(2, 6, 6, 4).astype(np.float32)
        jmod, port = jl.SubPixelConv(4), layers.SubPixelConv(4, (3, 3), 2)
        v = _np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        v["params"]["conv"]["kernel"] = v["params"]["conv"]["kernel"] * 20
        v["params"]["conv"]["bias"] = rng.randn(16).astype(np.float32) * 0.1
        v["params"]["prelu"]["alpha"] = np.float32(0.3)
    load_jax_variables(port, v)
    return jmod, v, port, x


@pytest.mark.parametrize("case", ["prelu", "dense", "subpixel"])
def test_layer_within_one_ulp(case):
    """PReLU (slope rounded to bf16 first), Dense (a bf16 product summed in
    fp32 and rounded, then the fp32 bias added: fp32 out, as gcc_tpu/ops/
    layers.py:249-257) and the sub-pixel conv on bf16 inputs: within one
    bf16 ulp of gcc_tpu's output, in gcc_tpu's dtype. Measured: 0 ulps
    (bit for bit) in each case."""
    jmod, v, port, x = _layer(case, np.random.RandomState(1))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax.jit(lambda v, x: jmod.apply(v, x)).lower(v, xb).compile(
        EXACT)(v, xb)
    xt = torch.tensor(f32(xb)).to(BF)
    got = port(xt if x.ndim == 2 else xt.permute(0, 3, 1, 2))
    assert got.dtype == (torch.float32 if case == "dense" else BF)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    got = f32(got) if x.ndim == 2 else nhwc(got)
    assert max_ulps(got, f32(want)) <= 1.0


def test_imagenet_norm_promotes_to_fp32():
    """to_imagenet_norm of a bf16 image is float32 in both packages, the
    same values: (x + 1) / 2 in bf16, then the fp32 mean and std (numpy
    constants in gcc_tpu, 1-d tensors in the port); VGG19 then computes in
    fp32 on both sides, within 1e-5 of each other."""
    rng = np.random.RandomState(2)
    x = bf16_round(rng.rand(2, 16, 16, 3) * 2 - 1)
    want = jax_imagenet(jnp.asarray(x).astype(jnp.bfloat16))
    got = to_imagenet_norm(nchw(x).to(BF))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    from gcc_tpu.metrics.vgg import TruncatedVGG19 as JaxVGG
    sd = vgg_state_dict()
    vgg = TruncatedVGG19()
    load_jax_variables(vgg, {"params": load_torch_vgg19(sd)})
    with torch.no_grad():
        feat = vgg(got)
    jfeat = JaxVGG().apply({"params": jax_load_vgg(sd)}, want)
    assert feat.dtype == torch.float32 and jfeat.dtype == jnp.float32
    np.testing.assert_allclose(nhwc(feat), np.asarray(jfeat), atol=1e-5,
                               rtol=1e-5)


NETS = {
    "g_teacher": (lambda: JaxSRResNet(n_channels=8),
                  lambda: SRResNet(8), (2, 8, 8, 3)),
    "g_student": (lambda: JaxSRResNet(n_channels=8, filter_cfgs=FILTERS),
                  lambda: SRResNet(8, filter_cfgs=FILTERS), (2, 8, 8, 3)),
    "d_masked": (lambda: JaxSRD(ndf=8, masked=True),
                 lambda: SRGANDiscriminator(8, masked=True), (2, 32, 32, 3)),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_bf16(name):
    """Each net's train-mode output and captured features in bf16 from the
    same variables (the masked D's alphas on both sides of its threshold;
    the D's Dense head comes out fp32): ratio <= 1/4 each. In the engine
    the D takes fp32 images (module docstring); here it takes bf16 ones.
    Measured: at most 5e-5 (the teacher's output); the rest bit for bit."""
    jmake, tmake, shape = NETS[name]
    jmod = jmake()
    rng = np.random.RandomState(5)
    x = (rng.rand(*shape) * 2 - 1).astype(np.float32)
    v = _np(jmod.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x)))
    if name == "d_masked":
        for node in v["arch"].values():
            node["alpha"] = rng.uniform(0.3, 0.7, node["alpha"].shape
                                        ).astype(np.float32)
    port = tmake().train()
    load_jax_variables(port, v)

    def jax_run(dt):
        xd = jnp.asarray(x).astype(dt)
        out, mut = jax.jit(lambda v, x: jmod.apply(
            v, x, train=True, mutable=["batch_stats", "intermediates"])).lower(
            v, xd).compile(EXACT)(v, xd)
        feats = mut["intermediates"]
        return [out] + [feats[k][0] for k in sorted(feats)]

    jb, j32 = jax_run(jnp.bfloat16), jax_run(jnp.float32)
    with torch.no_grad():
        out, feats = port(nchw(bf16_round(x)).to(BF))
    assert out.dtype == (torch.float32 if name == "d_masked" else BF)
    assert all(f.dtype == BF for f in feats)
    for i, (p, b, r) in enumerate(zip([out] + feats, jb, j32)):
        got = ratio(f32(p) if p.dim() == 2 else nhwc(p), f32(b), f32(r))
        assert got <= 0.25, f"{name} output {i}: ratio {got}"


# ---------------------------------------------------------------------------
# the cooperative iteration: train_step + arch_step
# ---------------------------------------------------------------------------


def test_student_first_difference_bf16():
    """Where the step's student G (train mode, the step's batch) first
    leaves gcc_tpu's, module by module: the first output that differs is a
    convolution's or a BatchNorm's (fp32 sums in another order: a conv's
    products, a BatchNorm's batch statistics), within one bf16 ulp of its
    largest output in at most 1 % of its outputs. Measured: block_13_bn1,
    0.26 % of its outputs, 0.004 ulps of its largest."""
    from gcc_tpu_torch.ops.kernels import bf16_err
    eng, nets0, batches, _ = setup()
    (lt, _), _ = batches()
    jmod = JaxSRResNet(n_channels=8, filter_cfgs=FILTERS)
    v = jax.tree_util.tree_map(jnp.asarray, nets0["g"])
    xb = jnp.asarray(lt).astype(jnp.bfloat16)
    _, mut = jax.jit(lambda v, x: jmod.apply(
        v, x, train=True, capture_intermediates=True,
        mutable=["intermediates", "batch_stats"])).lower(v, xb).compile(
        EXACT)(v, xb)
    inter = mut["intermediates"]
    net = from_jax_nets(eng, nets0).nets["g"]
    order = []
    for name, mod in net.named_modules():
        if name in inter:
            mod.register_forward_hook(
                lambda m, i, o, n=name: order.append((n, m, o)))
    with torch.no_grad():
        net(nchw(bf16_round(lt)).to(BF), update_stats=False)
    assert order
    for n, m, o in order:
        want = torch.tensor(f32(inter[n]["__call__"][0])).permute(0, 3, 1, 2)
        if not torch.equal(o.float(), want):
            ulps, _, share = bf16_err(o, want)
            assert isinstance(m, (layers.Conv, layers.BatchNorm)), n
            assert ulps <= 1.0 and share <= 0.01, (n, ulps, share)
            break


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def test_dtypes_through_the_step():
    """Forward hooks on every module of one train_step + arch_step on bf16
    batches: the generators' and the transforms' outputs are bf16; the
    discriminators and VGG19, fed imagenet-normalised images, compute in
    fp32, as gcc_tpu's do (module docstring); every loss is fp32."""
    eng, nets0, batches, _ = setup()
    state = from_jax_nets(eng, nets0)
    dtypes = {}

    def hook(net):
        def fn(mod, inp, out):
            for t in out if isinstance(out, (list, tuple)) else [out]:
                if isinstance(t, torch.Tensor):
                    dtypes.setdefault(net, set()).add(t.dtype)
        return fn

    for name, net in list(state.nets.items()) + [("vgg", eng.vgg)]:
        for m in net.modules():
            m.register_forward_hook(hook(name))
    (lt, ht), (lv, hv) = batches()
    state, m = eng.train_arch_step(
        state, {"lr": nchw(lt).to(BF), "hr": nchw(ht).to(BF)},
        {"lr": nchw(lv).to(BF), "hr": nchw(hv).to(BF)}, LR, 0.9)
    assert dtypes == {"g": {BF}, "tg": {BF}, "tf": {BF},
                      "d": {torch.float32}, "td": {torch.float32},
                      "vgg": {torch.float32}}
    assert all(v.dtype == torch.float32 for v in m.values())


def test_set_input_matches_jax():
    """An sr batch with default flags: cli.train's set_input against
    gcc_tpu.cli.train.set_input on float32 numpy lr and hr (bf16, bit for
    bit)."""
    from gcc_tpu import config as jconfig
    from gcc_tpu.cli.train import set_input as jax_set_input
    from gcc_tpu_torch import config as tconfig
    from gcc_tpu_torch.cli.train import set_input

    argv = ["--model", "srgan"]
    rng = np.random.RandomState(4)
    batch = {"lr": rng.randn(2, 8, 8, 3).astype(np.float32),
             "hr": (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)}
    want = jax_set_input(jconfig.parse(argv), dict(batch))
    got = set_input(tconfig.parse(argv), dict(batch), "cpu")
    for k in ("lr", "hr"):
        assert got[k].dtype == BF
        np.testing.assert_array_equal(nhwc(got[k]), f32(want[k]))


def test_fp32_step_unchanged():
    """The fp32 path keeps its bits: one train_step + arch_step in fp32
    with today's layers and with their fp32-only forwards
    (torch_bf16_common.fp32_only_forwards: PReLU and Dense here), every loss,
    parameter, buffer and first moment equal bit for bit."""
    eng, nets0, batches, _ = setup()
    (lt, ht), (lv, hv) = batches()
    out = []
    for old in (False, True):
        state = from_jax_nets(eng, nets0)
        with (fp32_only_forwards() if old else contextlib.nullcontext()):
            state, m = eng.train_arch_step(
                state, {"lr": nchw(lt), "hr": nchw(ht)},
                {"lr": nchw(lv), "hr": nchw(hv)}, LR, 0.9)
        out.append({**{f"loss.{k}": v for k, v in m.items()},
                    **state_leaves(state)})
    assert_same_bits(*out)
