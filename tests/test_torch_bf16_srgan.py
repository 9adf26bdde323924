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
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.config import Config as JaxConfig  # noqa: E402
from gcc_tpu.engines.common import GANState as JaxState  # noqa: E402
from gcc_tpu.engines.srgan import SRGANEngine as JaxEngine  # noqa: E402
from gcc_tpu.metrics.vgg import load_torch_vgg19 as jax_load_vgg  # noqa: E402
from gcc_tpu.metrics.vgg import to_imagenet_norm as jax_imagenet  # noqa: E402
from gcc_tpu.models.discriminators import (  # noqa: E402
    SRGANDiscriminator as JaxSRD,
)
from gcc_tpu.models.generators import SRResNet as JaxSRResNet  # noqa: E402
from gcc_tpu.ops import layers as jl  # noqa: E402
from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.engines.common import weight_params  # noqa: E402
from gcc_tpu_torch.engines.srgan import SRGANEngine  # noqa: E402
from gcc_tpu_torch.metrics.vgg import (  # noqa: E402
    VGG19_CONV_IDX, TruncatedVGG19, load_torch_vgg19, to_imagenet_norm,
)
from gcc_tpu_torch.models.discriminators import SRGANDiscriminator  # noqa: E402
from gcc_tpu_torch.models.generators import SRResNet  # noqa: E402
from gcc_tpu_torch.ops import layers  # noqa: E402
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    from_jax_nets, load_jax_variables, to_jax_nets,
)
from torch_bf16_common import (  # noqa: E402
    BF, EXACT, FAST, arch_moments, assert_same_bits, bf16_round,
    check_ratio, f32, jax_tree, joint_ratio, leaves, max_ulps,
    nchw, nhwc, one_torch_thread, fp32_only_forwards, ratio, state_leaves,
)

assert one_torch_thread  # the module's autouse fixture

LR = 1e-4
FILTERS = [4, 6, 8, 4, 6, 8, 4, 0, 8, 4, 6, 8, 4, 6, 8, 4]  # block 7 elided
KW = dict(model="srgan", ngf=8, ndf=8, teacher_ngf=8, teacher_ndf=8,
          image_size=32, upscale_factor=4, gan_mode="vanilla",
          online_distillation=True, darts_discriminator=True, lr=LR,
          arch_lr=1e-4, lambda_SR_content=1.0, lambda_SR_adversarial=1e-3,
          lambda_SR_perceptual=1.0, lambda_content=1.0, lambda_gram=1.0,
          lambda_L1=1.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def vgg_state_dict(seed=0):
    """A torchvision-named VGG19 state dict of seeded He-scaled weights
    (tests/test_torch_srgan.py's)."""
    rng = np.random.RandomState(seed)
    sd, in_ch = {}, 3
    for idx in VGG19_CONV_IDX:
        out = 64 * min(2 ** sum(1 for p in (2, 7, 16, 25) if p < idx), 8)
        sd[f"features.{idx}.weight"] = (rng.randn(out, in_ch, 3, 3) * np.sqrt(
            2.0 / (9 * in_ch))).astype(np.float32)
        sd[f"features.{idx}.bias"] = (rng.randn(out) * 0.01).astype(
            np.float32)
        in_ch = out
    return sd


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

def jax_state(jeng, nets):
    """gcc_tpu's step-0 SRGAN state around JAX-layout nets, its own
    optimizer inits (engines/srgan.py:103-131)."""
    nets = jax.tree_util.tree_map(jnp.asarray, nets)
    p = {k: v["params"] for k, v in nets.items()}
    opts = {"g": jeng.tx_g.init({"g": p["g"], "tf": p["tf"]}),
            "d": jeng.tx_d.init(p["d"]), "td": jeng.tx_d.init(p["td"]),
            "tg": jeng.tx_g.init({"g": p["tg"]}),
            "arch": jeng.tx_arch.init(nets["d"]["arch"])}
    return JaxState(step=jnp.int32(0), nets=nets, opts=opts,
                    ema={"d_arch": jnp.float32(0.0)},
                    rng=jax.random.PRNGKey(0))


def port_mu(state):
    """The port's first moments in gcc_tpu's opts layout."""
    nets, opts = state.nets, state.opts
    n_g = len(weight_params(nets["g"]))
    g = opts["g"].mu
    return {"g": {"g": jax_tree(nets["g"], g[:n_g]),
                  "tf": jax_tree(nets["tf"], g[n_g:])},
            "tg": {"g": jax_tree(nets["tg"], opts["tg"].mu)},
            "td": jax_tree(nets["td"], opts["td"].mu),
            "d": jax_tree(nets["d"], opts["d"].mu),
            "arch": arch_moments(nets["d"], opts["arch"])}


_COMPILED = {}


def setup(**kw):
    """The port's engine with the configuration's learning rate 0 (the
    teachers'; the students' is each step's), the JAX-layout nets of its
    seeded init, and the batch source ((lr, hr) train then val)."""
    vgg = vgg_state_dict()
    eng = SRGANEngine(Config(**dict(KW, lr=0.0, arch_lr=0.0, **kw)),
                      filter_cfgs=FILTERS, device="cpu",
                      vgg_params=load_torch_vgg19(vgg))
    nets0 = to_jax_nets(eng.init_state(seed=5))
    rng = np.random.RandomState(5)

    def batches():
        return [((rng.rand(2, 8, 8, 3) * 2 - 1).astype(np.float32),
                 (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32))
                for _ in range(2)]

    return eng, nets0, batches, vgg


def trajectory(n_iters, lr):
    """gcc_tpu's bf16 iterations and the port's bf16 and fp32 ones from the
    port's seeded init on the same batches, the teachers frozen, the
    students at lr (one compile of gcc_tpu's steps serves every lr): per
    iteration the loss dict, nets and first moments as {"jax", BF, fp32}."""
    eng, nets0, batches, vgg = setup()
    states = {dt: from_jax_nets(eng, nets0) for dt in (BF, torch.float32)}
    jeng = JaxEngine(JaxConfig(**dict(KW, lr=0.0, arch_lr=0.0)),
                     filter_cfgs=FILTERS, vgg_params=jax_load_vgg(vgg))
    jst = jax_state(jeng, nets0)
    out = []
    lr_, beta, alr = (jnp.float32(a) for a in (lr, 0.9, lr / 2))
    for _ in range(n_iters):
        (lt, ht), (lv, hv) = batches()
        jb = {"lr": jnp.asarray(lt).astype(jnp.bfloat16),
              "hr": jnp.asarray(ht).astype(jnp.bfloat16)}
        jv = {"lr": jnp.asarray(lv).astype(jnp.bfloat16),
              "hr": jnp.asarray(hv).astype(jnp.bfloat16)}
        if not _COMPILED:
            _COMPILED["train"] = jax.jit(jeng._train_step).lower(
                jst, jb, lr_).compile(FAST)
            _COMPILED["arch"] = jax.jit(jeng._arch_step).lower(
                jst, jv, beta, alr).compile(FAST)
        jst, m1 = _COMPILED["train"](jst, jb, lr_)
        jst, m2 = _COMPILED["arch"](jst, jv, beta, alr)
        rec = {"jax": ({k: float(v) for k, v in {**m1, **m2}.items()},
                       _np(jst.nets),
                       {k: _np(o.mu) for k, o in jst.opts.items()})}
        for dt, st in states.items():
            tb = {"lr": nchw(lt).to(dt), "hr": nchw(ht).to(dt)}
            tv = {"lr": nchw(lv).to(dt), "hr": nchw(hv).to(dt)}
            st, m = eng.train_arch_step(st, tb, tv, lr, 0.9, lr / 2)
            rec[dt] = ({k: float(v) for k, v in m.items()}, to_jax_nets(st),
                       port_mu(st))
        out.append(rec)
    return out


@pytest.fixture(scope="module")
def step():
    """One train_step + arch_step at learning rate 0."""
    return trajectory(1, 0.0)[0]


# Each net's results held to the ratio rule on their own, at 1/4 unless
# named here with the measured ratio and its cause; None: finite only.
STEP_BOUNDS = {
    # the student's forward on the step's batch first leaves gcc_tpu's at
    # block_13_bn1 (test_student_first_difference_bf16), whose fp32 batch
    # statistics, summed in another order, round 0.26 % of its bf16
    # outputs to the other neighbour; its running statistics from block 5
    # on differ at fp32's level, where bf16's own effect on a mean is small
    ("srgan", "stats", "g"): 0.4,  # measured 0.31
    # the arch losses read D outputs on those forwards' fakes, and the
    # alphas' gradient is a reduction of B*H*W bf16 products that XLA on
    # the CPU sums one after the other in bf16 (tests/test_torch_bf16.py)
    ("srgan", "loss", "arch"): 0.4,  # measured 0.30
    ("srgan", "grad", "arch"): 0.5,  # measured 0.40
}
# held apart from the student's other gradients: conv_out's bias (3 values)
# is a sum over the 2048 output pixels of the cotangent at the output, the
# content loss's (fake - hr) among it, and the student's output differs
# from gcc_tpu's in 68 % of its elements after that first difference: it
# adds up in the sum where bf16's rounding noise averages out (measured
# ratio 0.94 alone; 0.57 with the rest, 0.14 without it): finite only
OWN_SUM_LEAVES = {"g/conv_out/bias"}
LOSS_GROUPS = {"D": ("D_fake", "D_real"),
               "G": ("content", "G_GAN", "perceptual", "distill_content",
                     "gram", "L1"),
               "arch": ("D_arch", "D_arch_diff", "teacher_D_arch_diff")}


def test_step_losses_bf16(step):
    """Each update's losses together at ratio <= 1/4 unless STEP_BOUNDS
    names them. Measured: D 0 (bit for bit), G 0.013, arch 0.30."""
    j, b, f = step["jax"][0], step[BF][0], step[torch.float32][0]
    assert set(j) == set(b) == set(f) == {k for g in LOSS_GROUPS.values()
                                          for k in g}
    for group, keys in LOSS_GROUPS.items():
        check_ratio(STEP_BOUNDS, "srgan", "loss", group,
                    joint_ratio(b, j, f, keys))


def test_step_gradients_bf16(step):
    """Each optimizer's gradients (its first moments after one step, 0.1 of
    the gradient at betas (0.9, 0.999)), fp32 and finite, at ratio <= 1/4
    unless STEP_BOUNDS names them, but OWN_SUM_LEAVES. Measured: d 1e-4,
    g 0.14 (without conv_out's bias), td 1e-4, tg 0.03, arch 0.40."""
    jmu, bmu, fmu = step["jax"][2], step[BF][2], step[torch.float32][2]
    assert set(jmu) == set(bmu) == {"g", "d", "tg", "td", "arch"}
    for opt in jmu:
        jl_, bl, fl = (dict(leaves(t[opt])) for t in (jmu, bmu, fmu))
        assert set(jl_) == set(bl) == set(fl), opt
        assert all(v.dtype == np.float32 and np.isfinite(v).all()
                   for v in bl.values())
        keys = sorted(k for k in jl_ if f"{opt}/{k}" not in OWN_SUM_LEAVES
                      and k not in OWN_SUM_LEAVES)
        check_ratio(STEP_BOUNDS, "srgan", "grad", opt,
                    joint_ratio(bl, jl_, fl, keys))


def test_step_batch_stats_bf16(step):
    """Each net's BatchNorm running statistics the iteration's forwards
    wrote, at ratio <= 1/4 unless STEP_BOUNDS names them. Measured: d 0.15,
    td 6e-4, tg 2e-4, g 0.31."""
    nets = [n for n, t in step["jax"][1].items() if "batch_stats" in t]
    assert {"g", "d", "tg", "td"} <= set(nets)
    for net in nets:
        jl_, bl, fl = (dict(leaves(step[k][1][net]["batch_stats"]))
                       for k in ("jax", BF, torch.float32))
        assert set(jl_) == set(bl) == set(fl), net
        check_ratio(STEP_BOUNDS, "srgan", "stats", net,
                    joint_ratio(bl, jl_, fl, sorted(jl_)))


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


def test_loss_trajectory_bf16():
    """Three iterations, the students at lr 1e-4, the teachers frozen (the
    configuration's lr 0: one compile of gcc_tpu's steps): over iterations
    1 and 2 every loss within 1e-4 + 2e-3 |t| of gcc_tpu's bf16 value, the
    classes tests/test_torch_srgan.py holds the fp32 port to, and the port's
    bf16 losses at most half as far from gcc_tpu's bf16 ones as its fp32
    losses are (rms over all losses). Measured: at most 0.38 of a loss's
    bound (teacher_D_arch_diff, iteration 1), 0.17 of the fp32 run's
    distance."""
    num = den = 0.0
    for i, rec in enumerate(trajectory(3, LR)[1:], start=1):
        j, b, f = rec["jax"][0], rec[BF][0], rec[torch.float32][0]
        for k in j:
            assert abs(b[k] - j[k]) <= 1e-4 + 2e-3 * abs(j[k]), \
                f"iteration {i} {k}: jax {j[k]} port {b[k]}"
            num += (b[k] - j[k]) ** 2
            den += (f[k] - j[k]) ** 2
    assert num <= 0.25 * den


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
