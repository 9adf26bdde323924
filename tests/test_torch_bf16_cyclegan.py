"""CycleGAN in bf16 (``--compute_dtype bfloat16``, the JAX package's
default) against gcc_tpu's bf16 run on the CPU.

Same weights, same numpy batches, both sides in bf16 with fp32 parameters,
by tests/torch_bf16_common.py's rules: a single-rounding layer within one
bf16 ulp of gcc_tpu's output, a composed result at rms(port_bf16 -
jax_bf16) <= 1/4 rms(jax_bf16 - fp32) unless STEP_BOUNDS names it with its
cause. gcc_tpu's programs are compiled with xla_allow_excess_precision off.

The teacher generator's forward runs fused (kernel B2's bf16 plain versions
in the port, gcc_tpu's Pallas stage kernels in interpret mode), the pruned
student's unfused; the composed iteration runs unfused on both sides
(tests/test_torch_cyclegan.py's configuration: 32 px, batch 2, pools at 0,
G_A's student pruned with block 4 elided), which spares the JAX compile of
the fused stages of eight generator passes; the port's fused engine is held
to the B2 bf16 entry points by the launch audit below. The trajectory
reuses the step's compiled program: the configuration's learning rate (the
teachers') is 0 and the students step at 2e-4. The step and the trajectory
are in tests/test_torch_bf16_cyclegan_step.py.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.config import Config as JaxConfig  # noqa: E402
from gcc_tpu.engines.common import pool_init, pool_query  # noqa: E402
from gcc_tpu.engines.cyclegan import CycleGANEngine as JaxEngine  # noqa: E402
from gcc_tpu.models.discriminators import PatchGAN as JaxPatchGAN  # noqa: E402
from gcc_tpu.models.generators import (  # noqa: E402
    MobileResnetGenerator as JaxMobileResnet,
)
from gcc_tpu_torch.engines.common import weight_params  # noqa: E402
from gcc_tpu_torch.models.discriminators import PatchGAN  # noqa: E402
from gcc_tpu_torch.models.generators import MobileResnetGenerator  # noqa: E402
from gcc_tpu_torch.ops import mobile_block as mb  # noqa: E402
from gcc_tpu_torch.ops.kernels import bf16_err  # noqa: E402
from gcc_tpu_torch.ops.pool import ReplayPool  # noqa: E402
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    from_jax_nets, load_jax_variables,
)
from torch_bf16_common import (  # noqa: E402
    BF, EXACT, assert_same_bits, bf16_round, f32, jax_tree, joint_ratio,
    leaves, max_ulps, nchw, nhwc, fp32_only_forwards, ratio, state_leaves,
)
from torch_limits import one_thread  # noqa: E402,F401
from torch_bf16_cyclegan_common import CFG_A, KW, LR, _np, setup  # noqa: E402


# ---------------------------------------------------------------------------
# the replay pool and the networks
# ---------------------------------------------------------------------------

def test_pool_dtypes():
    """A pool of 3 queried with bf16 images: the buffer stays fp32 and holds
    the images' values, each query returns bf16 (gcc_tpu/engines/common.py:
    345-374), and while the pool fills it returns the images themselves,
    as gcc_tpu's pool_query does; once full, every returned image is one
    of the images it was given."""
    rng = np.random.RandomState(0)
    imgs = [bf16_round(rng.rand(2, 8, 8, 3) * 2 - 1) for _ in range(4)]
    pool = ReplayPool(3, (3, 8, 8))
    jpool = pool_init(3, (8, 8, 3))
    gen = torch.Generator().manual_seed(0)
    seen = []
    for i, x in enumerate(imgs):
        out = pool.query(nchw(x).to(BF), gen)
        assert out.dtype == BF and pool.buffer.dtype == torch.float32
        seen += list(nchw(x))
        if i == 0:
            jpool, jout = pool_query(
                jpool, jnp.asarray(x).astype(jnp.bfloat16),
                jax.random.PRNGKey(0))
            assert jout.dtype == jnp.bfloat16
            assert jpool["buffer"].dtype == jnp.float32
            np.testing.assert_array_equal(nhwc(out), f32(jout))
            np.testing.assert_array_equal(nhwc(pool.buffer[:2]),
                                          f32(jpool["buffer"][:2]))
        for img in out.float():
            assert any(torch.equal(img, s) for s in seen)
    assert pool.count == 3


NETS = {
    "g_teacher": (lambda: JaxMobileResnet(ngf=8, use_fused_blocks=True),
                  lambda: MobileResnetGenerator(3, 3, 8,
                                                use_fused_blocks=True)),
    "g_student": (lambda: JaxMobileResnet(ngf=4, cfg=CFG_A,
                                          use_fused_blocks=False),
                  lambda: MobileResnetGenerator(3, 3, 4, cfg=CFG_A,
                                                use_fused_blocks=False)),
    "td": (lambda: JaxPatchGAN(ndf=8, norm="instance"),
           lambda: PatchGAN(3, 8, norm="instance")),
    "d_masked": (lambda: JaxPatchGAN(ndf=8, norm="instance", masked=True),
                 lambda: PatchGAN(3, 8, norm="instance", masked=True)),
}


# The forwards' results held to 1/4 unless named here (None: no ratio
# bound, the first-difference rule alone).
FORWARD_BOUNDS = {
    # the teacher's conv_in (7x7, 3 -> 8) rounds one output of 16,384 to
    # the other bf16 neighbour (the frameworks' fp32 sums in another
    # order); nine instance-normed blocks spread it: g_feat_0..3 and the
    # output at ratio 0.01, 0.25, 0.49, 0.60 and 0.69 (the same generator
    # class as tests/test_torch_bf16.py's resnet teacher, 0.47 there); at
    # an input where conv_in rounds alike, the forward is gcc_tpu's bit for
    # bit (test_teacher_g_backward_bf16)
    "g_teacher": None,
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_bf16(name):
    """Each net's train-mode output and captured features in bf16 from the
    same variables, the teacher G fused (B2's bf16 plain versions against
    gcc_tpu's Pallas stages in interpret mode), the masked D's alphas on
    both sides of its threshold; the fp32 side is the port's fp32 forward.
    Module by module, the first output that differs from gcc_tpu's, if one
    does, is a convolution's, within one bf16 ulp of its largest output in
    at most 1 % of its outputs:
    the frameworks' fp32 sums rounding to different bf16 neighbours. Each
    result at ratio <= 1/4 unless FORWARD_BOUNDS names it. Measured: the
    student G and both D's are gcc_tpu's bit for bit; the teacher
    first differs at conv_in (module docstring of FORWARD_BOUNDS)."""
    from gcc_tpu_torch.ops.layers import Conv, ConvTranspose
    jmake, tmake = NETS[name]
    jmod = jmake()
    rng = np.random.RandomState(5)
    x = (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    v = _np(jmod.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x)))
    if name == "d_masked":
        for node in v["arch"].values():
            node["alpha"] = rng.uniform(0.3, 0.7, node["alpha"].shape
                                        ).astype(np.float32)
    port = tmake().train()
    load_jax_variables(port, v)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    out, mut = jax.jit(lambda v, x: jmod.apply(
        v, x, train=True, capture_intermediates=True,
        mutable=["intermediates"])).lower(v, xb).compile(EXACT)(v, xb)
    inter = mut["intermediates"]
    jb = [out] + [inter[k][0] for k in sorted(inter) if "_feat_" in k]
    order = []
    for mname, mod in port.named_modules():
        if mname in inter:
            mod.register_forward_hook(
                lambda m, i, o, n=mname: order.append((n, m, o)))
    with torch.no_grad():
        got = port(nchw(bf16_round(x)).to(BF))
        order_bf, order[:] = list(order), []
        ref = port(nchw(bf16_round(x)))
    first = next(((n, m, o) for n, m, o in order_bf if not np.array_equal(
        nhwc(o), f32(inter[n]["__call__"][0]))), None)
    if first is not None:
        n, m, o = first
        want = torch.tensor(f32(inter[n]["__call__"][0])).permute(0, 3, 1, 2)
        ulps, _, share = bf16_err(o, want)
        assert isinstance(m, (Conv, ConvTranspose)), n
        assert ulps <= 1.0 and share <= 0.01, n
    outs = [got[0]] + list(got[1])
    assert all(t.dtype == BF for t in outs)
    bound = FORWARD_BOUNDS.get(name, 0.25)
    for i, (p, b, r) in enumerate(zip(outs, jb, [ref[0]] + list(ref[1]))):
        r_ = ratio(nhwc(p), f32(b), nhwc(r))
        assert np.isfinite(r_) and (bound is None or r_ <= bound), \
            f"{name} output {i}: ratio {r_}"


# ---------------------------------------------------------------------------
# the cooperative iteration: train_step + arch_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", ["a", "b"])
def test_teacher_first_difference_bf16(side):
    """Where the step's teacher G (unfused, as in the step) first leaves
    gcc_tpu's on the step's train batch (A for tg_a, B for tg_b), module by
    module: the first output that differs is a convolution's, within one
    bf16 ulp of its largest output in at most 1 % of its outputs. Measured:
    conv_in (7x7, 3 -> 8) in both, 0.018 % and 0.012 % of its outputs."""
    from gcc_tpu_torch.ops.layers import Conv, ConvTranspose
    eng, nets0, batches = setup(0.0)
    A, B, _, _ = batches()
    x = A if side == "a" else B
    jmod = JaxMobileResnet(ngf=8, use_fused_blocks=False)
    v = jax.tree_util.tree_map(jnp.asarray, nets0[f"tg_{side}"])
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    _, mut = jax.jit(lambda v, x: jmod.apply(
        v, x, train=True, capture_intermediates=True,
        mutable=["intermediates"])).lower(v, xb).compile(EXACT)(v, xb)
    inter = mut["intermediates"]
    net = from_jax_nets(eng, nets0).nets[f"tg_{side}"]
    order = []
    for mname, mod in net.named_modules():
        if mname in inter:
            mod.register_forward_hook(
                lambda m, i, o, n=mname: order.append((n, m, o)))
    with torch.no_grad():
        net(nchw(bf16_round(x)).to(BF))
    first = next(((n, m, o) for n, m, o in order if not np.array_equal(
        nhwc(o), f32(inter[n]["__call__"][0]))), None)
    if first is not None:
        n, m, o = first
        want = f32(inter[n]["__call__"][0])
        assert isinstance(m, (Conv, ConvTranspose)), n
        ulps, _, share = bf16_err(o, torch.tensor(want).permute(0, 3, 1, 2))
        assert ulps <= 1.0 and share <= 0.01, n


def test_teacher_d_update_on_jax_fakes_bf16():
    """The teacher D update of the step (both directions, the lsgan loss of
    engines/cyclegan.py:240-252, pools at 0) on gcc_tpu's own teacher
    fakes, so no teacher forward difference enters: the td gradients at
    ratio <= 1/4 against gcc_tpu's bf16 update on the same fakes, its fp32
    run on its fp32 fakes the reference. Measured: 0.022 (0.55 in the
    composed step, STEP_BOUNDS: all of it the teacher forward's)."""
    from gcc_tpu.engines.common import apply_net
    from gcc_tpu.engines.common import d_pair as jax_d_pair
    from gcc_tpu.losses import gan_loss as jax_gan_loss
    from gcc_tpu_torch.engines.common import d_pair
    from gcc_tpu_torch.losses import gan_loss

    eng, nets0, batches = setup(0.0)
    A, B, _, _ = batches()
    jeng = JaxEngine(JaxConfig(**KW), cfg_AtoB=CFG_A)
    jn = jax.tree_util.tree_map(jnp.asarray, nets0)

    def run(nets, A, B):
        tfB = apply_net(jeng.TG_A, nets["tg_a"], A, update_stats=False)[0]
        tfA = apply_net(jeng.TG_B, nets["tg_b"], B, update_stats=False)[0]

        def td_loss(bundle):
            va = {**nets["td_a"], "params": bundle["d_a"]}
            vb = {**nets["td_b"], "params": bundle["d_b"]}
            pra, pfa, _ = jax_d_pair(jeng.TD_A, va, B, tfB,
                                     update_stats=False)
            prb, pfb, _ = jax_d_pair(jeng.TD_B, vb, A, tfA,
                                     update_stats=False)
            g = jeng.gan_mode
            return ((jax_gan_loss(pra, True, g) + jax_gan_loss(pfa, False, g))
                    * 0.5 + (jax_gan_loss(prb, True, g)
                             + jax_gan_loss(pfb, False, g)) * 0.5)

        grads = jax.grad(td_loss)({"d_a": nets["td_a"]["params"],
                                   "d_b": nets["td_b"]["params"]})
        return tfB, tfA, grads

    want = {}
    for dt in (jnp.bfloat16, jnp.float32):
        a, b = (jnp.asarray(x).astype(dt) for x in (A, B))
        want[dt] = jax.jit(run).lower(jn, a, b).compile(EXACT)(jn, a, b)
    tfB, tfA, _ = want[jnp.bfloat16]
    nets = from_jax_nets(eng, nets0).nets
    TDA, TDB = nets["td_a"], nets["td_b"]
    a, b, tfB, tfA = (nchw(f32(x)).to(BF) for x in (A, B, tfB, tfA))
    pra, pfa, _ = d_pair(TDA, b, tfB, update_stats=False)
    prb, pfb, _ = d_pair(TDB, a, tfA, update_stats=False)
    g = eng.gan_mode
    loss = ((gan_loss(pra, True, g) + gan_loss(pfa, False, g)) * 0.5
            + (gan_loss(prb, True, g) + gan_loss(pfb, False, g)) * 0.5)
    params = weight_params(TDA) + weight_params(TDB)
    grads = torch.autograd.grad(loss, params)
    n_a = len(weight_params(TDA))
    port = {**{f"d_a/{k}": v for k, v in leaves(jax_tree(TDA, grads[:n_a]))},
            **{f"d_b/{k}": v for k, v in leaves(jax_tree(TDB, grads[n_a:]))}}
    jb, j32 = (dict(leaves(_np(want[dt][2]))) for dt in (jnp.bfloat16,
                                                         jnp.float32))
    assert set(port) == set(jb)
    got = joint_ratio(port, jb, j32, sorted(port))
    assert got <= 0.25, got


# An input of the step's shape and range at which the teacher G_A's bf16
# forward is gcc_tpu's bit for bit, every module's output and the image (at
# the step's batch A, and at 26 of the first 30 seeds, some convolution
# rounds apart: test_teacher_first_difference_bf16)
SAME_FORWARD_SEED = 1


def test_teacher_g_backward_bf16():
    """The teacher G_A's backward alone: gcc_tpu's jax.vjp and the port's
    autograd of its train-mode forward, from the same bf16 cotangent, on an
    input at which the two forwards agree bit for bit (asserted), so no
    forward difference enters: every parameter gradient together at ratio
    <= 1/4. Measured 0.058 (tg 0.58 in the composed step, STEP_BOUNDS,
    whose teacher forward on batch A first leaves gcc_tpu's at conv_in)."""
    from gcc_tpu.engines.common import apply_net
    eng, nets0, _ = setup(0.0)
    x = (np.random.RandomState(SAME_FORWARD_SEED).rand(2, 32, 32, 3)
         .astype(np.float32) * 2 - 1)
    jeng = JaxEngine(JaxConfig(**KW), cfg_AtoB=CFG_A)
    jn = jax.tree_util.tree_map(jnp.asarray, nets0["tg_a"])
    ct = bf16_round(np.random.RandomState(3).randn(2, 32, 32, 3))

    def run(params, x, c):
        out, vjp = jax.vjp(lambda p: apply_net(
            jeng.TG_A, {**jn, "params": p}, x, update_stats=False)[0],
            params)
        return out, vjp(c.astype(out.dtype))[0]

    want, out_bf = {}, None
    for dt in (jnp.bfloat16, jnp.float32):
        xj = jnp.asarray(x).astype(dt)
        out, grads = jax.jit(run).lower(jn["params"], xj, jnp.asarray(ct)
                                        ).compile(EXACT)(
            jn["params"], xj, jnp.asarray(ct))
        want[dt] = dict(leaves(_np(grads)))
        if dt == jnp.bfloat16:
            out_bf = f32(out)
    net = from_jax_nets(eng, nets0).nets["tg_a"]
    params = weight_params(net)
    out, _ = net(nchw(bf16_round(x)).to(BF))
    assert np.array_equal(nhwc(out), out_bf)
    grads = torch.autograd.grad(out, params, nchw(ct).to(BF))
    port = dict(leaves(jax_tree(net, grads)))
    got = joint_ratio(port, want[jnp.bfloat16], want[jnp.float32],
                      sorted(port))
    assert got <= 0.25, got


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def _stage_launches(eng, state, batches):
    """One train_step + arch_step of a fused engine with every B2 wrapper
    counted by the dtype of its activation (the CPU runs the plain
    versions; on the card each call is one launch of that entry point)."""
    counts = {}
    olds = {k: getattr(mb, k) for k in ("stage_fwd", "stage_bwd_pw",
                                        "stage_bwd_dw")}

    def counted(name, fn):
        def wrapper(first, *a, **k):
            key = f"{name}{'_bf16' if first.dtype == BF else ''}"
            counts[key] = counts.get(key, 0) + 1
            return fn(first, *a, **k)
        return wrapper

    for k, fn in olds.items():
        setattr(mb, k, counted(k, fn))
    try:
        state, m = eng.train_arch_step(state, *batches, LR, 0.9)
    finally:
        for k, fn in olds.items():
            setattr(mb, k, fn)
    return counts, m


def test_fused_engine_runs_the_bf16_stages():
    """The engine with fused blocks on bf16 batches, hooks on every module:
    every output is bf16 (the pools', the fused stages' included), and the
    four generators run B2's bf16 entry points only, as many calls as the
    structure gives (chip_smoke.cyclegan_launches: 4 forwards and 3
    backwards of every existing stage of the four generators an iteration;
    288/216/216 at the reference's cfgs), none of the fp32 ones."""
    eng, nets0, batches = setup(LR, fused_resblock="on", pool_size=2)
    state = from_jax_nets(eng, nets0)
    bad, seen = [], set()

    def hook(mod, inp, out):
        for t in out if isinstance(out, (list, tuple)) else [out]:
            if isinstance(t, torch.Tensor):
                seen.add(type(mod).__name__)
                if t.dtype != BF:
                    bad.append((type(mod).__name__, t.dtype))

    for net in state.nets.values():
        for m in net.modules():
            m.register_forward_hook(hook)
    pool_out = []
    query = ReplayPool.query

    def audited(self, images, gen):
        out = query(self, images, gen)
        pool_out.append(out.dtype)
        return out

    A, B, Av, Bv = (nchw(x).to(BF) for x in batches())
    ReplayPool.query = audited
    try:
        counts, m = _stage_launches(eng, state, ({"A": A, "B": B},
                                                 {"A": Av, "B": Bv}))
    finally:
        ReplayPool.query = query
    assert not bad, bad[:5]
    assert pool_out and all(d == BF for d in pool_out)
    assert {"MobileResnetGenerator", "PatchGAN", "Conv", "MaskGate",
            "TransformConvs"} <= seen
    stages = 2 * sum(1 for b in range(9) if CFG_A[3 + 2 * b] != 0) \
        + 2 * 9 + 2 * 2 * 9  # G_A's and G_B's students, both teachers
    assert counts == {"stage_fwd_bf16": 4 * stages,
                      "stage_bwd_pw_bf16": 3 * stages,
                      "stage_bwd_dw_bf16": 3 * stages}
    assert all(v.dtype == torch.float32 for v in m.values())


def test_set_input_on_both_loader_paths(tmp_path):
    """An unaligned batch with default flags: cli.train's set_input against
    gcc_tpu.cli.train.set_input on a float32 numpy batch (bf16, equal bit
    for bit), and the device cache asked for bf16, as on a card, against
    gcc_tpu's (bf16, within one bf16 ulp)."""
    from gcc_tpu import config as jconfig
    from gcc_tpu.cli.train import set_input as jax_set_input
    from gcc_tpu.data import device_cache as jcache
    from gcc_tpu.data import packed as jpacked
    from gcc_tpu_torch import config as tconfig
    from gcc_tpu_torch.cli.train import set_input
    from gcc_tpu_torch.data import device_cache, packed
    from torch_data_roots import cfg_kw, write_root

    argv = ["--model", "cyclegan"]
    rng = np.random.RandomState(4)
    batch = {k: (rng.rand(2, 8, 8, 3) * 2 - 1).astype(np.float32)
             for k in "AB"}
    want = jax_set_input(jconfig.parse(argv), dict(batch))
    got = set_input(tconfig.parse(argv), dict(batch), "cpu")
    for k in "AB":
        assert got[k].dtype == BF
        np.testing.assert_array_equal(nhwc(got[k]), f32(want[k]))
    kw = cfg_kw(write_root(str(tmp_path / "src"), "unaligned",
                           "resize_and_crop"), "unaligned", "resize_and_crop")
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
    for k in "AB":
        assert a[k].dtype == BF and b[k].dtype == jnp.bfloat16
        assert max_ulps(nhwc(a[k]), f32(b[k])) <= 1.0


def test_fp32_step_unchanged():
    """The fp32 path keeps its bits: one train_step + arch_step in fp32
    with pools of 2 and fused blocks, with today's layers and with their
    fp32-only forwards (torch_bf16_common.fp32_only_forwards), every loss, parameter,
    buffer, pool and first moment equal bit for bit."""
    eng, nets0, batches = setup(LR, fused_resblock="on", pool_size=2)
    A, B, Av, Bv = (nchw(x) for x in batches())
    out = []
    for old in (False, True):
        state = from_jax_nets(eng, nets0)
        with (fp32_only_forwards() if old else contextlib.nullcontext()):
            for _ in range(2):  # the second query draws from full pools
                state, m = eng.train_arch_step(state, {"A": A, "B": B},
                                               {"A": Av, "B": Bv}, LR, 0.9)
        out.append({**{f"loss.{k}": v for k, v in m.items()},
                    **state_leaves(state)})
    assert_same_bits(*out)
