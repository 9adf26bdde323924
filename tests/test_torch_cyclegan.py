"""CycleGAN in the port against the JAX engine (gcc_tpu.engines.cyclegan).

* The online-distillation iteration (teacher G joint over both directions
  with the heavy sparsity injection, teacher D on its pools, student G with
  cycle, identity, plain-MSE distillation and L1 to the teacher, student D
  on the pooled fakes, the per-direction arch step) over 3 iterations from
  the same weights on the same numpy batches, ngf 4 / ndf 8, teacher 8/8,
  32 px, batch 2, pools at 0 (a coin flip cannot be shared across
  frameworks), unfused blocks. G_A's student is pruned, one block elided.
* normal_distillation (frozen teachers) over 2 iterations at 80 px, where
  the blocks are 20 px a side and the fused gate opens: the port with
  ``--fused_resblock on`` (the stage kernels' plain versions on the CPU)
  against the JAX engine unfused.
* The replay pool's semantics, the discriminators and generator against
  flax's, the weights mapping, and the engine's refusal without a card.

The JAX state is made from the port's initial nets (``to_jax_nets``) and
the JAX optimizers' own init, which skips flax's op-by-op init; the JAX
steps are compiled with LLVM's expensive passes off, which changes their
speed, not their arithmetic.

Bounds, the classes of tests/test_cooperative_parity_cyclegan.py: losses
within 1e-4 + 2e-3*|t|, but the arch keys, which read the teachers after
their update (3e-2); after one iteration every conv kernel within
1e-6 but for isolated entries that took opposite Adam steps (a gradient
~0 whose sign is fp noise: |delta| <= 2*lr), counted and printed; after 3
iterations kernels within 2*lr*N*1.25 with a mean under lr/2, alphas with
a mean under 2*arch_lr, BatchNorm stats within 5e-4. The conv biases that
feed an affine-free InstanceNorm have no gradient and random-walk at +-lr
on both sides: forward-inert, not compared.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.config import Config as JaxConfig  # noqa: E402
from gcc_tpu.engines.common import GANState as JaxState  # noqa: E402
from gcc_tpu.engines.common import add_sign_sparsity as jax_sparsity  # noqa: E402
from gcc_tpu.engines.common import cyclegan_heavy_sparsity as jax_heavy  # noqa: E402
from gcc_tpu.engines.cyclegan import CycleGANEngine as JaxEngine  # noqa: E402
from gcc_tpu.models.discriminators import PatchGAN as JaxPatchGAN  # noqa: E402
from gcc_tpu.models.generators import (  # noqa: E402
    MobileResnetGenerator as JaxMobileResnet,
)
from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.engines.common import (  # noqa: E402
    add_sign_sparsity, cyclegan_heavy_sparsity, weight_params,
)
from gcc_tpu_torch.engines.cyclegan import CycleGANEngine  # noqa: E402
from gcc_tpu_torch.models.discriminators import PatchGAN  # noqa: E402
from gcc_tpu_torch.models.generators import MobileResnetGenerator  # noqa: E402
from gcc_tpu_torch.ops import mobile_block  # noqa: E402
from gcc_tpu_torch.ops.layers import init_params  # noqa: E402
from gcc_tpu_torch.ops.pool import ReplayPool  # noqa: E402
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    export_jax_variables, from_jax_nets, load_jax_variables, to_jax_nets,
)

LR, ARCH_LR, N_ITERS = 2e-4, 1e-4, 3
KW = dict(model="cyclegan", ngf=4, ndf=8, teacher_ngf=8, teacher_ndf=8,
          crop_size=32, gan_mode="lsgan", online_distillation=True,
          darts_discriminator=True, pool_size=0, lr=LR, arch_lr=ARCH_LR,
          lambda_A=10.0, lambda_B=10.0, lambda_identity=0.5,
          lambda_content=0.01, lambda_gram=10.0, lambda_L1=1.0,
          lambda_weight=1e-3, fused_resblock="off")
# G_A's student: [c7, d1, d2, (l1, l2) x 9, u1, u2], block 4 elided
CFG_A = [3, 6, 12, 5, 12, 7, 12, 4, 12, 2, 12, 0, 0, 6, 12, 5, 12, 3, 12,
         8, 12, 6, 3]
# read the teachers after their update in the same iteration
CHAOTIC = {"D_arch_A", "D_arch_B", "D_arch_diff_A", "D_arch_diff_B",
           "teacher_netD_A_arch_diff", "teacher_netD_B_arch_diff"}
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def jax_state(jeng, nets):
    """The JAX engine's step-0 state around JAX-layout nets: its own
    optimizer inits, as engines/cyclegan.py:112-140 builds them."""
    nets = jax.tree_util.tree_map(jnp.asarray, nets)
    p = {k: v["params"] for k, v in nets.items() if "params" in v}
    opts = {"g": jeng.tx_g.init({k: p[k] for k in p
                                 if k in ("g_a", "g_b", "tf_a", "tf_b")}),
            "d": jeng.tx_d.init({"d_a": p["d_a"], "d_b": p["d_b"]})}
    if jeng.cfg.online_distillation:
        opts["tg"] = jeng.tx_g.init({"g_a": p["tg_a"], "g_b": p["tg_b"]})
        opts["td"] = jeng.tx_d.init({"d_a": p["td_a"], "d_b": p["td_b"]})
    if jeng.darts:
        opts["arch"] = jeng.tx_arch.init({"d_a": nets["d_a"]["arch"],
                                          "d_b": nets["d_b"]["arch"]})
    return JaxState(step=jnp.int32(0), nets=nets, opts=opts,
                    ema={"d_a_arch": jnp.float32(0.0),
                         "d_b_arch": jnp.float32(0.0)},
                    rng=jax.random.PRNGKey(0))


def jax_steps(jeng, state, batch):
    """The JAX engine's train and arch steps, compiled once each."""
    lr = jnp.float32(LR)
    train = jax.jit(jeng._train_step).lower(state, batch, lr).compile(FAST)
    arch = None
    if jeng.darts:
        arch = jax.jit(jeng._arch_step).lower(
            state, batch, jnp.float32(0.9), jnp.float32(ARCH_LR)).compile(FAST)
    return (lambda s, b: train(s, b, lr),
            lambda s, b: arch(s, b, jnp.float32(0.9), jnp.float32(ARCH_LR)))


def trajectory(kw, n_iters, size, cfg_a=None, seed=11):
    """(initial, per-iteration JAX and port nets, loss histories) of both
    engines from the port's seeded init on the same batches."""
    jeng = JaxEngine(JaxConfig(**{**kw, "fused_resblock": "off"}),
                     cfg_AtoB=cfg_a)
    eng = CycleGANEngine(Config(**kw), cfg_AtoB=cfg_a, device="cpu")
    state = eng.init_state(seed=3)
    nets0 = to_jax_nets(state)
    jstate = jax_state(jeng, nets0)
    rng = np.random.RandomState(seed)

    def mk():
        return rng.rand(2, size, size, 3).astype(np.float32) * 2 - 1

    jtrain = jarch = None
    snaps, hist = [], []
    for _ in range(n_iters):
        A, B, Av, Bv = mk(), mk(), mk(), mk()
        jb = {"A": jnp.asarray(A), "B": jnp.asarray(B)}
        jv = {"A": jnp.asarray(Av), "B": jnp.asarray(Bv)}
        if jtrain is None:
            jtrain, jarch = jax_steps(jeng, jstate, jb)
        jstate, m = jtrain(jstate, jb)
        state, t = eng.train_step(state, {"A": _nchw(A), "B": _nchw(B)}, LR)
        if eng.darts:
            jstate, m2 = jarch(jstate, jv)
            state, t2 = eng.arch_step(state, {"A": _nchw(Av), "B": _nchw(Bv)},
                                      0.9)
            m, t = {**m, **m2}, {**t, **t2}
        hist.append(({k: float(v) for k, v in m.items()},
                     {k: float(v) for k, v in t.items()}))
        snaps.append((_np(jstate.nets), to_jax_nets(state)))
    return nets0, snaps, hist


@pytest.fixture(scope="module")
def runs():
    return trajectory(KW, N_ITERS, 32, cfg_a=CFG_A)


def feeds_instance_norm(net, path):
    """Generator conv biases other than conv_out's feed an affine-free
    InstanceNorm (so do the instance-norm teacher D's conv_1..3 biases):
    no true gradient, forward-inert."""
    if net.startswith(("g_", "tg_")):
        return path.endswith("/bias") and not path.startswith(
            "params/conv_out/")
    return net.startswith("td_") and path.endswith("/bias") \
        and path.startswith(("params/conv_1/", "params/conv_2/",
                             "params/conv_3/"))


def flips(jnets, tnets, lr=LR):
    """Per kernel leaf, the entries more than 1e-6 apart; all of them must
    be isolated opposite Adam steps, at most 2*lr apart."""
    out = {}
    for net in jnets:
        for path, a in _leaves(jnets[net]):
            if not path.endswith("kernel"):
                continue
            d = np.abs(np.asarray(a, np.float64) - tnets[net][path])
            n = int((d > 1e-6).sum())
            if n:
                out[f"{net}/{path}"] = (n, d.size, float(d.max()))
    return out


def _tnets(nets):
    return {k: dict(_leaves(v)) for k, v in nets.items()}


def test_loss_trajectory_parity(runs):
    _, _, hist = runs
    for i, (j, t) in enumerate(hist):
        assert set(j) == set(t), set(j) ^ set(t)
        for k in sorted(j):
            tol = 3e-2 if k in CHAOTIC else 1e-4 + 2e-3 * abs(j[k])
            print(f"iter {i} {k}: jax {j[k]:.6f} port {t[k]:.6f} "
                  f"delta {abs(j[k] - t[k]):.2e} tol {tol:.2e}")
        for k in j:
            tol = 3e-2 if k in CHAOTIC else 1e-4 + 2e-3 * abs(j[k])
            assert abs(j[k] - t[k]) < tol, \
                f"iter {i} loss '{k}': jax {j[k]} vs port {t[k]}"


def test_one_iteration_kernels_but_isolated_flips(runs):
    """After one iteration every kernel is within 1e-6 but for isolated
    entries at most 2*lr apart; their count is printed, and stays under
    1 in 100 of each leaf."""
    _, snaps, _ = runs
    jnets, tnets = snaps[0]
    found = flips(jnets, _tnets(tnets))
    total = sum(n for n, _, _ in found.values())
    print(f"isolated opposite Adam steps after one iteration: {total}")
    for name, (n, size, worst) in sorted(found.items()):
        print(f"  {name}: {n} of {size}, max |delta| {worst:.3e}")
        assert worst <= 2 * LR + 1e-6, name
        assert n <= max(1, size // 100), name


def test_final_param_parity(runs):
    """After 3 iterations: kernels (and the transforms) within 2*lr*N*1.25
    with a mean under lr/2; the arch alphas with a mean under 2*arch_lr;
    the masked D's BatchNorm stats within 5e-4."""
    _, snaps, _ = runs
    jnets, tnets = snaps[-1]
    assert set(jnets) == set(tnets)
    for net in jnets:
        tl = dict(_leaves(tnets[net]))
        assert set(dict(_leaves(jnets[net]))) == set(tl), net
        for path, a in _leaves(jnets[net]):
            if feeds_instance_norm(net, path) or net.startswith(("pool",
                                                                 "tpool")):
                continue
            d = np.abs(np.asarray(a, np.float64) - tl[path])
            if path.startswith("batch_stats/"):
                assert d.max() < 5e-4, f"{net}/{path}: {d.max()}"
                continue
            lr = ARCH_LR if path.startswith("arch/") else LR
            mean_tol = 2 * ARCH_LR if path.startswith("arch/") else LR / 2
            assert d.max() < 2 * lr * N_ITERS * 1.25, f"{net}/{path}"
            assert d.mean() < mean_tol, f"{net}/{path}: mean {d.mean()}"


def test_heavy_sparsity_weights_match_jax():
    """The port's per-kernel multipliers are gcc_tpu's, by JAX path (the
    trajectories above run them at lambda_weight 1e-3: 1 on up_0)."""
    net = MobileResnetGenerator(ngf=4)
    params = weight_params(net)
    zeros = [torch.zeros_like(p) for p in params]
    for p in params:
        torch.nn.init.normal_(p)
    ours = add_sign_sparsity(net, params, zeros, 1.0, 0.0,
                             weight_scale_fn=cyclegan_heavy_sparsity)
    tree = export_jax_variables(net)["params"]
    theirs = jax_sparsity(jax.tree_util.tree_map(np.zeros_like, tree), tree,
                          1.0, 0.0, weight_scale_fn=jax_heavy)
    probe = MobileResnetGenerator(ngf=4)
    load_jax_variables(probe, {"params": _np(theirs)})
    for (name, p), g in zip(
            [(n, p) for n, p in probe.named_parameters()], ours):
        np.testing.assert_array_equal(p.detach().numpy(), g.detach().numpy(), name)


def test_cpu_path_launches_no_kernel(runs):
    assert all(v == 0 for v in mobile_block.LAUNCHES.values())


@pytest.fixture(scope="module")
def normal80():
    """Two iterations of normal distillation (frozen teachers) at 80 px,
    where the blocks are 20 px a side: the port's blocks of all four
    generators run fused, through the stage kernels' plain versions
    (counted), the JAX engine's unfused. One JAX compile serves both tests
    below."""
    calls = {"fwd": 0}
    plain = mobile_block.stage_fwd_plain

    def counted(*a, **k):
        calls["fwd"] += 1
        return plain(*a, **k)

    kw = {**KW, "crop_size": 80, "online_distillation": False,
          "normal_distillation": True, "fused_resblock": "on"}
    mobile_block.stage_fwd_plain = counted
    try:
        run = trajectory(kw, 2, 80, cfg_a=CFG_A, seed=5)
    finally:
        mobile_block.stage_fwd_plain = plain
    return run, calls["fwd"]


def test_fused_blocks_at_80px_match_jax_unfused(normal80):
    """The port's fused blocks hold the JAX engine's unfused ones: every
    loss of the first iteration at the pix2pix bound, every kernel within
    1e-6 after it but isolated opposite Adam steps. The two sides' trees
    are the same; the separable convs' biases are not read on the fused
    path and keep their values there."""
    (nets0, snaps, hist), fwd = normal80
    # an iteration: the teachers' 6 target forwards (9 blocks each), the
    # students' 6 with a gradient (G_A 8 blocks, G_B 9) and the arch
    # step's one of each of the four G's; two stages a block
    per_iter = 2 * (6 * 9 + 3 * (8 + 9) + (8 + 9 + 9 + 9))
    assert fwd == 2 * per_iter
    j, t = hist[0]
    for k in j:
        tol = 3e-2 if k in CHAOTIC else 1e-4 + 2e-3 * abs(j[k])
        assert abs(j[k] - t[k]) < tol, (k, j[k], t[k])
    jnets, tnets = snaps[0]
    found = flips(jnets, _tnets(tnets))
    print(f"isolated opposite Adam steps: {found}")
    for name, (n, size, worst) in found.items():
        assert worst <= 2 * LR + 1e-6 and n <= max(1, size // 100), name
    for net in ("g_a", "g_b"):
        for path, a in _leaves(tnets[net]):
            if "_sep" in path and path.endswith("/bias"):
                np.testing.assert_array_equal(
                    a, dict(_leaves(nets0[net]))[path])


def test_normal_distillation_parity(normal80):
    """Frozen teachers: both iterations at the pix2pix bound on every loss
    (the arch keys 3e-2), and the teachers' parameters unchanged on both
    sides."""
    (nets0, snaps, hist), _ = normal80
    for i, (j, t) in enumerate(hist):
        assert set(j) == set(t)
        for k in j:
            tol = 3e-2 if k in CHAOTIC else 1e-4 + 2e-3 * abs(j[k])
            assert abs(j[k] - t[k]) < tol, (i, k, j[k], t[k])
    jnets, tnets = snaps[-1]
    for net in ("tg_a", "tg_b", "td_a", "td_b"):
        for path, a in _leaves(nets0[net]):
            np.testing.assert_array_equal(dict(_leaves(tnets[net]))[path], a)
            np.testing.assert_array_equal(dict(_leaves(jnets[net]))[path], a)


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------

def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


def flax_variables(jnet, x, net, seed):
    """The port net's JAX-layout variables, each leaf moved by a seeded
    N(0, 0.1), after checking that they have exactly the tree and shapes
    of the flax module's own init (``jax.eval_shape``: nothing computed)."""
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = export_jax_variables(init_params(
        net, torch.Generator().manual_seed(seed)))
    assert _plain(variables) == _plain(shapes)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.randn(*np.shape(a))).astype(np.float32),
        variables)


@pytest.mark.parametrize("masked", [False, True], ids=["instance", "masked"])
def test_patchgan_matches_jax(masked):
    """The unmasked instance-norm teacher D and the masked BatchNorm
    student D against flax's PatchGAN: outputs, features, and the masked
    one's running stats after a train-mode forward."""
    x = np.random.RandomState(2).rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    jnet = JaxPatchGAN(ndf=8, norm="instance", masked=masked)
    net = PatchGAN(3, 8, norm="instance", masked=masked)
    variables = flax_variables(jnet, x, net, 2)
    out, mut = jax.jit(lambda v, x: jnet.apply(
        v, x, train=True, mutable=["batch_stats", "intermediates"]))(
        variables, jnp.asarray(x))
    load_jax_variables(net, variables)
    t_out, feats = net.train()(_nchw(x))
    np.testing.assert_allclose(t_out.detach().numpy(),
                               np.transpose(np.asarray(out), (0, 3, 1, 2)),
                               atol=2e-5, rtol=1e-4)
    inter = mut["intermediates"]
    for f, key in zip(feats, sorted(inter)):
        np.testing.assert_allclose(
            f.detach().numpy(),
            np.transpose(np.asarray(inter[key][0]), (0, 3, 1, 2)),
            atol=2e-5, rtol=1e-4)
    if masked:
        exported = export_jax_variables(net)["batch_stats"]
        for path, a in _leaves(_np(mut["batch_stats"])):
            np.testing.assert_allclose(dict(_leaves(exported))[path], a,
                                       atol=1e-5)


def test_pruned_generator_matches_jax():
    x = np.random.RandomState(4).rand(1, 32, 32, 3).astype(np.float32) * 2 - 1
    jnet = JaxMobileResnet(ngf=4, cfg=CFG_A, use_fused_blocks=False)
    net = MobileResnetGenerator(ngf=4, cfg=CFG_A)
    variables = flax_variables(jnet, x, net, 1)
    out = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    load_jax_variables(net, variables)
    np.testing.assert_allclose(
        net.eval()(_nchw(x))[0].detach().numpy(),
        np.transpose(np.asarray(out), (0, 3, 1, 2)), atol=1e-5)


def test_weights_round_trip_and_strict():
    """to_jax_nets then from_jax_nets gives the same state, pools included;
    a missing or extra pool leaf is refused."""
    eng = CycleGANEngine(Config(**{**KW, "pool_size": 3}), cfg_AtoB=CFG_A,
                         device="cpu")
    state = eng.init_state(seed=1)
    state.nets["pool_b"].query(torch.randn(2, 3, 32, 32), state.rng)
    nets = to_jax_nets(state)
    assert nets["pool_b"]["count"] == 2
    assert nets["pool_b"]["buffer"].shape == (3, 32, 32, 3)
    back = to_jax_nets(from_jax_nets(eng, nets))
    for net in nets:
        for path, a in _leaves(nets[net]):
            np.testing.assert_array_equal(dict(_leaves(back[net]))[path], a)
    with pytest.raises(ValueError, match="buffer and count"):
        load_jax_variables(ReplayPool(3, (3, 32, 32)),
                           {"buffer": nets["pool_b"]["buffer"]})
    bad = {**nets, "extra": nets["d_a"]}
    with pytest.raises(ValueError, match="do not match"):
        from_jax_nets(eng, bad)


def test_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        CycleGANEngine(Config(**KW))
    assert CycleGANEngine(Config(**KW), device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# replay pool (utils/image_pool.py:23-54)
# ---------------------------------------------------------------------------

def _imgs(n, seed):
    return torch.from_numpy(np.random.RandomState(seed).rand(
        n, 3, 4, 4).astype(np.float32))


def test_pool_size_zero_passes_through():
    pool = ReplayPool(0, (3, 4, 4))
    x = _imgs(2, 0)
    assert pool.query(x, torch.Generator().manual_seed(0)) is x
    assert pool.count == 0


def test_pool_stores_while_filling():
    pool, gen = ReplayPool(3, (3, 4, 4)), torch.Generator().manual_seed(0)
    a, b = _imgs(2, 1), _imgs(1, 2)
    torch.testing.assert_close(pool.query(a, gen), a, rtol=0, atol=0)
    torch.testing.assert_close(pool.query(b, gen), b, rtol=0, atol=0)
    assert pool.count == 3
    torch.testing.assert_close(pool.buffer, torch.cat([a, b]), rtol=0,
                               atol=0)


def test_pool_full_returns_input_or_evicted():
    """Once full, each output is its input (buffer unchanged) or an evicted
    entry whose slot now holds the input; both happen over 40 queries."""
    pool, gen = ReplayPool(4, (3, 4, 4)), torch.Generator().manual_seed(3)
    pool.query(_imgs(4, 4), gen)
    kinds = set()
    for i in range(40):
        before = pool.buffer.clone()
        x = _imgs(1, 10 + i)
        out = pool.query(x, gen)
        if torch.equal(out, x):
            kinds.add("input")
            assert torch.equal(pool.buffer, before)
        else:
            kinds.add("evicted")
            slot = [k for k in range(4) if torch.equal(before[k], out[0])]
            assert len(slot) == 1
            assert torch.equal(pool.buffer[slot[0]], x[0])
            others = [k for k in range(4) if k != slot[0]]
            assert torch.equal(pool.buffer[others], before[others])
    assert kinds == {"input", "evicted"}
    assert pool.count == 4


def test_pool_seeded_generator_repeats():
    outs = []
    for _ in range(2):
        pool, gen = ReplayPool(2, (3, 4, 4)), torch.Generator().manual_seed(9)
        outs.append(torch.cat([pool.query(_imgs(3, 20 + i), gen)
                               for i in range(6)]))
        outs.append(pool.buffer.clone())
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])
