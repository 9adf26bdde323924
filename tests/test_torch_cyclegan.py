"""CycleGAN in the port against the JAX engine (gcc_tpu.engines.cyclegan).

* The online-distillation iteration (teacher G joint over both directions
  with the heavy sparsity injection, teacher D on its pools, student G with
  cycle, identity, plain-MSE distillation and L1 to the teacher, student D
  on the pooled fakes, the per-direction arch step) over 3 iterations from
  the same weights on the same numpy batches, ngf 4 / ndf 8, teacher 8/8,
  32 px, batch 2, pools at 0 (a coin flip cannot be shared across
  frameworks), unfused blocks. G_A's student is pruned, one block elided.
* normal_distillation (frozen teachers) at 80 px, fused against unfused:
  tests/test_torch_cyclegan_80px.py.
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

from gcc_tpu.engines.common import add_sign_sparsity as jax_sparsity  # noqa: E402
from gcc_tpu.engines.common import cyclegan_heavy_sparsity as jax_heavy  # noqa: E402
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
from torch_limits import one_thread  # noqa: E402,F401
from torch_cyclegan_common import (  # noqa: E402
    ARCH_LR, CFG_A, CHAOTIC, KW, LR, N_ITERS, _leaves, _nchw, _np, _tnets,
    flips, trajectory,
)


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
