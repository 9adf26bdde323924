"""The PyTorch port's cooperative iteration against the JAX engine.

Three full GCC iterations (teacher D/G updates, student D/G with content
and gram distillation, DARTS arch step with the teacher-discrepancy EMA) run
in gcc_tpu's Pix2PixEngine and in gcc_tpu_torch's, resnet backbone with the
fused residual blocks on both sides (Pallas in interpret mode on the JAX
side, the stage kernels' plain versions on the port's CPU path), from
identical weights (carried by gcc_tpu_torch.utils.weights) on identical
numpy batches. Batches are made NHWC for JAX and transposed to NCHW for the
port at the boundary.

Bounds are those of tests/test_cooperative_parity.py: losses within
1e-4 + 2e-3*|t| (fp32 reduction order differs between XLA and PyTorch), and
final parameters, mask alphas and BatchNorm running stats within 5e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.config import Config as JaxConfig  # noqa: E402
from gcc_tpu.engines.pix2pix import Pix2PixEngine as JaxEngine  # noqa: E402
from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine  # noqa: E402
from gcc_tpu_torch.ops import mobile_block  # noqa: E402
from gcc_tpu_torch.utils.weights import from_jax_nets, to_jax_nets  # noqa: E402

# pruned student [c7, d1, d2, (l1, l2) x 9, u1, u2]; block 4 is elided (l1 = 0)
STUDENT_CFG = [3, 6, 12, 5, 12, 7, 12, 4, 12, 2, 12, 0, 0, 6, 12, 5, 12,
               3, 12, 8, 12, 6, 3]
N_ITERS = 3
KW = dict(model="pix2pix", backbone="resnet", fused_resblock="on", ngf=4,
          ndf=8, teacher_ngf=8, teacher_ndf=8, crop_size=32,
          gan_mode="hinge", online_distillation=True,
          darts_discriminator=True, lambda_L1=100.0, lambda_content=50.0,
          lambda_gram=1e4, arch_lr=1e-4, lr=2e-4)


def _np_tree(t):
    return jax.tree_util.tree_map(lambda x: np.array(x), t)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def runs():
    jeng = JaxEngine(JaxConfig(**KW), filter_cfgs=STUDENT_CFG)
    jstate = jeng.init_state(jax.random.PRNGKey(0), image_size=32)
    nets0 = _np_tree(jstate.nets)
    eng = Pix2PixEngine(Config(**KW), filter_cfgs=STUDENT_CFG, device="cpu")
    state = from_jax_nets(eng, nets0)

    rng = np.random.RandomState(42)

    def mk():
        return rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1

    hist = []
    for _ in range(N_ITERS):
        A, B, Av, Bv = mk(), mk(), mk(), mk()
        jstate, m1 = jeng.train_step(
            jstate, {"A": jnp.asarray(A), "B": jnp.asarray(B)}, 2e-4)
        jstate, m2 = jeng.arch_step(
            jstate, {"A": jnp.asarray(Av), "B": jnp.asarray(Bv)}, 0.9)
        state, t1 = eng.train_step(state, {"A": _nchw(A), "B": _nchw(B)},
                                   2e-4)
        state, t2 = eng.arch_step(state, {"A": _nchw(Av), "B": _nchw(Bv)},
                                  0.9)
        hist.append(({k: float(v) for k, v in {**m1, **m2}.items()},
                     {k: float(v) for k, v in {**t1, **t2}.items()}))
    return nets0, _np_tree(jstate.nets), to_jax_nets(state), hist


def _feeds_instance_norm(net, path):
    """Generator conv biases other than conv_out's feed an affine-free
    InstanceNorm: they have no true gradient, so each side's bias random-walks
    on reduction noise under Adam (the benign class in CLAUDE.md's
    composed-algorithm parity notes). Not compared."""
    return net in ("g", "tg") and path.endswith("/bias") \
        and not path.startswith("params/conv_out/")


def test_loss_trajectory_parity(runs):
    *_, hist = runs
    for i, (j, t) in enumerate(hist):
        assert set(j) == set(t)
        for k in j:
            tol = 1e-4 + 2e-3 * abs(j[k])
            assert abs(j[k] - t[k]) < tol, \
                f"iter {i} loss '{k}': jax {j[k]} vs port {t[k]}"


def test_final_param_parity(runs):
    """Every parameter, mask alpha and running stat after 3 iterations."""
    _, jnets, tnets, _ = runs
    assert set(jnets) == set(tnets) == {"g", "d", "tg", "td", "tf"}
    for net in jnets:
        jl, tl = dict(_leaves(jnets[net])), dict(_leaves(tnets[net]))
        assert set(jl) == set(tl), net
        for path in jl:
            if _feeds_instance_norm(net, path):
                continue
            d = np.max(np.abs(jl[path] - tl[path]))
            assert d < 5e-5, f"{net}/{path} diverged: {d}"


def test_alphas_and_bn_stats_moved(runs):
    """The compared alphas and running stats did move over the run, so the
    parity above pins the arch step and the per-forward stat updates."""
    nets0, jnets, _, _ = runs
    for net, coll in (("d", "arch"), ("d", "batch_stats"),
                      ("td", "batch_stats")):
        moved = max(np.max(np.abs(a - dict(_leaves(nets0[net][coll]))[p]))
                    for p, a in _leaves(jnets[net][coll]))
        assert moved > 1e-4, f"{net}/{coll} did not move"


def test_sep_biases_unchanged(runs):
    """The fused stages neither read the separable convs' biases nor give
    them gradient: both sides leave them exactly at their initial values."""
    nets0, jnets, tnets, _ = runs
    for net in ("g", "tg"):
        for path, a0 in _leaves(nets0[net]):
            if "_sep" in path and path.endswith("/bias"):
                np.testing.assert_array_equal(dict(_leaves(jnets[net]))[path], a0)
                np.testing.assert_array_equal(dict(_leaves(tnets[net]))[path], a0)


def test_cpu_path_launches_no_kernel(runs):
    """On CPU tensors the stage wrappers take their plain versions: the
    launch counters of the CUDA kernels stay at zero."""
    assert all(v == 0 for v in mobile_block.LAUNCHES.values())
