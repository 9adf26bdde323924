"""SAGAN's online-distillation iteration in the port against the JAX engine
(gcc_tpu.engines.sagan) over 3 iterations from the same weights on the
same numpy batches, with gamma non-zero: the loss trajectory, the final
parameters, the spectral u/v state and BatchNorm statistics, at
tests/test_torch_sagan.py's bounds; the CPU path launches no kernel. One
JAX compile serves every test here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.config import Config as JaxConfig  # noqa: E402
from gcc_tpu.engines.sagan import SAGANEngine as JaxEngine  # noqa: E402
from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.engines.sagan import SAGANEngine, ref_dup_param  # noqa: E402
from gcc_tpu_torch.ops import flash_attention  # noqa: E402
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    from_jax_nets, to_jax_nets,
)
from torch_limits import one_thread  # noqa: E402,F401
from torch_sagan_common import _leaves, _nchw, _np, _set_gammas  # noqa: E402


N_ITERS = 3
LR = 2e-4
KW = dict(model="sagan", ngf=8, ndf=8, teacher_ngf=8, teacher_ndf=8, z_dim=8,
          crop_size=64, gan_mode="hinge", online_distillation=True,
          darts_discriminator=True, lambda_content=1.0, lambda_gram=1.0,
          lambda_L1=0.5, lr=LR, arch_lr=1e-4, lambda_weight=1e-4)


@pytest.fixture(scope="module")
def runs():
    jeng = JaxEngine(JaxConfig(**KW))
    jstate = jeng.init_state(jax.random.PRNGKey(2))
    nets0 = _np(jstate.nets)
    for net in ("g", "d", "tg", "td"):
        _set_gammas(nets0[net])
    jstate = jstate.replace(nets=jax.tree_util.tree_map(jnp.asarray, nets0))
    eng = SAGANEngine(Config(**KW), device="cpu")
    state = from_jax_nets(eng, nets0)

    rng = np.random.RandomState(7)

    def mk():
        return (rng.randn(2, 8).astype(np.float32),
                (rng.rand(2, 64, 64, 3) * 2 - 1).astype(np.float32))

    hist = []
    for _ in range(N_ITERS):
        (z, real), (zv, realv) = mk(), mk()
        jstate, m1 = jeng.train_step(
            jstate, {"z": jnp.asarray(z), "real_img": jnp.asarray(real)}, LR)
        jstate, m2 = jeng.arch_step(
            jstate, {"z": jnp.asarray(zv), "real_img": jnp.asarray(realv)},
            0.9)
        state, t1 = eng.train_step(
            state, {"z": torch.from_numpy(z), "real_img": _nchw(real)}, LR)
        state, t2 = eng.arch_step(
            state, {"z": torch.from_numpy(zv), "real_img": _nchw(realv)}, 0.9)
        hist.append(({k: float(v) for k, v in {**m1, **m2}.items()},
                     {k: float(v) for k, v in {**t1, **t2}.items()}))
    return nets0, _np(jstate.nets), to_jax_nets(state), hist


# tolerance classes of tests/test_cooperative_parity_sagan.py:109-132
CHAOTIC = {"D_arch", "D_arch_diff", "teacher_D_arch_diff"}
AMPLIFIED = {"G_GAN"}


def test_loss_trajectory_parity(runs):
    *_, hist = runs
    for i, (j, t) in enumerate(hist):
        assert set(j) == set(t)
        for k in sorted(j):
            print(f"iter {i} {k}: jax={j[k]:.6f} port={t[k]:.6f} "
                  f"delta={abs(j[k] - t[k]):.2e}")
    for i, (j, t) in enumerate(hist):
        for k in j:
            if k in CHAOTIC:
                tol = 5e-3 if i == 0 else 2e-1
            elif k in AMPLIFIED:
                tol = 2e-3 if i == 0 else 3e-2
            elif i == 0:
                tol = 2e-5 + 2e-4 * abs(j[k])
            else:
                tol = 2e-3 + 2e-2 * abs(j[k])
            assert abs(j[k] - t[k]) < tol, \
                f"iter {i} loss '{k}': jax {j[k]} vs port {t[k]}"


def _zero_grad_bias(net, path):
    """Biases with no true gradient, which random-walk on reduction noise
    under Adam on each side (the benign class of the repository's
    composed-parity notes): the generators' l1-l4 biases feed train-mode BatchNorm, and a
    discriminator's attn2 value bias shifts every prediction alike, which
    the real and fake hinge terms cancel."""
    if net in ("g", "tg"):
        return path in {f"params/l{i}/bias" for i in range(1, 5)}
    return path == "params/attn2/value_conv/bias"


def test_final_param_parity(runs):
    """Every parameter and mask alpha after 3 iterations: max within the
    opposite-Adam-step ceiling 2 * eff_lr * N_ITERS * 1.25 and, but for the
    zero-gradient biases, mean within eff_lr / 2
    (tests/test_cooperative_parity_sagan.py:142-152). eff_lr = lr, times 4
    for the discriminators (TTUR), times 2 for the student's duplicated
    spectral and q/k/v convs; arch_lr for the alphas, whose mean bound is
    2 * arch_lr there."""
    _, jnets, tnets, _ = runs
    assert set(jnets) == set(tnets) == {"g", "d", "tg", "td", "tf"}
    for net in jnets:
        jl, tl = dict(_leaves(jnets[net])), dict(_leaves(tnets[net]))
        assert set(jl) == set(tl), net
        for path in jl:
            coll, name = path.split("/", 1)
            if coll == "arch":
                eff, mean_tol = 1e-4, 2e-4
            elif coll == "params":
                eff = LR * (4 if net in ("d", "td") else 1)
                if net in ("g", "d") and ref_dup_param(name.replace("/", ".")):
                    eff *= 2
                mean_tol = eff / 2
            else:  # batch_stats, spectral: below
                continue
            d = np.abs(jl[path] - tl[path])
            assert d.max() < 2 * eff * N_ITERS * 1.25, \
                f"{net}/{path} diverged: {d.max()}"
            if not _zero_grad_bias(net, path):
                assert d.mean() < mean_tol, f"{net}/{path} drift: {d.mean()}"


def test_spectral_state_parity(runs):
    """u vectors of every spectral layer after 3 iterations x 5 D forwards,
    within that test's chaos bounds (:190-208): 0.3 for the student D, 0.1
    elsewhere. A wrong matricization or a stale u blows past them."""
    nets0, jnets, tnets, _ = runs
    for net in ("g", "d", "tg", "td"):
        for i in range(1, 5):
            a = jnets[net]["spectral"][f"l{i}"]["u"]
            b = tnets[net]["spectral"][f"l{i}"]["u"]
            moved = np.abs(a - nets0[net]["spectral"][f"l{i}"]["u"]).max()
            assert np.abs(a - b).max() < (0.3 if net == "d" else 0.1)
            assert moved > 1e-2, f"{net}/l{i}/u did not move"


def test_final_bn_stats_parity(runs):
    """Generator running stats (one update per train step and one per arch
    step), within that test's 5e-3 (:242-254)."""
    _, jnets, tnets, _ = runs
    for net in ("g", "tg"):
        for path, a in _leaves(jnets[net]["batch_stats"]):
            b = dict(_leaves(tnets[net]["batch_stats"]))[path]
            assert np.abs(a - b).max() < 5e-3, f"{net}/{path}"


def test_cpu_path_launches_no_kernel(runs):
    """On CPU tensors the B1 wrappers take their plain versions: the launch
    counters of the CUDA kernels stay at zero."""
    assert all(v == 0 for v in flash_attention.LAUNCHES.values())
