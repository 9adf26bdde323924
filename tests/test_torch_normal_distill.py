"""normal_distillation (a frozen teacher) in the port against the JAX
engines: pix2pix with the U-Net and the MobileResnet backbone, and SAGAN.

Each run carries one JAX engine's initial weights into the port and takes
two iterations (train step, arch step) on the same numpy batches. Under
normal distillation the teacher G gives its targets from an eval-mode
forward that updates nothing, the teacher D likewise, and neither has an
optimizer: across each train step the teacher G's parameters and running
statistics and the teacher D's parameters stay bit-identical, on both
sides. (The teacher D's running statistics and spectral vectors do move,
on both sides: the student's G update runs it in train mode for the
student's distillation features, engines/pix2pix.py:262-265. The arch
step runs both teachers in train mode.)

Bounds: pix2pix as tests/test_torch_pix2pix.py (losses within
1e-4 + 2e-3*|t|; parameters, alphas and running stats within 5e-5, but
the MobileResnet's conv biases that feed an affine-free InstanceNorm);
SAGAN the tolerance classes of tests/test_torch_sagan.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.config import Config as JaxConfig  # noqa: E402
from gcc_tpu.engines.pix2pix import Pix2PixEngine as JaxPix2Pix  # noqa: E402
from gcc_tpu.engines.sagan import SAGANEngine as JaxSAGAN  # noqa: E402
from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine  # noqa: E402
from gcc_tpu_torch.engines.sagan import SAGANEngine  # noqa: E402
from gcc_tpu_torch.utils.weights import from_jax_nets, to_jax_nets  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401

N_ITERS = 2
PIX2PIX = dict(model="pix2pix", ngf=4, ndf=8, teacher_ngf=8, teacher_ndf=8,
               crop_size=32, num_downs=5, no_dropout=True, gan_mode="hinge",
               normal_distillation=True, darts_discriminator=True,
               lambda_L1=100.0, lambda_content=50.0, lambda_gram=1e4,
               arch_lr=1e-4, lr=2e-4)
RESNET_CFG = [3, 6, 12, 5, 12, 7, 12, 4, 12, 2, 12, 0, 0, 6, 12, 5, 12,
              3, 12, 8, 12, 6, 3]
CASES = {
    "unet": (JaxPix2Pix, Pix2PixEngine, {**PIX2PIX, "backbone": "unet"},
             [3, 6, 12, 20, 24, 20, 12, 6, 5]),
    "resnet": (JaxPix2Pix, Pix2PixEngine,
               {**PIX2PIX, "backbone": "resnet", "fused_resblock": "off"},
               RESNET_CFG),
    "sagan": (JaxSAGAN, SAGANEngine,
              dict(model="sagan", ngf=8, ndf=8, teacher_ngf=8, teacher_ndf=8,
                   z_dim=8, crop_size=64, gan_mode="hinge",
                   normal_distillation=True, darts_discriminator=True,
                   lambda_content=1.0, lambda_gram=1.0, lambda_L1=0.5,
                   lr=2e-4, arch_lr=1e-4), None),
}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _frozen_part(nets):
    """What a train step must leave as it was: the teacher G whole, the
    teacher D's parameters."""
    return {**{f"tg/{p}": a for p, a in _leaves(nets["tg"])},
            **{f"td/{p}": a for p, a in _leaves(nets["td"]["params"])}}


def _batches(case, rng):
    if case == "sagan":
        z = rng.randn(2, 8).astype(np.float32)
        real = (rng.rand(2, 64, 64, 3) * 2 - 1).astype(np.float32)
        return ({"z": jnp.asarray(z), "real_img": jnp.asarray(real)},
                {"z": torch.from_numpy(z), "real_img": _nchw(real)})
    a, b = (rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
            for _ in range(2))
    return ({"A": jnp.asarray(a), "B": jnp.asarray(b)},
            {"A": _nchw(a), "B": _nchw(b)})


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    case = request.param
    JaxEngine, Engine, kw, cfgs = CASES[case]
    jeng = JaxEngine(JaxConfig(**kw), filter_cfgs=cfgs)
    jstate = jeng.init_state(jax.random.PRNGKey(0))
    nets0 = _np(jstate.nets)
    if case == "sagan":  # gamma non-zero, as tests/test_torch_sagan.py
        for net in ("g", "d", "tg", "td"):
            nets0[net]["params"]["attn1"]["gamma"] = np.float32(0.5)
            nets0[net]["params"]["attn2"]["gamma"] = np.float32(-0.3)
        jstate = jstate.replace(
            nets=jax.tree_util.tree_map(jnp.asarray, nets0))
    eng = Engine(Config(**kw), filter_cfgs=cfgs, device="cpu")
    state = from_jax_nets(eng, nets0)
    rng = np.random.RandomState(11)
    hist, frozen = [], []
    for _ in range(N_ITERS):
        (jb, tb), (jv, tv) = _batches(case, rng), _batches(case, rng)
        before = (_frozen_part(_np(jstate.nets)),
                  _frozen_part(to_jax_nets(state)))
        jstate, m1 = jeng.train_step(jstate, jb, 2e-4)
        state, t1 = eng.train_step(state, tb, 2e-4)
        frozen.append((before, (_frozen_part(_np(jstate.nets)),
                                _frozen_part(to_jax_nets(state)))))
        jstate, m2 = jeng.arch_step(jstate, jv, 0.9)
        state, t2 = eng.arch_step(state, tv, 0.9)
        hist.append(({k: float(v) for k, v in {**m1, **m2}.items()},
                     {k: float(v) for k, v in {**t1, **t2}.items()}))
    return case, state, _np(jstate.nets), to_jax_nets(state), hist, frozen


def test_teacher_frozen_in_train_step(runs):
    case, state, _, _, _, frozen = runs
    assert "tg" not in state.opts and "td" not in state.opts
    for (j0, t0), (j1, t1) in frozen:
        for before, after in ((j0, j1), (t0, t1)):
            assert set(before) == set(after)
            for path in before:
                np.testing.assert_array_equal(after[path], before[path],
                                              err_msg=f"{case} {path}")


# SAGAN's tolerance classes (tests/test_torch_sagan.py)
CHAOTIC = {"D_arch", "D_arch_diff", "teacher_D_arch_diff"}
AMPLIFIED = {"G_GAN"}


def test_loss_trajectory_parity(runs):
    case, _, _, _, hist, _ = runs
    for i, (j, t) in enumerate(hist):
        assert set(j) == set(t)
        assert "content" in t and "gram" in t
        for k in j:
            if case != "sagan":
                tol = 1e-4 + 2e-3 * abs(j[k])
            elif k in CHAOTIC:
                tol = 5e-3 if i == 0 else 2e-1
            elif k in AMPLIFIED:
                tol = 2e-3 if i == 0 else 3e-2
            else:
                tol = 2e-5 + 2e-4 * abs(j[k]) if i == 0 \
                    else 2e-3 + 2e-2 * abs(j[k])
            assert abs(j[k] - t[k]) < tol, \
                f"{case} iter {i} loss '{k}': jax {j[k]} vs port {t[k]}"


def test_final_param_parity(runs):
    """The frozen teacher G's parameters are equal on both sides. pix2pix:
    every other parameter, alpha and running stat within 5e-5 (the
    MobileResnet's InstanceNorm-fed generator biases random-walk on
    reduction noise, CLAUDE.md, and are left out). SAGAN's chaotic regime
    is held by its loss classes above; of its teacher G's state, which
    only the arch steps move, the running stats within 5e-3 and the
    spectral vectors within 0.1 (tests/test_torch_sagan.py)."""
    case, _, jnets, tnets, _, _ = runs
    assert set(jnets) == set(tnets)
    nets = ("tg",) if case == "sagan" else tuple(jnets)
    for net in nets:
        jl, tl = dict(_leaves(jnets[net])), dict(_leaves(tnets[net]))
        assert set(jl) == set(tl), net
        for path in jl:
            if case == "resnet" and net in ("g", "tg") \
                    and path.endswith("/bias") \
                    and not path.startswith("params/conv_out/"):
                continue
            if net == "tg" and path.startswith("params/"):
                np.testing.assert_array_equal(tl[path], jl[path])
                continue
            tol = 5e-5 if case != "sagan" else \
                5e-3 if path.startswith("batch_stats/") else 0.1
            d = np.max(np.abs(jl[path] - tl[path]))
            assert d < tol, f"{case} {net}/{path} diverged: {d}"
