"""The CycleGAN parity tests' configuration and JAX reference
(tests/test_torch_cyclegan.py, tests/test_torch_cyclegan_80px.py): gcc_tpu's
step-0 state around the port's initial nets, its train and arch steps
compiled once per trajectory, the trajectories of both engines from the
same weights on the same batches, and the isolated Adam flips between
them.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from gcc_tpu.config import Config as JaxConfig
from gcc_tpu.engines.common import GANState as JaxState
from gcc_tpu.engines.cyclegan import CycleGANEngine as JaxEngine
from gcc_tpu_torch.config import Config
from gcc_tpu_torch.engines.cyclegan import CycleGANEngine
from gcc_tpu_torch.utils.weights import to_jax_nets


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
