"""SAGAN's cooperative iteration in bf16 (train_step + arch_step) against
gcc_tpu's, from the port's seeded init on the same batches, gcc_tpu's
SelfAttention on its Pallas kernels in interpret mode: one step at learning
rate 0 held net by net to the ratio rule (STEP_BOUNDS), and three
iterations at lr 2e-4 (gcc_tpu's steps compiled once per learning rate).
The nets and layers: tests/test_torch_bf16_sagan.py, whose docstring gives
the rules.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.config import Config as JaxConfig  # noqa: E402
from gcc_tpu.engines.common import GANState as JaxState  # noqa: E402
from gcc_tpu.engines.sagan import SAGANEngine as JaxEngine  # noqa: E402
from gcc_tpu_torch.engines.common import weight_params  # noqa: E402
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    from_jax_nets, to_jax_nets,
)
from torch_bf16_common import (  # noqa: E402
    BF, FAST, arch_moments, check_ratio, jax_tree, joint_ratio, leaves, nchw,
    pallas_route,
)
from torch_limits import one_thread  # noqa: E402,F401
from torch_bf16_sagan_common import G_CFG, KW, LR, _np, setup  # noqa: E402


def jax_state(jeng, nets):
    """gcc_tpu's step-0 SAGAN state around JAX-layout nets, its own
    optimizer inits (engines/sagan.py:99-134)."""
    nets = jax.tree_util.tree_map(jnp.asarray, nets)
    p = {k: v["params"] for k, v in nets.items()}
    bundle = {"g": p["g"], "tf": p["tf"]}
    opts = {"g": (jeng.tx_g.init(bundle), jeng.tx_g_dup.init(bundle)),
            "d": (jeng.tx_d.init(p["d"]), jeng.tx_d_dup.init(p["d"])),
            "td": jeng.tx_d.init(p["td"]),
            "tg": jeng.tx_g.init({"g": p["tg"]}),
            "arch": jeng.tx_arch.init(nets["d"]["arch"])}
    return JaxState(step=jnp.int32(0), nets=nets, opts=opts,
                    ema={"d_arch": jnp.float32(0.0)},
                    rng=jax.random.PRNGKey(0))


def jax_mu(opts):
    """gcc_tpu's first moments by optimizer (the single chain of a
    duplicate pair: betas (0, 0.9) make it the gradient itself)."""
    def mu(o):
        return (o[0] if isinstance(o, tuple) and not hasattr(o, "mu")
                else o).mu
    return {k: jax.tree_util.tree_map(np.asarray, mu(o))
            for k, o in opts.items()}


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


def _jax_steps(lr, jst, jb, jv):
    """gcc_tpu's train and arch steps at configuration learning rate lr,
    compiled once per lr under pallas_route."""
    if lr not in _COMPILED:
        jeng = JaxEngine(JaxConfig(**dict(KW, lr=lr, arch_lr=lr / 2)),
                         filter_cfgs=G_CFG)
        lr_, beta, alr = (jnp.float32(a) for a in (lr, 0.9, lr / 2))
        with pallas_route():
            train = jax.jit(jeng._train_step).lower(jst, jb, lr_).compile(
                FAST)
            arch = jax.jit(jeng._arch_step).lower(jst, jv, beta, alr).compile(
                FAST)
        _COMPILED[lr] = (jeng, train, arch, (lr_, beta, alr))
    return _COMPILED[lr]


def trajectory(n_iters, lr):
    """gcc_tpu's bf16 iterations and the port's bf16 and fp32 ones from the
    port's seeded init on the same batches. Per iteration: the loss dict,
    nets and first moments (gcc_tpu's layout) as {"jax", BF, fp32}."""
    eng, nets0, batches = setup(lr)
    states = {dt: from_jax_nets(eng, nets0) for dt in (BF, torch.float32)}
    jst, out = None, []
    for _ in range(n_iters):
        (z, real), (zv, realv) = batches()
        jb = {"z": jnp.asarray(z).astype(jnp.bfloat16),
              "real_img": jnp.asarray(real).astype(jnp.bfloat16)}
        jv = {"z": jnp.asarray(zv).astype(jnp.bfloat16),
              "real_img": jnp.asarray(realv).astype(jnp.bfloat16)}
        if jst is None:
            jst = jax_state(JaxEngine(JaxConfig(**KW), filter_cfgs=G_CFG),
                            nets0)
        _, train, arch, (lr_, beta, alr) = _jax_steps(lr, jst, jb, jv)
        jst, m1 = train(jst, jb, lr_)
        jst, m2 = arch(jst, jv, beta, alr)
        rec = {"jax": ({k: float(v) for k, v in {**m1, **m2}.items()},
                       _np(jst.nets), jax_mu(jst.opts))}
        for dt, st in states.items():
            tb = {"z": torch.from_numpy(z).to(dt), "real_img": nchw(real).to(dt)}
            tv = {"z": torch.from_numpy(zv).to(dt),
                  "real_img": nchw(realv).to(dt)}
            st, m = eng.train_arch_step(st, tb, tv, lr, 0.9, lr / 2)
            rec[dt] = ({k: float(v) for k, v in m.items()}, to_jax_nets(st),
                       port_mu(st))
        out.append(rec)
    return out


@pytest.fixture(scope="module")
def step():
    """One train_step + arch_step at learning rate 0: every loss, gradient
    and state update is computed at the initial weights."""
    return trajectory(1, 0.0)[0]


# Each net's results held to the ratio rule on their own, at 1/4 unless
# named here with the measured ratio and its cause; None: finite only.
STEP_BOUNDS = {
    # the teacher G's update reads the cotangent that the teacher D's bf16
    # backward hands the fake, in which the two frameworks' fp32 convolution
    # sums round to different bf16 neighbours; the teacher G's own backward
    # from one cotangent is at 0.16 (test_generator_backward_bf16)
    ("sagan", "grad", "tg"): 0.45,  # measured 0.37
}
LOSS_GROUPS = {"D": ("D_fake", "D_real"),
               "G": ("G_GAN", "content", "gram", "L1"),
               "arch": ("D_arch", "D_arch_diff", "teacher_D_arch_diff")}


def test_step_losses_bf16(step):
    """Each update's losses together at ratio <= 1/4 unless STEP_BOUNDS
    names them. Measured: D 0 (bit for bit), G 0.09, arch 0.14."""
    j, b, f = step["jax"][0], step[BF][0], step[torch.float32][0]
    assert set(j) == set(b) == set(f) == {k for g in LOSS_GROUPS.values()
                                          for k in g}
    for group, keys in LOSS_GROUPS.items():
        check_ratio(STEP_BOUNDS, "sagan", "loss", group,
                    joint_ratio(b, j, f, keys))


def test_step_gradients_bf16(step):
    """Each optimizer's gradients (its first moments after one step), fp32
    and finite, at ratio <= 1/4 unless STEP_BOUNDS names them. Measured:
    d 0.06, g (with tf) 0.14, td 0.20, tg 0.37.

    The mask alphas (arch, measured 0.38) are held to fp32 instead, as in
    tests/test_torch_bf16.py: gcc_tpu's alpha gradient is a reduction of
    B*H*W bf16 products that XLA on the CPU sums one after the other in
    bf16, the port's an fp32 sum rounded once, so the port's is the nearer
    to the fp32 gradient (measured: nearer for each of the four masks)."""
    jmu, bmu, fmu = step["jax"][2], step[BF][2], step[torch.float32][2]
    assert set(jmu) == set(bmu) == {"g", "d", "tg", "td", "arch"}
    for opt in jmu:
        jl, bl, fl = (dict(leaves(t[opt])) for t in (jmu, bmu, fmu))
        assert set(jl) == set(bl) == set(fl), opt
        assert all(v.dtype == np.float32 and np.isfinite(v).all()
                   for v in bl.values())
        if opt == "arch":
            for k in jl:
                assert np.abs(bl[k] - fl[k]).max() < np.abs(
                    jl[k] - fl[k]).max(), k
            continue
        check_ratio(STEP_BOUNDS, "sagan", "grad", opt,
                    joint_ratio(bl, jl, fl, sorted(jl)))


def test_step_state_bf16(step):
    """The state the iteration's forwards wrote. The generators' BatchNorm
    running statistics (fp32) at ratio <= 1/4 unless STEP_BOUNDS names
    them; measured g 0.002, tg 0.04. Every net's spectral vectors come from
    the fp32 power iteration on the fp32 weights, whatever the activations'
    dtype: the port's bf16 run writes its fp32 run's bits, within 1e-6 of
    gcc_tpu's."""
    nets = [n for n, t in step["jax"][1].items() if "batch_stats" in t]
    assert sorted(nets) == ["g", "tg"]
    for net in nets:
        jl, bl, fl = (dict(leaves(step[k][1][net]["batch_stats"]))
                      for k in ("jax", BF, torch.float32))
        assert set(jl) == set(bl) == set(fl), net
        check_ratio(STEP_BOUNDS, "sagan", "stats", net,
                    joint_ratio(bl, jl, fl, sorted(jl)))
    for net in ("g", "d", "tg", "td"):
        jl, bl, fl = (dict(leaves(step[k][1][net]["spectral"]))
                      for k in ("jax", BF, torch.float32))
        assert set(jl) == set(bl) == set(fl), net
        for k in jl:
            np.testing.assert_array_equal(bl[k], fl[k])
            np.testing.assert_allclose(bl[k], jl[k], atol=1e-6)


def test_loss_trajectory_bf16():
    """Three iterations at lr 2e-4: iteration 0 is the step above; after it,
    each loss within the tolerance classes that tests/test_torch_sagan.py
    holds the fp32 port to gcc_tpu's fp32 run with (Adam betas (0, 0.9)
    make the first step sign(g), so rounding noise in a near-zero gradient
    flips a whole step, and the spectral power iteration amplifies it): the
    arch losses within 2e-1, G_GAN within 3e-2, the rest within
    2e-3 + 2e-2 |t|; and over iterations 1 and 2 the port's bf16 losses at
    most half as far from gcc_tpu's bf16 ones as the port's fp32 losses are
    (rms over all losses). Measured: at most 0.033 (D_arch, iteration 2),
    and 0.31 of the fp32 run's distance."""
    num = den = 0.0
    for i, rec in enumerate(trajectory(3, LR)[1:], start=1):
        j, b, f = rec["jax"][0], rec[BF][0], rec[torch.float32][0]
        for k in j:
            tol = 2e-1 if k in LOSS_GROUPS["arch"] else \
                3e-2 if k == "G_GAN" else 2e-3 + 2e-2 * abs(j[k])
            assert abs(b[k] - j[k]) <= tol, \
                f"iteration {i} {k}: jax {j[k]} port {b[k]}"
            num += (b[k] - j[k]) ** 2
            den += (f[k] - j[k]) ** 2
    assert num <= 0.25 * den
