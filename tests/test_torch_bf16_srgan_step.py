"""SRGAN's cooperative iteration in bf16 (train_step + arch_step) against
gcc_tpu's, from the port's seeded init on the same batches: one step at
learning rate 0 held net by net to the ratio rule (STEP_BOUNDS), and the
iterations after it at the students' learning rate, on one compile of
gcc_tpu's steps. The nets and layers: tests/test_torch_bf16_srgan.py, whose
docstring gives the rules.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.config import Config as JaxConfig  # noqa: E402
from gcc_tpu.engines.common import GANState as JaxState  # noqa: E402
from gcc_tpu.engines.srgan import SRGANEngine as JaxEngine  # noqa: E402
from gcc_tpu.metrics.vgg import load_torch_vgg19 as jax_load_vgg  # noqa: E402
from gcc_tpu_torch.engines.common import weight_params  # noqa: E402
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    from_jax_nets, to_jax_nets,
)
from torch_bf16_common import (  # noqa: E402
    BF, FAST, arch_moments, check_ratio, jax_tree, joint_ratio, leaves, nchw,
)
from torch_limits import one_thread  # noqa: E402,F401
from torch_bf16_srgan_common import FILTERS, KW, LR, _np, setup  # noqa: E402


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
