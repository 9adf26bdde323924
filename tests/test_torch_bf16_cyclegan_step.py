"""CycleGAN's cooperative iteration in bf16 (train_step + arch_step) against
gcc_tpu's, from the port's seeded init on the same batches: one step at
learning rate 0 held net by net to the ratio rule (STEP_BOUNDS), and three
iterations at the students' learning rate. One JAX compile (train and arch
steps, FAST options) serves every test here. The nets and layers:
tests/test_torch_bf16_cyclegan.py, whose docstring gives the rules.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.config import Config as JaxConfig  # noqa: E402
from gcc_tpu.engines.common import GANState as JaxState  # noqa: E402
from gcc_tpu.engines.cyclegan import CycleGANEngine as JaxEngine  # noqa: E402
from gcc_tpu_torch.engines.common import weight_params  # noqa: E402
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    from_jax_nets, to_jax_nets,
)
from torch_bf16_common import (  # noqa: E402
    BF, FAST, check_ratio, jax_tree, joint_ratio, leaves, nchw,
)
from torch_limits import one_thread  # noqa: E402,F401
from torch_bf16_cyclegan_common import CFG_A, KW, LR, _np, setup  # noqa: E402


def jax_state(jeng, nets):
    """gcc_tpu's step-0 CycleGAN state around JAX-layout nets, its own
    optimizer inits (engines/cyclegan.py:112-140)."""
    nets = jax.tree_util.tree_map(jnp.asarray, nets)
    p = {k: v["params"] for k, v in nets.items() if "params" in v}
    opts = {"g": jeng.tx_g.init({k: p[k] for k in
                                 ("g_a", "g_b", "tf_a", "tf_b")}),
            "d": jeng.tx_d.init({"d_a": p["d_a"], "d_b": p["d_b"]}),
            "tg": jeng.tx_g.init({"g_a": p["tg_a"], "g_b": p["tg_b"]}),
            "td": jeng.tx_d.init({"d_a": p["td_a"], "d_b": p["td_b"]}),
            "arch": jeng.tx_arch.init({"d_a": nets["d_a"]["arch"],
                                       "d_b": nets["d_b"]["arch"]})}
    return JaxState(step=jnp.int32(0), nets=nets, opts=opts,
                    ema={"d_a_arch": jnp.float32(0.0),
                         "d_b_arch": jnp.float32(0.0)},
                    rng=jax.random.PRNGKey(0))


def port_mu(state):
    """The port's first moments in gcc_tpu's opts layout."""
    nets, opts = state.nets, state.opts

    def split(values, kinds, coll=None):
        out, i = {}, 0
        for kind in kinds:
            net = nets[kind]
            n = len(weight_params(net)) if coll is None else \
                len([p for n_, p in net.named_parameters()
                     if n_.endswith("alpha")])
            out[kind] = jax_tree(net, values[i:i + n]) if coll is None else \
                _arch_tree(net, values[i:i + n])
            i += n
        return out

    def renamed(tree, names):
        return {new: tree[old] for old, new in names}

    g = split(opts["g"].mu, ("g_a", "g_b", "tf_a", "tf_b"))
    return {"g": g,
            "d": split(opts["d"].mu, ("d_a", "d_b")),
            "tg": renamed(split(opts["tg"].mu, ("tg_a", "tg_b")),
                          (("tg_a", "g_a"), ("tg_b", "g_b"))),
            "td": renamed(split(opts["td"].mu, ("td_a", "td_b")),
                          (("td_a", "d_a"), ("td_b", "d_b"))),
            "arch": split(opts["arch"].mu, ("d_a", "d_b"), "arch")}


def _arch_tree(net, values):
    from gcc_tpu_torch.engines.common import arch_params
    return jax_tree(net, values, arch_params, "arch")


_COMPILED = {}


def _jax_steps(lr, jst, jb):
    """gcc_tpu's train and arch steps at configuration learning rate lr,
    compiled once per lr."""
    if lr not in _COMPILED:
        jeng = JaxEngine(JaxConfig(**dict(KW, lr=lr, arch_lr=lr / 2)),
                         cfg_AtoB=CFG_A)
        lr_, beta, alr = (jnp.float32(a) for a in (lr, 0.9, lr / 2))
        train = jax.jit(jeng._train_step).lower(jst, jb, lr_).compile(FAST)
        arch = jax.jit(jeng._arch_step).lower(jst, jb, beta, alr).compile(
            FAST)
        _COMPILED[lr] = (train, arch, (lr_, beta, alr))
    return _COMPILED[lr]


def trajectory(n_iters, lr):
    """gcc_tpu's bf16 iterations and the port's bf16 and fp32 ones from the
    port's seeded init on the same batches, the configuration's learning
    rate (the teachers') 0, the students' lr: per iteration the loss dict,
    nets and first moments as {"jax", BF, fp32}."""
    eng, nets0, batches = setup(0.0)
    states = {dt: from_jax_nets(eng, nets0) for dt in (BF, torch.float32)}
    jst = jax_state(JaxEngine(JaxConfig(**KW), cfg_AtoB=CFG_A), nets0)
    out = []
    for _ in range(n_iters):
        A, B, Av, Bv = batches()
        jb = {"A": jnp.asarray(A).astype(jnp.bfloat16),
              "B": jnp.asarray(B).astype(jnp.bfloat16)}
        jv = {"A": jnp.asarray(Av).astype(jnp.bfloat16),
              "B": jnp.asarray(Bv).astype(jnp.bfloat16)}
        train, arch, (lr_, beta, alr) = _jax_steps(0.0, jst, jb)
        lr_, alr = jnp.float32(lr), jnp.float32(lr / 2)
        jst, m1 = train(jst, jb, lr_)
        jst, m2 = arch(jst, jv, beta, alr)
        rec = {"jax": ({k: float(v) for k, v in {**m1, **m2}.items()},
                       _np(jst.nets),
                       {k: _np(o.mu) for k, o in jst.opts.items()})}
        for dt, st in states.items():
            tb = {"A": nchw(A).to(dt), "B": nchw(B).to(dt)}
            tv = {"A": nchw(Av).to(dt), "B": nchw(Bv).to(dt)}
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
# Both teachers' forwards on the step's train batch first leave gcc_tpu's
# at conv_in (test_teacher_first_difference_bf16), and nine instance-normed
# blocks spread it to the size of bf16's own rounding (test_forward_bf16's
# teacher: 0.69 at the output). Every update reads a teacher forward: the
# distillation targets, the L1 to the teacher fakes, the teacher D on the
# teacher fakes, the arch step's teacher discrepancy.
STEP_BOUNDS = {
    ("cyclegan", "grad", "d"): 0.45,  # measured 0.32
    ("cyclegan", "grad", "g"): 0.45,  # measured 0.34
    # measured 0.54; on gcc_tpu's own teacher fakes 0.022
    # (test_teacher_d_update_on_jax_fakes_bf16)
    ("cyclegan", "grad", "td"): None,
    # measured 0.58, all of it the teacher forward's: the teacher's backward
    # alone, on an input at which both forwards agree bit for bit, 0.058
    # (test_teacher_g_backward_bf16)
    ("cyclegan", "grad", "tg"): None,
    # the alphas also sum B*H*W bf16 products, which XLA on the CPU does
    # one after the other in bf16 (tests/test_torch_bf16.py)
    ("cyclegan", "grad", "arch"): None,  # measured 0.63
    # the arch losses read the teachers' val-batch forwards and differences
    # of discriminator means
    ("cyclegan", "loss", "arch"): None,  # measured 1.41
}
ARCH_KEYS = ("D_arch_A", "D_arch_B", "D_arch_diff_A", "D_arch_diff_B",
             "teacher_netD_A_arch_diff", "teacher_netD_B_arch_diff")


def loss_groups(keys):
    """The losses by the update that computes them: the student D's, the
    teachers' and student G's, the arch step's."""
    arch = [k for k in keys if k in ARCH_KEYS]
    d = [k for k in keys if k in ("D_A", "D_B")]
    return {"D": d, "arch": arch,
            "G": [k for k in keys if k not in arch and k not in d]}


def test_step_losses_bf16(step):
    """Each update's losses together at ratio <= 1/4 unless STEP_BOUNDS
    names them. Measured: D 0.17, G 0.22, arch 1.41."""
    j, b, f = step["jax"][0], step[BF][0], step[torch.float32][0]
    assert set(j) == set(b) == set(f)
    for group, keys in loss_groups(sorted(j)).items():
        assert keys, group
        check_ratio(STEP_BOUNDS, "cyclegan", "loss", group,
                    joint_ratio(b, j, f, keys))


def test_step_gradients_bf16(step):
    """Each optimizer's gradients (its first moments after one step, 0.5
    of the gradient at betas (0.5, 0.999)), fp32 and finite, at ratio <=
    1/4 unless STEP_BOUNDS names them. Measured: d 0.32, g (with the
    transforms) 0.34, td 0.54, tg 0.58, arch 0.63."""
    jmu, bmu, fmu = step["jax"][2], step[BF][2], step[torch.float32][2]
    assert set(jmu) == set(bmu) == {"g", "d", "tg", "td", "arch"}
    for opt in jmu:
        jl, bl, fl = (dict(leaves(t[opt])) for t in (jmu, bmu, fmu))
        assert set(jl) == set(bl) == set(fl), opt
        assert all(v.dtype == np.float32 and np.isfinite(v).all()
                   for v in bl.values())
        check_ratio(STEP_BOUNDS, "cyclegan", "grad", opt,
                    joint_ratio(bl, jl, fl, sorted(jl)))


def test_loss_trajectory_bf16():
    """Three iterations, the students at lr 2e-4, the teachers frozen
    (module docstring): after the step above, every loss finite, and over
    iterations 1 and 2 the port's bf16 losses at most 3/4 as far from
    gcc_tpu's bf16 ones as the port's fp32 losses are (rms over all
    losses). The fp32 classes of tests/test_torch_cyclegan.py do not
    apply: the teachers' first difference (STEP_BOUNDS) reaches every loss.
    Measured: 0.48."""
    num = den = 0.0
    for i, rec in enumerate(trajectory(3, LR)[1:], start=1):
        j, b, f = rec["jax"][0], rec[BF][0], rec[torch.float32][0]
        assert set(j) == set(b) and all(np.isfinite(list(b.values())))
        num += sum((b[k] - j[k]) ** 2 for k in j)
        den += sum((f[k] - j[k]) ** 2 for k in j)
    assert num <= 0.75 ** 2 * den
