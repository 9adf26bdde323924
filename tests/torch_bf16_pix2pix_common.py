"""The bf16 pix2pix tests' configurations, the ratio rule's measures and the
cooperative iteration of both packages (tests/test_torch_bf16.py,
tests/test_torch_bf16_nets.py, tests/test_torch_bf16_step.py).
"""

import copy

import numpy as np
import torch

import jax
import jax.numpy as jnp

from gcc_tpu.config import Config as JaxConfig
from gcc_tpu.engines.common import GANState as JaxState
from gcc_tpu.engines.pix2pix import Pix2PixEngine as JaxEngine
from gcc_tpu_torch.config import Config
from gcc_tpu_torch.engines.common import arch_params, weight_params
from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine
from gcc_tpu_torch.utils.weights import (
    export_jax_variables, from_jax_nets, to_jax_nets,
)


BF = torch.bfloat16
# gcc_tpu's bf16 programs are compiled to round where their source rounds
# (tests/test_torch_bf16.py's docstring)
EXACT = {"xla_allow_excess_precision": False}
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True, **EXACT}
LR, ARCH_LR = 2e-4, 1e-4
# the tiny configurations of tests/test_torch_{unet,pix2pix}.py; the resnet
# student keeps blocks 0 and 8 of its nine (the teacher all nine), which
# saves a third of the JAX compile of its fused stages
UNET_CFG = [3, 6, 12, 20, 24, 20, 12, 6, 5]
RESNET_CFG = [3, 6, 12, 5, 12] + [0, 0] * 7 + [3, 12, 6, 3]
BASE = dict(model="pix2pix", ngf=4, ndf=8, teacher_ngf=8, teacher_ndf=8,
            crop_size=32, no_dropout=True, gan_mode="hinge",
            online_distillation=True, darts_discriminator=True,
            lambda_L1=100.0, lambda_content=50.0, lambda_gram=1e4,
            arch_lr=ARCH_LR, lr=LR)
CONFIGS = {"unet": (dict(BASE, backbone="unet", num_downs=5), UNET_CFG),
           "resnet_fused": (dict(BASE, backbone="resnet",
                                 fused_resblock="on"), RESNET_CFG)}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def jax_state(jeng, nets):
    """gcc_tpu's step-0 pix2pix state around JAX-layout nets, its own
    optimizer inits (engines/pix2pix.py:118-140): flax's op-by-op init_state
    is not run."""
    nets = jax.tree_util.tree_map(jnp.asarray, nets)
    p = {k: v["params"] for k, v in nets.items()}
    opts = {"g": jeng.tx_g.init({"g": p["g"], "tf": p["tf"]}),
            "d": jeng.tx_d.init(p["d"]),
            "td": jeng.tx_d.init(p["td"]),
            "tg": jeng.tx_g.init({"g": p["tg"]}),
            "arch": jeng.tx_arch.init(nets["d"]["arch"])}
    return JaxState(step=jnp.int32(0), nets=nets, opts=opts,
                    ema={"d_arch": jnp.float32(0.0)},
                    rng=jax.random.PRNGKey(0))


def _jax_tree(net, values, collect=weight_params, coll="params"):
    """``values`` (one per ``collect(net)`` parameter) in the JAX layout of
    ``net``'s variables."""
    net = copy.deepcopy(net)
    with torch.no_grad():
        for p, v in zip(collect(net), values):
            p.copy_(v)
    return jax.tree_util.tree_map(np.asarray, export_jax_variables(net))[coll]


def _adam_mu(eng, state):
    """Each port optimizer's first moments in the JAX engine's opts layout:
    after one step from zero, (1 - b1) times the step's gradient."""
    nets, opts = state.nets, state.opts
    n_g = len(weight_params(nets["g"]))
    return {"g": {"g": _jax_tree(nets["g"], opts["g"].mu[:n_g]),
                  "tf": _jax_tree(nets["tf"], opts["g"].mu[n_g:])},
            "tg": {"g": _jax_tree(nets["tg"], opts["tg"].mu)},
            "td": _jax_tree(nets["td"], opts["td"].mu),
            "d": _jax_tree(nets["d"], opts["d"].mu),
            "arch": _jax_tree(nets["d"], opts["arch"].mu, arch_params, "arch")}


def setup(name, lr):
    """The port's and gcc_tpu's engines for a configuration at learning rate
    ``lr`` (the teachers' and, halved, the arch step's too), the nets of the
    port's seeded init in the JAX layout, and the batch source of the
    iterations (A, B, val A, val B per iteration)."""
    kw, student = CONFIGS[name]
    kw = dict(kw, lr=lr, arch_lr=lr / 2)
    eng = Pix2PixEngine(Config(**kw), filter_cfgs=student, device="cpu")
    nets0 = to_jax_nets(eng.init_state(seed=5))
    jeng = JaxEngine(JaxConfig(**kw), filter_cfgs=student)
    rng = np.random.RandomState(7)

    def batches():
        return [rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
                for _ in range(4)]

    return eng, jeng, nets0, batches


def trajectory(name, n_iters, lr):
    """gcc_tpu's bf16 iterations and the port's bf16 and fp32 ones from the
    port's seeded init on the same batches, at learning rate ``lr`` (the
    teachers' and the arch step's too). Per iteration: the three loss dicts,
    nets and Adam first moments (JAX engine layout) as {"jax", bf16, fp32}."""
    eng, jeng, nets0, batches = setup(name, lr)
    states = {dt: from_jax_nets(eng, nets0) for dt in (BF, torch.float32)}
    jst = jax_state(jeng, nets0)
    lr_, beta, alr = (jnp.float32(v) for v in (lr, 0.9, lr / 2))
    train = arch = None
    out = []
    for _ in range(n_iters):
        A, B, Av, Bv = batches()
        jb = {"A": jnp.asarray(A).astype(jnp.bfloat16),
              "B": jnp.asarray(B).astype(jnp.bfloat16)}
        jv = {"A": jnp.asarray(Av).astype(jnp.bfloat16),
              "B": jnp.asarray(Bv).astype(jnp.bfloat16)}
        if train is None:
            train = jax.jit(jeng._train_step).lower(jst, jb, lr_).compile(FAST)
            arch = jax.jit(jeng._arch_step).lower(jst, jv, beta, alr).compile(
                FAST)
        jst, m1 = train(jst, jb, lr_)
        jst, m2 = arch(jst, jv, beta, alr)
        np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        rec = {"jax": ({k: float(v) for k, v in {**m1, **m2}.items()},
                       np_(jst.nets),
                       {k: np_(o.mu) for k, o in jst.opts.items()})}
        for dt, st in states.items():
            tb = {"A": nchw(A).to(dt), "B": nchw(B).to(dt)}
            tv = {"A": nchw(Av).to(dt), "B": nchw(Bv).to(dt)}
            st, t1 = eng.train_step(st, tb, lr)
            st, t2 = eng.arch_step(st, tv, 0.9, lr / 2)
            rec[dt] = ({k: float(v) for k, v in {**t1, **t2}.items()},
                       to_jax_nets(st), _adam_mu(eng, st))
        out.append(rec)
    return out


def _joint_ratio(port, jbf, ref32, keys):
    """The ratio rule over several results at once: the rms of each side's
    differences over all of keys."""
    num = sum(np.sum(np.square(np.asarray(port[k], np.float64)
                               - np.asarray(jbf[k], np.float64))) for k in keys)
    den = sum(np.sum(np.square(np.asarray(jbf[k], np.float64)
                               - np.asarray(ref32[k], np.float64)))
              for k in keys)
    return float(np.sqrt(num / den))


def nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def f32(a):
    """A JAX or torch array as float32 numpy, its layout kept."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def bf16_round(a):
    """float32 numpy values rounded to bf16, back as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(BF).float().numpy()


def rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def ratio(port, jbf, ref32):
    """rms(port - jax_bf16) / rms(jax_bf16 - fp32)."""
    return rms(np.asarray(port) - jbf) / rms(jbf - np.asarray(ref32))


def max_ulps(got, want):
    """max |got - want| in bf16 ulps at the larger magnitude of the two."""
    big = np.maximum(np.abs(got), np.abs(want)).astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 2.0 ** -126))) - 7)
    return float(np.max(np.abs(got.astype(np.float64) - want) / ulp))
