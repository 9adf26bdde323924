"""pix2pix's generators and discriminators in bf16 against gcc_tpu's bf16
run on the CPU, from the same variables on the same batch: the U-Net and
the resnet generators' forwards (fused and unfused), the first convolution
at which each teacher's two forwards round apart, and the discriminators
on gcc_tpu's own generator outputs. The rules: tests/test_torch_bf16.py's
docstring.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu import losses as jlosses  # noqa: E402
from gcc_tpu.models import generators as jgen  # noqa: E402
from gcc_tpu_torch import losses  # noqa: E402
from gcc_tpu_torch.engines.common import weight_params  # noqa: E402
from gcc_tpu_torch.models.generators import (  # noqa: E402
    MobileResnetGenerator, UnetGenerator,
)
from gcc_tpu_torch.ops import layers  # noqa: E402
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    export_jax_variables, from_jax_nets, load_jax_variables,
)
from torch_limits import one_thread  # noqa: E402,F401
from torch_bf16_pix2pix_common import (  # noqa: E402
    BF, CONFIGS, EXACT, _jax_tree, _joint_ratio, _leaves, bf16_round, f32,
    max_ulps, nchw, nhwc, ratio, setup,
)


GENERATORS = {
    "unet": (lambda: jgen.UnetGenerator(num_downs=5, ngf=4, use_dropout=False),
             lambda: UnetGenerator(3, 3, 5, 4, False)),
    "resnet_unfused": (
        lambda: jgen.MobileResnetGenerator(ngf=4, use_fused_blocks=False),
        lambda: MobileResnetGenerator(3, 3, 4, use_fused_blocks=False)),
    "resnet_fused": (
        lambda: jgen.MobileResnetGenerator(ngf=4, use_fused_blocks=True),
        lambda: MobileResnetGenerator(3, 3, 4, use_fused_blocks=True)),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_forward_bf16(name):
    """The train-mode output and the four captured features in bf16, from
    the same variables on the same batch: ratio <= 1/4. Measured: 0 for
    every output of the three (bit for bit)."""
    jmake, tmake = GENERATORS[name]
    jmod = jmake()
    x = (np.random.RandomState(3).rand(2, 32, 32, 3) * 2 - 1).astype(
        np.float32)
    v = jax.tree_util.tree_map(np.asarray, jmod.init(
        {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
        jnp.asarray(x), train=True))
    port = tmake().train()
    load_jax_variables(port, v)

    def jax_run(dt):
        xd = jnp.asarray(x).astype(dt)
        out, mut = jax.jit(lambda v, x: jmod.apply(
            v, x, train=True, mutable=["batch_stats", "intermediates"])).lower(
            v, xd).compile(EXACT)(v, xd)
        feats = mut["intermediates"]
        return [out] + [feats[k][0] for k in sorted(feats)]

    jb, j32 = jax_run(jnp.bfloat16), jax_run(jnp.float32)
    with torch.no_grad():
        out, feats = port(nchw(bf16_round(x)).to(BF))
    assert out.dtype == BF and all(f.dtype == BF for f in feats)
    for i, (p, b, r) in enumerate(zip([out] + feats, jb, j32)):
        got = ratio(nhwc(p), f32(b), f32(r))
        assert got <= 0.25, f"{name} output {i}: ratio {got}"


def _jax_modules(tree, prefix=""):
    """{module path: its first output} from flax's captured intermediates."""
    out = {}
    for k, v in tree.items():
        if k == "__call__":
            out[prefix[:-1]] = v[0]
        elif isinstance(v, dict):  # not a sown feature
            out.update(_jax_modules(v, f"{prefix}{k}."))
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_teacher_first_difference_bf16(name):
    """Where the teacher's bf16 forward first leaves gcc_tpu's: the step's
    teacher G on its train and val batches, module by module in the port's
    order. The first module whose output differs, if one does, is a
    convolution, at one bf16 ulp in at most 1 % of its outputs: the two
    frameworks' fp32 sums rounding to different bf16 neighbours. (A
    convolution that rounded at another point than gcc_tpu's differs at far
    more: 29 % of a layer's outputs with XLA's excess precision on, module
    docstring.) Measured: resnet_fused down_1 (3x3 stride 2, 8 -> 16) on the
    train batch, 0.024 % of its outputs, and conv_in (7x7, 3 -> 8) on the
    val batch, 0.006 %; unet none on the train batch and down_2 (4x4 stride
    2, 16 -> 32) on the val batch, 0.098 %. At the teacher's output that
    reads 0.47 and 0 (bit for bit) for resnet_fused's train and val batch,
    0 and 0.53 for unet's: the ratios STEP_BOUNDS's named results inherit."""
    eng, jeng, nets0, batches = setup(name, 0.0)
    A, _, Av, _ = batches()
    tg = from_jax_nets(eng, nets0).nets["tg"]
    order = []
    for mname, mod in tg.named_modules():
        if mname:
            mod.register_forward_hook(
                lambda m, i, o, n=mname: order.append((n, m, o)))
    jv = jax.tree_util.tree_map(jnp.asarray, nets0["tg"])

    def fwd(v, x):
        return jeng.TG.apply(v, x, train=True, capture_intermediates=True,
                             mutable=["intermediates"],
                             rngs={"dropout": jax.random.PRNGKey(0)})

    run = None
    for x in (A, Av):
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        run = run or jax.jit(fwd).lower(jv, xb).compile(EXACT)
        inter = _jax_modules(run(jv, xb)[1]["intermediates"])
        order.clear()
        with torch.no_grad():
            tg(nchw(bf16_round(x)).to(BF), None, update_stats=False)
        first = next(((n, m, o) for n, m, o in order
                      if isinstance(o, torch.Tensor)
                      and not np.array_equal(nhwc(o), f32(inter[n]))), None)
        if first is not None:
            n, m, o = first
            got, want = nhwc(o), f32(inter[n])
            assert isinstance(m, (layers.Conv, layers.ConvTranspose)), n
            assert max_ulps(got, want) <= 1.0, n
            assert np.mean(got != want) <= 0.01, n


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_discriminators_on_jax_fakes_bf16(name):
    """The step's discriminator work that reads a generator's output, fed
    gcc_tpu's own bf16 generator outputs: the teacher D's update on gcc_tpu's
    teacher fake (its gradients and running statistics) and the arch step's
    three D forwards on the val batch (the teacher D on gcc_tpu's teacher
    fake, D on its student fake and on the real pair), each at ratio <= 1/4;
    the fp32 side is gcc_tpu's fp32 run on the same batch. These are the
    results STEP_BOUNDS leaves without a bound in the composed iteration.
    Measured: td gradients 0.11 and 0.17 (resnet_fused, unet; 1.03 and 0.17
    in the composed iteration), running statistics 0.013 and 4e-4, the arch
    step's D outputs 0 and 0 (bit for bit; its losses are fp32 functions of
    them)."""
    from gcc_tpu.engines.common import apply_net, d_pair as jax_d_pair
    from gcc_tpu_torch.engines.common import d_pair

    eng, jeng, nets0, batches = setup(name, 0.0)
    A, B, Av, Bv = batches()
    jn = jax.tree_util.tree_map(jnp.asarray, nets0)
    rngs = {"dropout": jax.random.PRNGKey(0)}
    cat = lambda a, b: jnp.concatenate([a, b], -1)  # noqa: E731

    def fakes(nets, a, av):
        return (apply_net(jeng.TG, nets["tg"], a, rngs=rngs,
                          update_stats=False)[0],
                apply_net(jeng.G, nets["g"], av, rngs=rngs)[0],
                apply_net(jeng.TG, nets["tg"], av, rngs=rngs)[0])

    def discs(nets, a, b, av, bv, tfake, fake_v, tfake_v):
        def td_loss(p):
            v = {**nets["td"], "params": p}
            pf, pr, v = jax_d_pair(jeng.TD, v, cat(a, tfake), cat(a, b))
            return (jlosses.gan_loss(pf, False, jeng.gan_mode)
                    + jlosses.gan_loss(pr, True, jeng.gan_mode)) * 0.5, v

        (_, v), g = jax.value_and_grad(td_loss, has_aux=True)(
            nets["td"]["params"])
        return (g, v["batch_stats"],
                apply_net(jeng.TD, nets["td"], cat(av, tfake_v))[0],
                apply_net(jeng.D, nets["d"], cat(av, fake_v))[0],
                apply_net(jeng.D, nets["d"], cat(av, bv))[0])

    want = {}
    for dt in (jnp.bfloat16, jnp.float32):
        batch = [jnp.asarray(x).astype(dt) for x in (A, B, Av, Bv)]
        jf = jax.jit(fakes).lower(jn, batch[0], batch[2]).compile(EXACT)(
            jn, batch[0], batch[2])
        args = batch + list(jf)
        want[dt] = jax.tree_util.tree_map(f32, jax.jit(discs).lower(
            jn, *args).compile(EXACT)(jn, *args))
        if dt == jnp.bfloat16:
            inputs = args

    st = from_jax_nets(eng, nets0)
    TD, D = st.nets["td"], st.nets["d"]
    a, b, av, bv, tfake, fake_v, tfake_v = (nchw(f32(x)).to(BF)
                                            for x in inputs)
    pf, pr, _ = d_pair(TD, torch.cat([a, tfake], 1), torch.cat([a, b], 1))
    loss = (losses.gan_loss(pf, False, eng.gan_mode)
            + losses.gan_loss(pr, True, eng.gan_mode)) * 0.5
    grads = torch.autograd.grad(loss, weight_params(TD))
    got = {"grad": dict(_leaves(_jax_tree(TD, grads))),
           "stats": dict(_leaves(export_jax_variables(TD)["batch_stats"]))}
    with torch.no_grad():
        outs = [TD(torch.cat([av, tfake_v], 1))[0],
                D(torch.cat([av, fake_v], 1))[0], D(torch.cat([av, bv], 1))[0]]
    got["arch"] = {k: nhwc(o) for k, o in zip(("tpf", "pf", "pr"), outs)}
    ref = {}
    for dt, w in want.items():
        ref[dt] = {"grad": dict(_leaves(w[0])), "stats": dict(_leaves(w[1])),
                   "arch": dict(zip(("tpf", "pf", "pr"), w[2:]))}
    for kind, port in got.items():
        jb_, j32 = ref[jnp.bfloat16][kind], ref[jnp.float32][kind]
        assert set(port) == set(jb_), kind
        r = _joint_ratio(port, jb_, j32, sorted(port))
        assert r <= 0.25, f"{name} {kind}: ratio {r}"
