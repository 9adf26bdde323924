"""The port's SAGAN networks, optimizer and cooperative iteration against the
JAX package's.

Weights are carried across by gcc_tpu_torch.utils.weights, with every
attention gamma set non-zero (0.5 for attn1, -0.3 for attn2): at the
initial gamma = 0 attention adds nothing and its q/k/v gradients are zero,
so a broken attention backward would pass. Inputs are numpy arrays, NHWC
for JAX and NCHW for the port. At 64 px the generators' attn2 has N = 1024,
so the port runs it through flash_attention (its plain route on the CPU)
while JAX on the CPU takes its einsum path.

Bounds. Networks: outputs and features within 2e-5, spectral vectors within
1e-5, running stats within 1e-6 (fp32, reduction order only). The
cooperative iteration is held to the tolerance classes of
tests/test_cooperative_parity_sagan.py, whose docstring measured the regime:
with Adam betas (0, 0.9) the first step is sign(g), so fp32 noise flips the
step of near-zero gradient entries and the spectral power iteration
amplifies those deltas (chaos, not a systematic error). A wiring fault shows
at iteration 0, where the losses agree within 2e-5 + 2e-4|t| (the arch-step
losses and G_GAN, one sign-step downstream, within that test's own
iteration-0 bounds). The cooperative iteration's tests are in
tests/test_torch_sagan_step.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.engines.common import (  # noqa: E402
    add_sign_sparsity as jax_sparsity, dup_adam_step, dup_path_mask,
    make_adam,
)
from gcc_tpu.engines.sagan import SAGANEngine as JaxEngine  # noqa: E402
from gcc_tpu.models.discriminators import (  # noqa: E402
    SAGANDiscriminator as JaxSAGAND,
)
from gcc_tpu.models.generators import SAGANGenerator as JaxSAGANG  # noqa: E402
from gcc_tpu_torch.engines.common import (  # noqa: E402
    DupAdam, add_sign_sparsity, weight_params,
)
from gcc_tpu_torch.engines.sagan import ref_dup_param  # noqa: E402
from gcc_tpu_torch.models.discriminators import SAGANDiscriminator  # noqa: E402
from gcc_tpu_torch.models.generators import SAGANGenerator  # noqa: E402
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    export_jax_variables, load_jax_variables,
)
from torch_limits import one_thread  # noqa: E402,F401
from torch_sagan_common import _leaves, _nchw, _np, _set_gammas  # noqa: E402

ATOL = 2e-5
G_CFG = [20, 12, 9, 16]  # pruned student widths (attn cq 1 and 2)


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _jax_apply(mod, v, x, train, mutable=()):
    out, mut = mod.apply(v, jnp.asarray(x), train=train,
                         mutable=["intermediates", *mutable])
    inter = mut["intermediates"]
    return np.asarray(out), [np.asarray(inter[k][0]) for k in sorted(inter)], mut


def _assert_state(mut, exported, atol):
    for coll in ("batch_stats", "spectral"):
        if coll not in mut:
            continue
        got = dict(_leaves(exported[coll]))
        for path, a in _leaves(_np(mut[coll])):
            np.testing.assert_allclose(got[path], a, atol=atol,
                                       err_msg=f"{coll}/{path}")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_generator_matches_jax(train):
    """Pruned widths; train mode moves BN stats and spectral state, eval
    reads running stats and stores nothing."""
    R = np.random.RandomState(0)
    z = R.randn(2, 8).astype(np.float32)
    jm = JaxSAGANG(ngf=8, z_dim=8, filter_cfgs=G_CFG)
    v = _set_gammas(_np(jm.init({"params": jax.random.PRNGKey(0)},
                                jnp.asarray(z))))
    for node in v["batch_stats"].values():
        node["mean"] = (R.randn(*node["mean"].shape) * 0.1).astype(np.float32)
        node["var"] = R.uniform(0.5, 2, node["var"].shape).astype(np.float32)
    mutable = ("batch_stats", "spectral") if train else ()
    jy, jfeats, mut = _jax_apply(jm, v, z, train, mutable)
    tm = SAGANGenerator(ngf=8, z_dim=8, filter_cfgs=G_CFG)
    load_jax_variables(tm, v)
    tm.train(train)
    ty, tfeats = tm(torch.from_numpy(z))
    np.testing.assert_allclose(_nhwc(ty), jy, atol=ATOL)
    assert ty.shape == (2, 3, 64, 64) and len(tfeats) == len(jfeats) == 2
    for i, (a, b) in enumerate(zip(tfeats, jfeats)):
        np.testing.assert_allclose(_nhwc(a), b, atol=ATOL, err_msg=f"g_feat_{i}")
    exported = export_jax_variables(tm)
    _assert_state(mut, exported, 1e-5)
    if not train:  # nothing stored
        _assert_state({"batch_stats": v["batch_stats"],
                       "spectral": v["spectral"]}, exported, 0.0)


@pytest.mark.parametrize("masked", [False, True])
def test_discriminator_matches_jax(masked):
    """Train-mode forward: output (B,), d_feat_0/1, the spectral vectors it
    moves; masked: alphas below, at and above the threshold, and the alpha
    gradients."""
    R = np.random.RandomState(1)
    x = (R.rand(2, 64, 64, 3) * 2 - 1).astype(np.float32)
    jm = JaxSAGAND(ndf=8, masked=masked, threshold=0.1)
    v = _set_gammas(_np(jm.init({"params": jax.random.PRNGKey(1)},
                                jnp.asarray(x))))
    if masked:
        for name in v["arch"]:
            n = v["arch"][name]["alpha"].shape[0]
            v["arch"][name]["alpha"] = R.uniform(0, 0.3, n).astype(np.float32)
            v["arch"][name]["alpha"][0] = 0.1
    jy, jfeats, mut = _jax_apply(jm, v, x, True, ("spectral",))
    tm = SAGANDiscriminator(ndf=8, masked=masked, threshold=0.1)
    load_jax_variables(tm, v)
    ty, tfeats = tm(_nchw(x))
    assert ty.shape == (2,)
    np.testing.assert_allclose(ty.detach().numpy(), jy, atol=ATOL)
    for i, (a, b) in enumerate(zip(tfeats, jfeats)):
        np.testing.assert_allclose(_nhwc(a), b, atol=ATOL, err_msg=f"d_feat_{i}")
    _assert_state(mut, export_jax_variables(tm), 1e-5)
    if masked:
        w = R.randn(2).astype(np.float32)

        def jloss(arch):
            out = jm.apply({**v, "arch": arch}, jnp.asarray(x), train=True,
                           mutable=["spectral"])[0]
            return jnp.sum(out * w)

        jg = jax.grad(jloss)(v["arch"])
        load_jax_variables(tm, v)
        ty2, _ = tm(_nchw(x))
        alphas = [getattr(tm, f"mask_{i}").alpha for i in range(1, 5)]
        tg = torch.autograd.grad((ty2 * torch.from_numpy(w)).sum(), alphas)
        for i, g in enumerate(tg):
            b = np.asarray(jg[f"mask_{i + 1}"]["alpha"])
            np.testing.assert_allclose(g.numpy(), b,
                                       atol=1e-4 * max(1.0, np.abs(b).max()))


def _jax_net(which):
    if which == "generator":
        jm, x = JaxSAGANG(ngf=8, z_dim=8, filter_cfgs=G_CFG), jnp.zeros((1, 8))
        tm = SAGANGenerator(ngf=8, z_dim=8, filter_cfgs=G_CFG)
    else:
        jm, x = JaxSAGAND(ndf=8, masked=True), jnp.zeros((1, 64, 64, 3))
        tm = SAGANDiscriminator(ndf=8, masked=True)
    return _set_gammas(_np(jm.init({"params": jax.random.PRNGKey(3)}, x))), tm


@pytest.mark.parametrize("which", ["generator", "masked_discriminator"])
def test_weights_round_trip_exact(which):
    """JAX variables -> port -> JAX variables is the identity, leaf for leaf,
    spectral u/v and gamma included."""
    v, tm = _jax_net(which)
    load_jax_variables(tm, v)
    back = export_jax_variables(tm)
    assert set(back) == set(v)
    for coll in v:
        a, b = dict(_leaves(v[coll])), dict(_leaves(back[coll]))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("fault", ["missing_v", "extra_leaf", "missing_gamma"])
def test_weights_load_is_strict(fault):
    v, tm = _jax_net("generator")
    if fault == "missing_v":
        del v["spectral"]["l3"]["v"]
        err = KeyError
    elif fault == "missing_gamma":
        del v["params"]["attn2"]["gamma"]
        err = KeyError
    else:
        v["spectral"]["l9"] = {"u": np.zeros(3, np.float32)}
        err = ValueError
    with pytest.raises(err):
        load_jax_variables(tm, v)


def test_dup_adam_matches_jax():
    """Two steps of DupAdam (betas 0, 0.9) over a masked D's weights against
    gcc_tpu's dup_adam_step with the engine's duplicate mask."""
    R = np.random.RandomState(4)
    v, tm = _jax_net("masked_discriminator")
    params = v["params"]
    mask = dup_path_mask(params, JaxEngine._ref_dup_param)
    tx, tx_dup = make_adam(0.0, 0.9), make_adam(0.0, 0.9)
    state = (tx.init(params), tx_dup.init(params))
    grads = [jax.tree_util.tree_map(
        lambda a: np.asarray(R.randn(*a.shape) * 1e-3, np.float32), params)
        for _ in range(2)]
    jp = params
    for g in grads:
        jp, state = dup_adam_step(tx, tx_dup, g, state, jp, 2e-4, mask)

    tgrads = []
    for g in grads:  # the grads, laid out like the params
        load_jax_variables(tm, {**v, "params": g})
        tgrads.append([p.detach().clone() for p in weight_params(tm)])
    load_jax_variables(tm, v)
    names = [n for n, _ in tm.named_parameters() if not n.endswith("alpha")]
    flags = [ref_dup_param(n) for n in names]
    assert 0 < sum(flags) < len(flags)
    opt = DupAdam(weight_params(tm), flags, 0.0, 0.9)
    for g in tgrads:
        opt.step(weight_params(tm), g, 2e-4)
    assert (opt.single.count, opt.double.count) == (2, 4)
    back = dict(_leaves(export_jax_variables(tm)["params"]))
    for path, a in _leaves(_np(jp)):
        np.testing.assert_allclose(back[path], a, atol=1e-7, err_msg=path)


def test_sign_sparsity_reaches_spectral_kernels():
    """add_sign_sparsity against gcc_tpu's on a generator: every kernel leaf
    (spectral deconvs, attention convs, the output deconv) and the BN scales."""
    R = np.random.RandomState(5)
    v, tm = _jax_net("generator")
    jgrads = jax.tree_util.tree_map(
        lambda a: np.asarray(R.randn(*a.shape) * 1e-3, np.float32), v["params"])
    jg = jax_sparsity(jgrads, v["params"], 1e-2, 3e-2)
    load_jax_variables(tm, {**v, "params": jgrads})
    tgrads = [p.detach().clone() for p in weight_params(tm)]
    load_jax_variables(tm, v)
    params = weight_params(tm)
    tg = add_sign_sparsity(tm, params, tgrads, 1e-2, 3e-2)
    with torch.no_grad():
        for p, g in zip(params, tg):
            p.copy_(g)
    back = dict(_leaves(export_jax_variables(tm)["params"]))
    for path, a in _leaves(_np(jg)):
        np.testing.assert_allclose(back[path], a, atol=1e-7, err_msg=path)
    moved = dict(_leaves(_np(jgrads)))
    assert np.abs(back["l2/kernel"] - moved["l2/kernel"]).min() > 9e-3
