"""The port's networks against the JAX package's, with weights carried over
by gcc_tpu_torch.utils.weights: outputs and every captured distillation
feature, on the same numpy inputs (NHWC for JAX, NCHW for the port).

fp32 on the CPU; the two sides differ in reduction order only, through a
few dozen layers: bound 2e-5 absolute on outputs and features of O(1).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.models.discriminators import PatchGAN as JaxPatchGAN  # noqa: E402
from gcc_tpu.models.generators import (  # noqa: E402
    MobileResnetGenerator as JaxMobileResnet,
)
from gcc_tpu_torch.models.discriminators import PatchGAN  # noqa: E402
from gcc_tpu_torch.models.generators import MobileResnetGenerator  # noqa: E402
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    export_jax_variables, load_jax_variables,
)

ATOL = 2e-5
# pruned [c7, d1, d2, (l1, l2) x 9, u1, u2] with block 6 elided
PRUNED_CFG = [3, 6, 10, 4, 10, 7, 10, 5, 10, 2, 10, 6, 10, 3, 10, 0, 0,
              4, 10, 9, 10, 5, 2]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _jax_apply(mod, v, x, train, mutable=()):
    out, mut = mod.apply(v, jnp.asarray(x), train=train,
                         mutable=["intermediates", *mutable])
    inter = mut["intermediates"]
    feats = [np.asarray(inter[k][0]) for k in sorted(inter)]
    return np.asarray(out), feats, mut


@pytest.mark.parametrize("fused", [False, True])
def test_mobile_resnet_generator(fused):
    """Pruned student with an elided block; the port's fused and unfused
    paths both against the JAX unfused path."""
    R = np.random.RandomState(0)
    x = (R.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    jm = JaxMobileResnet(ngf=4, cfg=PRUNED_CFG, use_fused_blocks=False)
    v = _np(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x)))
    jy, jfeats, _ = _jax_apply(jm, v, x, train=True)
    tm = MobileResnetGenerator(ngf=4, cfg=PRUNED_CFG, use_fused_blocks=fused)
    load_jax_variables(tm, v)
    ty, tfeats = tm(nchw(x))
    np.testing.assert_allclose(nhwc(ty), jy, atol=ATOL)
    assert len(tfeats) == len(jfeats) == 4
    for i, (a, b) in enumerate(zip(tfeats, jfeats)):
        np.testing.assert_allclose(nhwc(a), b, atol=ATOL, err_msg=f"g_feat_{i}")


@pytest.mark.parametrize("masked", [False, True])
def test_patchgan_train_mode(masked):
    """Train-mode forward: output, d_feat_0/1 and the running stats it moves;
    masked: alphas below, at and above the threshold, and the alpha grads."""
    R = np.random.RandomState(1)
    x = R.randn(2, 32, 32, 6).astype(np.float32)
    jm = JaxPatchGAN(ndf=8, norm="batch", masked=masked)
    v = _np(jm.init({"params": jax.random.PRNGKey(1)}, jnp.asarray(x)))
    if masked:
        for name in v["arch"]:
            n = v["arch"][name]["alpha"].shape[0]
            v["arch"][name]["alpha"] = R.uniform(0, 1, n).astype(np.float32)
            v["arch"][name]["alpha"][0] = 0.5
    jy, jfeats, mut = _jax_apply(jm, v, x, train=True,
                                 mutable=("batch_stats",))
    tm = PatchGAN(6, ndf=8, norm="batch", masked=masked)
    load_jax_variables(tm, v)
    ty, tfeats = tm(nchw(x))
    np.testing.assert_allclose(nhwc(ty), jy, atol=ATOL)
    for i, (a, b) in enumerate(zip(tfeats, jfeats)):
        np.testing.assert_allclose(nhwc(a), b, atol=ATOL, err_msg=f"d_feat_{i}")
    exported = export_jax_variables(tm)
    for path, a in _leaves(mut["batch_stats"]):
        np.testing.assert_allclose(dict(_leaves(exported["batch_stats"]))[path],
                                   np.asarray(a), atol=1e-6, err_msg=path)
    if masked:
        w = R.randn(*jy.shape).astype(np.float32)

        def jloss(arch):
            out = jm.apply({**v, "arch": arch}, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])[0]
            return jnp.sum(out * w)

        jg = jax.grad(jloss)(v["arch"])
        alphas = [m.alpha for _, m in sorted(
            (n, m) for n, m in tm.named_modules() if n.startswith("mask_"))]
        ty2, _ = tm(nchw(x), update_stats=False)
        tg = torch.autograd.grad((ty2 * nchw(w)).sum(), alphas)
        for i, g in enumerate(tg):
            b = np.asarray(jg[f"mask_{i}"]["alpha"])
            np.testing.assert_allclose(g.numpy(), b,
                                       atol=1e-4 * max(1.0, np.abs(b).max()))


def test_patchgan_eval_and_frozen_stats():
    """Eval mode normalises with the running stats; a train-mode forward with
    update_stats=False leaves them untouched."""
    R = np.random.RandomState(2)
    x = R.randn(2, 32, 32, 6).astype(np.float32)
    jm = JaxPatchGAN(ndf=8, norm="batch")
    v = _np(jm.init({"params": jax.random.PRNGKey(2)}, jnp.asarray(x)))
    for node in v["batch_stats"].values():
        node["mean"] = R.randn(*node["mean"].shape).astype(np.float32) * 0.1
        node["var"] = R.uniform(0.5, 2, node["var"].shape).astype(np.float32)
    jy, jfeats, _ = _jax_apply(jm, v, x, train=False)
    tm = PatchGAN(6, ndf=8, norm="batch")
    load_jax_variables(tm, v)
    tm.train()
    tm(nchw(x), update_stats=False)
    tm.eval()
    ty, tfeats = tm(nchw(x))
    np.testing.assert_allclose(nhwc(ty), jy, atol=ATOL)
    for a, b in zip(tfeats, jfeats):
        np.testing.assert_allclose(nhwc(a), b, atol=ATOL)


@pytest.mark.parametrize("which", ["generator", "masked_patchgan"])
def test_weights_round_trip_exact(which):
    """JAX variables -> port -> JAX variables is the identity, leaf for leaf."""
    if which == "generator":
        jm = JaxMobileResnet(ngf=4, cfg=PRUNED_CFG, use_fused_blocks=True)
        x = jnp.zeros((1, 32, 32, 3))
        tm = MobileResnetGenerator(ngf=4, cfg=PRUNED_CFG)
    else:
        jm = JaxPatchGAN(ndf=8, norm="batch", masked=True)
        x = jnp.zeros((1, 32, 32, 6))
        tm = PatchGAN(6, ndf=8, masked=True)
    v = _np(jm.init({"params": jax.random.PRNGKey(3)}, x))
    load_jax_variables(tm, v)
    back = export_jax_variables(tm)
    assert set(back) == set(v)
    for coll in v:
        a, b = dict(_leaves(v[coll])), dict(_leaves(back[coll]))
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sign_sparsity_and_adam_match_jax():
    """add_sign_sparsity (conv kernels, BN scales) and one Adam step with an
    external LR against gcc_tpu.engines.common on a PatchGAN's parameters."""
    from gcc_tpu.engines.common import (
        adam_step, add_sign_sparsity as jax_sparsity, make_adam)
    from gcc_tpu_torch.engines.common import (
        Adam, add_sign_sparsity, weight_params)

    R = np.random.RandomState(4)
    jm = JaxPatchGAN(ndf=8, norm="batch", masked=True)
    v = _np(jm.init({"params": jax.random.PRNGKey(4)},
                    jnp.zeros((1, 32, 32, 6))))
    jgrads = jax.tree_util.tree_map(
        lambda a: R.randn(*a.shape).astype(np.float32) * 1e-3, v["params"])
    jg = jax_sparsity(jgrads, v["params"], 1e-2, 3e-2)
    tx = make_adam(0.5, 0.999)
    jp, _ = adam_step(tx, jg, tx.init(v["params"]), v["params"], 2e-4)

    tm = PatchGAN(6, ndf=8, masked=True)
    g_tree = {"params": jgrads, "batch_stats": v["batch_stats"],
              "arch": v["arch"]}
    load_jax_variables(tm, g_tree)  # the grads, laid out like the params
    tgrads = [p.detach().clone() for p in weight_params(tm)]
    load_jax_variables(tm, v)
    params = weight_params(tm)
    tg = add_sign_sparsity(tm, params, tgrads, 1e-2, 3e-2)
    Adam(params, 0.5, 0.999).step(params, tg, 2e-4)
    back = dict(_leaves(export_jax_variables(tm)["params"]))
    for path, a in _leaves(_np(jp)):
        np.testing.assert_allclose(back[path], a, atol=1e-7, err_msg=path)
