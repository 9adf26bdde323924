"""The port's U-Net and its default pix2pix path against the JAX package.

* ``UnetGenerator``: output, the four captured features and the moved
  BatchNorm running stats of a train-mode forward, and an eval-mode output,
  against gcc_tpu's at ``use_dropout=False`` (masks cannot match across
  frameworks), for the default cfg and for a pruned cfg whose depth-4 block
  is elided; fp32 on the CPU, reduction order only: 2e-5 absolute.
* The weight mapping: strict both ways over the U-Net tree (bias-free
  downs and ups, ``up_0``'s bias, the BatchNorms).
* Three cooperative iterations of ``Pix2PixEngine`` with the U-Net backbone
  (online distillation, DARTS D, hinge, lambdas 100/50/1e4, no dropout)
  against gcc_tpu's engine from the same weights on the same numpy batches,
  at the bounds of tests/test_cooperative_parity.py: losses within
  1e-4 + 2e-3*|t|, every parameter, mask alpha and BatchNorm running stat
  within 5e-5.
* Port only: with dropout on, both student forwards of a train step draw
  one mask, both teacher forwards another, the arch step fresh ones.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.config import Config as JaxConfig  # noqa: E402
from gcc_tpu.engines.pix2pix import Pix2PixEngine as JaxEngine  # noqa: E402
from gcc_tpu.models.generators import UnetGenerator as JaxUnet  # noqa: E402
from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine  # noqa: E402
from gcc_tpu_torch.models import generators  # noqa: E402
from gcc_tpu_torch.models.generators import (  # noqa: E402
    UnetGenerator, unet_default_channel_cfgs, unet_default_filter_cfgs,
)
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    export_jax_variables, from_jax_nets, load_jax_variables, to_jax_nets,
)
from torch_limits import one_thread  # noqa: E402,F401

# the tiny configuration of tests/test_cooperative_parity.py
STUDENT_CFGS = [3, 6, 12, 20, 24, 20, 12, 6, 5]
KW = dict(model="pix2pix", backbone="unet", ngf=4, ndf=8, teacher_ngf=8,
          teacher_ndf=8, crop_size=32, num_downs=5, no_dropout=True,
          gan_mode="hinge", online_distillation=True,
          darts_discriminator=True, lambda_L1=100.0, lambda_content=50.0,
          lambda_gram=1e4, arch_lr=1e-4, lr=2e-4)
N_ITERS = 3
# 6 downs at 64 px: depth 4 (f[4], f[7] = 0) elided, depth 5 innermost
PRUNED = (6, 64, [3, 6, 12, 20, 0, 16, 16, 0, 12, 6, 5])


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


def test_default_cfgs():
    from gcc_tpu.models import generators as jg
    for ngf, n in ((64, 8), (4, 5), (32, 8)):
        assert unet_default_filter_cfgs(ngf, n) == \
            jg.unet_default_filter_cfgs(ngf, n)
        assert unet_default_channel_cfgs(ngf, n) == \
            jg.unet_default_channel_cfgs(ngf, n)


@pytest.mark.parametrize("case", ["default", "pruned"])
def test_unet_forward_matches_jax(case):
    n, size, f = (5, 32, None) if case == "default" else PRUNED
    jmod = JaxUnet(output_nc=3, num_downs=n, ngf=4, use_dropout=False,
                   filter_cfgs=f)
    x = np.random.RandomState(3).rand(2, size, size, 3).astype(np.float32) * 2 - 1
    v = _np(jmod.init({"params": jax.random.PRNGKey(1),
                       "dropout": jax.random.PRNGKey(2)},
                      jnp.asarray(x), train=True))
    # non-trivial running stats, so the eval forward reads them
    r = np.random.RandomState(4)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (r.rand(*a.shape) * 0.5 + 0.5).astype(np.float32),
        v["batch_stats"])
    port = UnetGenerator(3, 3, n, 4, False, f)
    load_jax_variables(port, v)
    if case == "pruned":
        assert port.depths == [0, 1, 2, 3, 5]
        assert not hasattr(port, "down_4") and not hasattr(port, "up_4")

    out, mut = jmod.apply(v, jnp.asarray(x), train=True,
                          mutable=["batch_stats", "intermediates"])
    feats = [np.asarray(mut["intermediates"][k][0])
             for k in sorted(mut["intermediates"])]
    got, got_feats = port.train()(nchw(x))
    assert len(got_feats) == len(feats) == 4
    assert [t.shape[1] for t in got_feats] == port.feature_widths
    np.testing.assert_allclose(nhwc(got), np.asarray(out), atol=2e-5)
    for a, b in zip(got_feats, feats):
        np.testing.assert_allclose(nhwc(a), b, atol=2e-5)
    stats = dict(_leaves(export_jax_variables(port)["batch_stats"]))
    for path, b in _leaves(_np(mut["batch_stats"])):
        np.testing.assert_allclose(stats[path], b, atol=2e-5)

    j_eval = jmod.apply({**v, "batch_stats": mut["batch_stats"]},
                        jnp.asarray(x), train=False)
    with torch.no_grad():
        got_eval, _ = port.eval()(nchw(x))
    np.testing.assert_allclose(nhwc(got_eval), np.asarray(j_eval), atol=2e-5)


def test_unet_weights_round_trip_strict():
    n, size, f = PRUNED
    jmod = JaxUnet(output_nc=3, num_downs=n, ngf=4, filter_cfgs=f)
    v = _np(jmod.init({"params": jax.random.PRNGKey(5),
                       "dropout": jax.random.PRNGKey(6)},
                      jnp.zeros((1, size, size, 3)), train=True))
    port = UnetGenerator(3, 3, n, 4, True, f)
    load_jax_variables(port, v)
    back = export_jax_variables(port)
    assert set(back) == set(v) == {"params", "batch_stats"}
    for coll in v:
        a, b = dict(_leaves(v[coll])), dict(_leaves(back[coll]))
        assert set(a) == set(b), coll
        for path in a:
            np.testing.assert_array_equal(a[path], b[path])
    assert "bias" not in back["params"]["down_0"]
    assert "bias" not in back["params"]["up_1"]
    assert "bias" in back["params"]["up_0"]
    # strict: a leaf the port has no place for, or a missing one, raises
    extra = {**v, "params": {**v["params"], "down_9": {"kernel": np.zeros(1)}}}
    with pytest.raises(ValueError):
        load_jax_variables(UnetGenerator(3, 3, n, 4, True, f), extra)
    missing = {**v, "params": {k: w for k, w in v["params"].items()
                               if k != "up_0"}}
    with pytest.raises((KeyError, ValueError)):
        load_jax_variables(UnetGenerator(3, 3, n, 4, True, f), missing)


@pytest.fixture(scope="module")
def runs():
    jeng = JaxEngine(JaxConfig(**KW), filter_cfgs=STUDENT_CFGS)
    jstate = jeng.init_state(jax.random.PRNGKey(0), image_size=32)
    nets0 = _np(jstate.nets)
    eng = Pix2PixEngine(Config(**KW), filter_cfgs=STUDENT_CFGS, device="cpu")
    state = from_jax_nets(eng, nets0)

    rng = np.random.RandomState(42)

    def mk():
        return rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1

    hist = []
    for _ in range(N_ITERS):
        A, B, Av, Bv = mk(), mk(), mk(), mk()
        jstate, m1 = jeng.train_step(
            jstate, {"A": jnp.asarray(A), "B": jnp.asarray(B)}, 2e-4)
        jstate, m2 = jeng.arch_step(
            jstate, {"A": jnp.asarray(Av), "B": jnp.asarray(Bv)}, 0.9)
        state, t1 = eng.train_step(state, {"A": nchw(A), "B": nchw(B)}, 2e-4)
        state, t2 = eng.arch_step(state, {"A": nchw(Av), "B": nchw(Bv)}, 0.9)
        hist.append(({k: float(v) for k, v in {**m1, **m2}.items()},
                     {k: float(v) for k, v in {**t1, **t2}.items()}))
    return nets0, _np(jstate.nets), to_jax_nets(state), hist


def test_engine_loss_trajectory_parity(runs):
    *_, hist = runs
    for i, (j, t) in enumerate(hist):
        assert set(j) == set(t)
        for k in j:
            tol = 1e-4 + 2e-3 * abs(j[k])
            assert abs(j[k] - t[k]) < tol, \
                f"iter {i} loss '{k}': jax {j[k]} vs port {t[k]}"


def test_engine_final_param_parity(runs):
    """Every parameter, mask alpha and BatchNorm running stat of the five
    nets after three iterations (the U-Net has no bias that feeds a norm,
    so nothing is left out), and they did move."""
    nets0, jnets, tnets, _ = runs
    assert set(jnets) == set(tnets) == {"g", "d", "tg", "td", "tf"}
    for net in jnets:
        jl, tl = dict(_leaves(jnets[net])), dict(_leaves(tnets[net]))
        assert set(jl) == set(tl), net
        for path in jl:
            d = np.max(np.abs(jl[path] - tl[path]))
            assert d < 5e-5, f"{net}/{path} diverged: {d}"
    for net, coll in (("g", "batch_stats"), ("tg", "batch_stats"),
                      ("d", "arch")):
        moved = max(np.max(np.abs(a - dict(_leaves(nets0[net][coll]))[p]))
                    for p, a in _leaves(jnets[net][coll]))
        assert moved > 1e-4, f"{net}/{coll} did not move"


def test_dropout_masks_shared_within_a_step(monkeypatch):
    """Dropout on (6 downs, so depth 4 drops): each forward draws one mask.
    Train step: teacher no-grad and update forwards share one, the
    student's two share another; the arch step draws fresh ones; eval
    (generate) draws none."""
    masks = []
    plain = generators.dropout

    def recording(x, rate, generator):
        out = plain(x, rate, generator)
        masks.append(out != 0)
        return out

    monkeypatch.setattr(generators, "dropout", recording)
    kw = {**KW, "num_downs": 6, "crop_size": 64, "no_dropout": False}
    eng = Pix2PixEngine(Config(**kw), device="cpu")
    state = eng.init_state(seed=0)
    rng = np.random.RandomState(7)
    batch = {k: torch.from_numpy(rng.rand(2, 3, 64, 64).astype(np.float32))
             for k in ("A", "B")}
    state, _ = eng.train_arch_step(state, batch, batch, 2e-4, 0.9)
    assert len(masks) == 6
    t_nograd, t_update, s_nograd, s_update, s_arch, t_arch = masks
    assert torch.equal(t_nograd, t_update)
    assert torch.equal(s_nograd, s_update)
    assert not torch.equal(s_arch, s_update)
    assert not torch.equal(t_arch, t_update)
    assert 0.3 < float(s_update.float().mean()) < 0.7
    eng.generate(state, batch["A"])
    assert len(masks) == 6
