"""SRGAN in the port against the JAX engine (gcc_tpu.engines.srgan).

* The online-distillation iteration (teacher G then teacher D, student G
  with content, adversarial, perceptual, sqrt-MSE distillation and L1 to
  the teacher, the unhalved student D, the arch step) over 3 iterations
  from the same weights on the same numpy batches: ngf 8 / ndf 8, teacher
  8/8, 32 px high resolution (x4), batch 2, vanilla GAN, a pruned student,
  and the perceptual term on: both sides get the same random VGG19 weights
  (scaled so that the features neither vanish nor blow up through the 16
  convs), each through its own reader of a torchvision state dict.
* ``--generator_only``'s content step (MSE + the scale sparsity) over 2
  iterations.
* The networks (SRResNet, SRGANDiscriminator, TruncatedVGG19) against
  flax's, ``lottery_transplant``, ``tv_loss``, the VGG readers, the
  perceptual term's refusal without weights, and the engine's without a
  card.

The JAX state is made from the port's initial nets and the JAX optimizers'
own init; the JAX steps are compiled with LLVM's expensive passes off
(their speed, not their arithmetic).

Bounds, the classes of tests/test_cooperative_parity_srgan.py: losses
within 1e-4 + 2e-3*|t|; parameters within 5e-5 and mask alphas within
1e-5, but the conv biases that feed a train-mode BatchNorm (no true
gradient: they random-walk at +-lr on both sides, forward-inert); running
means within 2*lr*N*1.25 (they follow those biases) and running variances
within 1e-4.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu.config import Config as JaxConfig  # noqa: E402
from gcc_tpu.engines.common import GANState as JaxState  # noqa: E402
from gcc_tpu.engines.srgan import SRGANEngine as JaxEngine  # noqa: E402
from gcc_tpu.engines.srgan import lottery_transplant as jax_transplant  # noqa: E402
from gcc_tpu.losses import tv_loss as jax_tv_loss  # noqa: E402
from gcc_tpu.metrics.vgg import TruncatedVGG19 as JaxVGG  # noqa: E402
from gcc_tpu.metrics.vgg import load_torch_vgg19 as jax_load_vgg  # noqa: E402
from gcc_tpu.models.discriminators import (  # noqa: E402
    SRGANDiscriminator as JaxSRD,
)
from gcc_tpu.models.generators import SRResNet as JaxSRResNet  # noqa: E402
from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.engines.srgan import SRGANEngine, lottery_transplant  # noqa: E402
from gcc_tpu_torch.losses import tv_loss  # noqa: E402
from gcc_tpu_torch.metrics.vgg import (  # noqa: E402
    VGG19_CONV_IDX, TruncatedVGG19, load_torch_vgg19,
)
from gcc_tpu_torch.models.discriminators import SRGANDiscriminator  # noqa: E402
from gcc_tpu_torch.models.generators import SRResNet  # noqa: E402
from gcc_tpu_torch.ops import flash_attention, mobile_block  # noqa: E402
from gcc_tpu_torch.ops.layers import init_params  # noqa: E402
from gcc_tpu_torch.utils.weights import (  # noqa: E402
    export_jax_variables, load_jax_variables, to_jax_nets,
)

LR, N_ITERS = 1e-4, 3
FILTERS = [4, 6, 8, 4, 6, 8, 4, 0, 8, 4, 6, 8, 4, 6, 8, 4]  # block 7 elided
KW = dict(model="srgan", ngf=8, ndf=8, teacher_ngf=8, teacher_ndf=8,
          image_size=32, upscale_factor=4, gan_mode="vanilla",
          online_distillation=True, darts_discriminator=True, lr=LR,
          arch_lr=1e-4, lambda_SR_content=1.0, lambda_SR_adversarial=1e-3,
          lambda_SR_perceptual=1.0, lambda_content=1.0, lambda_gram=1.0,
          lambda_L1=1.0)
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def vgg_state_dict(seed=0):
    """A torchvision-named VGG19 state dict of seeded He-scaled weights."""
    rng = np.random.RandomState(seed)
    sd, in_ch = {}, 3
    for idx in VGG19_CONV_IDX:
        out = 64 * min(2 ** sum(1 for p in (2, 7, 16, 25) if p < idx), 8)
        sd[f"features.{idx}.weight"] = (rng.randn(out, in_ch, 3, 3) * np.sqrt(
            2.0 / (9 * in_ch))).astype(np.float32)
        sd[f"features.{idx}.bias"] = (rng.randn(out) * 0.01).astype(
            np.float32)
        in_ch = out
    return sd


def jax_state(jeng, nets):
    """The JAX engine's step-0 state around JAX-layout nets: its own
    optimizer inits, as engines/srgan.py:103-131 builds them."""
    nets = jax.tree_util.tree_map(jnp.asarray, nets)
    g_bundle = {"g": nets["g"]["params"]}
    opts = {"d": jeng.tx_d.init(nets["d"]["params"])}
    if jeng.distill:
        g_bundle["tf"] = nets["tf"]["params"]
        if jeng.cfg.online_distillation:
            opts["td"] = jeng.tx_d.init(nets["td"]["params"])
            opts["tg"] = jeng.tx_g.init({"g": nets["tg"]["params"]})
    opts["g"] = jeng.tx_g.init(g_bundle)
    if jeng.darts:
        opts["arch"] = jeng.tx_arch.init(nets["d"]["arch"])
    return JaxState(step=jnp.int32(0), nets=nets, opts=opts,
                    ema={"d_arch": jnp.float32(0.0)},
                    rng=jax.random.PRNGKey(0))


def trajectory(kw, n_iters, seed, vgg=None):
    """(initial nets, per-iteration (JAX, port) nets, loss histories)."""
    jeng = JaxEngine(JaxConfig(**kw), filter_cfgs=FILTERS,
                     vgg_params=None if vgg is None else jax_load_vgg(vgg))
    eng = SRGANEngine(Config(**kw), filter_cfgs=FILTERS, device="cpu",
                      vgg_params=None if vgg is None else load_torch_vgg19(vgg))
    state = eng.init_state(seed=seed)
    nets0 = to_jax_nets(state)
    jstate = jax_state(jeng, nets0)
    rng = np.random.RandomState(seed)

    def mk():
        hr = rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
        lr_img = rng.rand(2, 8, 8, 3).astype(np.float32) * 2 - 1
        return lr_img, hr

    lr = jnp.float32(LR)
    step = jeng._content_step if kw.get("generator_only") \
        else jeng._train_step
    jtrain = jarch = None
    snaps, hist = [], []
    for _ in range(n_iters):
        (lt, ht), (lv, hv) = mk(), mk()
        jb = {"lr": jnp.asarray(lt), "hr": jnp.asarray(ht)}
        jv = {"lr": jnp.asarray(lv), "hr": jnp.asarray(hv)}
        if jtrain is None:
            jtrain = jax.jit(step).lower(jstate, jb, lr).compile(FAST)
            if eng.darts and not eng.generator_only:
                jarch = jax.jit(jeng._arch_step).lower(
                    jstate, jv, jnp.float32(0.9),
                    jnp.float32(1e-4)).compile(FAST)
        jstate, m = jtrain(jstate, jb, lr)
        state, t = eng.train_step(state, {"lr": _nchw(lt), "hr": _nchw(ht)},
                                  LR)
        if jarch is not None:
            jstate, m2 = jarch(jstate, jv, jnp.float32(0.9), jnp.float32(1e-4))
            state, t2 = eng.arch_step(state, {"lr": _nchw(lv),
                                              "hr": _nchw(hv)}, 0.9)
            m, t = {**m, **m2}, {**t, **t2}
        hist.append(({k: float(v) for k, v in m.items()},
                     {k: float(v) for k, v in t.items()}))
        snaps.append((_np(jstate.nets), to_jax_nets(state)))
    return nets0, snaps, hist


@pytest.fixture(scope="module")
def runs():
    return trajectory(KW, N_ITERS, 5, vgg=vgg_state_dict())


def feeds_batch_norm(net, path):
    """Conv biases followed by a train-mode BatchNorm: no true gradient."""
    if not path.endswith("/bias"):
        return False
    if net in ("g", "tg"):
        return path.startswith("params/block_") or path.startswith(
            "params/conv_mid/")
    return net in ("d", "td") and path.startswith(
        ("params/conv_1/", "params/conv_2/", "params/conv_3/"))


def check_params(jnets, tnets, n_iters):
    assert set(jnets) == set(tnets)
    for net in jnets:
        tl = dict(_leaves(tnets[net]))
        assert set(dict(_leaves(jnets[net]))) == set(tl), net
        for path, a in _leaves(jnets[net]):
            d = float(np.max(np.abs(np.asarray(a, np.float64) - tl[path])))
            if path.startswith("batch_stats/"):
                tol = 2 * LR * n_iters * 1.25 if path.endswith("/mean") \
                    else 1e-4
            elif feeds_batch_norm(net, path):
                continue
            else:
                tol = 1e-5 if path.startswith("arch/") else 5e-5
            assert d < tol, f"{net}/{path} diverged: {d}"


def test_loss_trajectory_parity(runs):
    _, _, hist = runs
    for i, (j, t) in enumerate(hist):
        assert set(j) == set(t), set(j) ^ set(t)
        for k in j:
            tol = 1e-4 + 2e-3 * abs(j[k])
            assert abs(j[k] - t[k]) < tol, \
                f"iter {i} loss '{k}': jax {j[k]} vs port {t[k]}"
    assert hist[0][1]["perceptual"] > 1e-3  # the VGG term is on


def test_final_param_parity(runs):
    _, snaps, _ = runs
    check_params(*snaps[-1], N_ITERS)


def test_prelu_and_bn_stats_moved(runs):
    """Every G trains its PReLU (the documented deviation from the
    reference's optimizer scan), and the running stats moved."""
    nets0, snaps, _ = runs
    jnets = snaps[-1][0]
    for net in ("g", "tg"):
        a0 = nets0[net]["params"]["prelu_in"]["alpha"]
        assert abs(float(jnets[net]["params"]["prelu_in"]["alpha"]) - a0) > 0
    for net in ("g", "d", "td"):
        moved = max(float(np.max(np.abs(a - dict(_leaves(
            nets0[net]["batch_stats"]))[p])))
            for p, a in _leaves(jnets[net]["batch_stats"]))
        assert moved > 1e-4, net


def test_no_kernel_on_this_path(runs):
    assert not any(mobile_block.LAUNCHES.values())
    assert not any(flash_attention.LAUNCHES.values())


def test_generator_only_content_step():
    """--generator_only: MSE + the scale sparsity on G alone, 2 steps."""
    kw = {**KW, "generator_only": True, "online_distillation": False,
          "darts_discriminator": False, "lambda_scale": 1e-2}
    _, snaps, hist = trajectory(kw, 2, 8)
    for j, t in hist:
        assert set(j) == set(t) == {"content"}
        assert abs(j["content"] - t["content"]) < 1e-4 + 2e-3 * j["content"]
    check_params(*snaps[-1], 2)


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------

def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


def flax_variables(jnet, x, net, seed):
    """The port net's JAX-layout variables, each leaf moved by a seeded
    N(0, 0.1), after checking that they have exactly the tree and shapes
    of the flax module's own init (``jax.eval_shape``: nothing computed)."""
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = export_jax_variables(init_params(
        net, torch.Generator().manual_seed(seed)))
    assert _plain(variables) == _plain(shapes)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.randn(*np.shape(a))).astype(np.float32),
        variables)


def _train_apply(jnet, variables, x):
    return jax.jit(lambda v, x: jnet.apply(
        v, x, train=True, mutable=["batch_stats", "intermediates"]))(
        variables, jnp.asarray(x))


def test_srresnet_matches_jax():
    """A pruned SRResNet (one block elided) against flax's, train mode:
    output, the four features, and the running stats it moved."""
    x = np.random.RandomState(1).rand(2, 8, 8, 3).astype(np.float32)
    jnet = JaxSRResNet(n_channels=8, filter_cfgs=FILTERS)
    net = SRResNet(8, filter_cfgs=FILTERS)
    variables = flax_variables(jnet, x, net, 2)
    out, mut = _train_apply(jnet, variables, x)
    load_jax_variables(net, variables)
    y, feats = net.train()(_nchw(x))
    np.testing.assert_allclose(_nhwc(y), np.asarray(out), atol=2e-5)
    inter = mut["intermediates"]
    for f, key in zip(feats, sorted(inter)):
        np.testing.assert_allclose(_nhwc(f), np.asarray(inter[key][0]),
                                   atol=1e-4, rtol=1e-4)
    stats = dict(_leaves(export_jax_variables(net)["batch_stats"]))
    for path, a in _leaves(_np(mut["batch_stats"])):
        np.testing.assert_allclose(stats[path], a, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_srgan_discriminator_matches_jax(masked):
    x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
    jnet = JaxSRD(ndf=8, masked=masked)
    net = SRGANDiscriminator(8, masked=masked)
    variables = flax_variables(jnet, x, net, 4)
    if masked:  # alphas above the 0.5 threshold but one
        variables["arch"]["mask_1"]["alpha"][0] = 0.2
    out, mut = _train_apply(jnet, variables, x)
    load_jax_variables(net, variables)
    y, feats = net.train()(_nchw(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out),
                               atol=2e-5)
    inter = mut["intermediates"]
    for f, key in zip(feats, sorted(inter)):
        np.testing.assert_allclose(_nhwc(f), np.asarray(inter[key][0]),
                                   atol=2e-5)


def test_vgg_matches_jax_and_readers_agree(tmp_path):
    """TruncatedVGG19 against flax's on one torchvision state dict, read by
    both packages from an .npz, and by the port from a torch file."""
    sd = vgg_state_dict(1)
    np.savez(tmp_path / "vgg.npz", **sd)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "vgg.pth")
    ours = load_torch_vgg19(str(tmp_path / "vgg.npz"))
    theirs = _np(jax_load_vgg(str(tmp_path / "vgg.npz")))
    from_pth = load_torch_vgg19(str(tmp_path / "vgg.pth"))
    for path, a in _leaves(theirs):
        np.testing.assert_array_equal(dict(_leaves(ours))[path], a)
        np.testing.assert_array_equal(dict(_leaves(from_pth))[path], a)
    x = np.random.RandomState(2).randn(1, 32, 32, 3).astype(np.float32)
    ref = JaxVGG().apply({"params": theirs}, jnp.asarray(x))
    net = TruncatedVGG19()
    load_jax_variables(net, {"params": ours})
    got = net(_nchw(x))
    assert got.shape == (1, 512, 2, 2)
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref),
                               atol=1e-5 * scale, rtol=1e-4)


def test_tv_loss_matches_jax():
    x = np.random.RandomState(5).randn(2, 9, 7, 3).astype(np.float32)
    assert abs(float(tv_loss(_nchw(x), 0.5))
               - float(jax_tv_loss(jnp.asarray(x), 0.5))) < 1e-6


def test_lottery_transplant_matches_jax():
    """Kept channels by score, from a full checkpoint into the pruned
    student: the same trees as gcc_tpu's, and the student takes them."""
    x = np.zeros((1, 8, 8, 3), np.float32)
    full = flax_variables(JaxSRResNet(n_channels=8), x, SRResNet(8),
                          6)["params"]
    student = SRResNet(8, filter_cfgs=FILTERS)
    pruned = flax_variables(JaxSRResNet(n_channels=8, filter_cfgs=FILTERS),
                            x, student, 1)
    scores = [np.random.RandomState(b).rand(8) for b in range(16)]
    ours = lottery_transplant(pruned["params"], full, FILTERS, scores)
    theirs = _np(jax_transplant(pruned["params"], full, FILTERS, scores))
    assert set(ours) == set(theirs)
    for path, a in _leaves(theirs):
        np.testing.assert_array_equal(dict(_leaves(ours))[path], a, path)
    load_jax_variables(student, {**pruned, "params": ours})


def test_perceptual_off_without_weights(caplog):
    with caplog.at_level(logging.WARNING, logger="gcc-tpu-torch"):
        eng = SRGANEngine(Config(**KW), device="cpu")
    assert eng.vgg is None
    assert "perceptual loss DISABLED" in caplog.text


def test_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SRGANEngine(Config(**KW))
    assert SRGANEngine(Config(**KW), device="cpu").device.type == "cpu"
