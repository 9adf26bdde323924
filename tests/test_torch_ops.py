"""The PyTorch port's layers, mask gate, losses, config and schedules against
the JAX package's (gcc_tpu.ops.layers, ops.mask, losses, config,
utils.schedule).

Inputs are made with numpy from fixed seeds and handed to both sides; JAX
takes NHWC, the port NCHW, transposed at the boundary. Weights go from the
JAX modules' init into the port's through gcc_tpu_torch.utils.weights.
Tolerance 1e-6 absolute unless a case says otherwise: both sides run fp32
on the CPU and differ only in reduction order.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu import config as jconfig  # noqa: E402
from gcc_tpu import losses as jlosses  # noqa: E402
from gcc_tpu.ops import layers as jl  # noqa: E402
from gcc_tpu.ops import mask as jmask  # noqa: E402
from gcc_tpu.utils import schedule as jschedule  # noqa: E402
from gcc_tpu_torch import config as tconfig  # noqa: E402
from gcc_tpu_torch import losses as tlosses  # noqa: E402
from gcc_tpu_torch.ops import layers as tl  # noqa: E402
from gcc_tpu_torch.ops import mask as tmask  # noqa: E402
from gcc_tpu_torch.utils import schedule as tschedule  # noqa: E402
from gcc_tpu_torch.utils.weights import load_jax_variables  # noqa: E402

ATOL = 1e-6


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

CONV_CASES = {
    # name: (jax module, port module, input channels, spatial)
    "conv4x4_s2_p1": (lambda: jl.Conv(6, (4, 4), (2, 2), 1),
                      lambda: tl.Conv(5, 6, (4, 4), (2, 2), 1), 5, 12),
    "conv7_nobias": (lambda: jl.Conv(4, (7, 7), (1, 1), 0, use_bias=False),
                     lambda: tl.Conv(3, 4, (7, 7), use_bias=False), 3, 13),
    "depthwise3x3": (lambda: jl.Conv(5, (3, 3), feature_group_count=5),
                     lambda: tl.Conv(5, 5, (3, 3), groups=5), 5, 9),
    "deconv4x4_s2_p1": (lambda: jl.ConvTranspose(4, (4, 4), (2, 2), 1),
                        lambda: tl.ConvTranspose(6, 4, (4, 4), (2, 2), 1),
                        6, 7),
    "deconv3x3_output_padding": (
        lambda: jl.ConvTranspose(3, (3, 3), (2, 2), 1, output_padding=1),
        lambda: tl.ConvTranspose(5, 3, (3, 3), (2, 2), 1, 1), 5, 8),
    "separable": (lambda: jl.SeparableConv(7),
                  lambda: tl.SeparableConv(4, 7), 4, 10),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv_layers(case):
    jmod, tmod, cin, s = CONV_CASES[case]
    R = np.random.RandomState(0)
    x = R.uniform(-1, 1, (2, s, s + 1, cin)).astype(np.float32)
    jm = jmod()
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    if case == "separable":  # give the inert biases a value worth comparing
        v = jax.tree_util.tree_map(lambda a: a + 0.1, v)
    y = jm.apply(v, jnp.asarray(x))
    tm = tmod()
    load_jax_variables(tm, jax.tree_util.tree_map(np.asarray, v))
    close(nhwc(tm(nchw(x))), y)


def test_conv_init_std():
    """conv_init: N(0, 0.02) drawn from the caller's generator."""
    m = tl.init_params(tl.Conv(64, 64, (3, 3)), torch.Generator().manual_seed(0))
    assert abs(float(m.weight.detach().std()) - 0.02) < 1e-3
    assert float(m.bias.abs().max()) == 0.0
    m2 = tl.init_params(tl.Conv(64, 64, (3, 3)), torch.Generator().manual_seed(0))
    assert torch.equal(m.weight, m2.weight)


@pytest.mark.parametrize("mode", ["train_update", "train_frozen", "eval"])
def test_batchnorm(mode):
    """Batch stats in train mode; running stats updated with momentum 0.1 and
    the unbiased variance only when update_stats (JAX: batch_stats mutable)."""
    R = np.random.RandomState(2)
    x = (R.randn(3, 5, 6, 4) * 2 + 0.5).astype(np.float32)
    jm = jl.BatchNorm(use_running_average=(mode == "eval"))
    v = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    v = {"params": v["params"],
         "batch_stats": {"mean": jnp.asarray(R.randn(4), jnp.float32),
                         "var": jnp.asarray(R.rand(4) + 0.5, jnp.float32)}}
    if mode == "train_update":
        y, mut = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        stats = mut["batch_stats"]
    else:
        y, stats = jm.apply(v, jnp.asarray(x)), v["batch_stats"]
    tm = tl.BatchNorm(4)
    load_jax_variables(tm, jax.tree_util.tree_map(np.asarray, v))
    tm.train(mode != "eval")
    ty = tm(nchw(x), update_stats=(mode == "train_update"))
    close(nhwc(ty), y, 2e-6)
    close(tm.running_mean.numpy(), stats["mean"])
    close(tm.running_var.numpy(), stats["var"])


def test_instance_norm_and_activations():
    R = np.random.RandomState(4)
    x = (R.randn(2, 7, 5, 3) * 3 + 1).astype(np.float32)
    y = jl.InstanceNorm().apply({}, jnp.asarray(x))
    close(nhwc(tl.InstanceNorm()(nchw(x))), y, 2e-6)
    close(nhwc(tl.leaky_relu(nchw(x), 0.2)), jl.leaky_relu(jnp.asarray(x), 0.2))
    close(nhwc(tl.reflect_pad(nchw(x), 2)), jl.reflect_pad(jnp.asarray(x), 2))


# ---------------------------------------------------------------------------
# mask gate
# ---------------------------------------------------------------------------

def test_mask_from_alpha_values_and_ste():
    """mask in {0, 1/2, 1} (sign(0) = 0 gives 1/2) and the straight-through
    gradient: d/d alpha of sum(mask * w) is w itself."""
    alpha = np.array([0.2, 0.5, 0.9, 0.5000001, -1.0, 2.0], np.float32)
    w = np.arange(1, 7, dtype=np.float32)
    jm = jmask.mask_from_alpha(jnp.asarray(alpha), jnp.float32(0.5))
    a = torch.tensor(alpha, requires_grad=True)
    tm = tmask.mask_from_alpha(a, 0.5)
    close(tm.detach().numpy(), jm)
    assert tm[1].item() == 0.5
    jg = jax.grad(lambda al: jnp.sum(
        jmask.mask_from_alpha(al, jnp.float32(0.5)) * w))(jnp.asarray(alpha))
    (tg,) = torch.autograd.grad((tm * torch.tensor(w)).sum(), a)
    close(tg.numpy(), jg)
    close(tg.numpy(), w)


def test_mask_gate_and_clip():
    """MaskGate on an activation: output and alpha gradient against JAX's,
    and clip_alphas projects into [0, 1] in place."""
    R = np.random.RandomState(5)
    x = R.randn(2, 4, 3, 6).astype(np.float32)
    alpha = np.array([0.1, 0.5, 0.7, 1.3, -0.2, 0.49], np.float32)
    gw = R.randn(2, 4, 3, 6).astype(np.float32)

    def jloss(al):
        y = jmask.MaskGate(6).apply({"arch": {"alpha": al}}, jnp.asarray(x))
        return jnp.sum(y * gw), y

    (_, jy), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(alpha))
    gate = tmask.MaskGate(6)
    with torch.no_grad():
        gate.alpha.copy_(torch.tensor(alpha))
    ty = gate(nchw(x))
    (tg,) = torch.autograd.grad((ty * nchw(gw)).sum(), gate.alpha)
    close(nhwc(ty), jy)
    close(tg.numpy(), jg, 2e-6)
    tmask.clip_alphas([gate.alpha])
    close(gate.alpha.detach().numpy(),
          jmask.clip_alphas({"a": jnp.asarray(alpha)})["a"])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

GAN_CASES = [(mode, real, for_d) for mode in jlosses.GAN_MODES
             for real in (True, False) for for_d in (True, False)
             if not (mode == "hinge" and not for_d and not real)]


@pytest.mark.parametrize("mode,real,for_d", GAN_CASES)
def test_gan_loss(mode, real, for_d):
    pred = np.random.RandomState(6).randn(2, 1, 5, 5).astype(np.float32) * 2
    j = jlosses.gan_loss(jnp.asarray(pred), real, mode, for_discriminator=for_d)
    t = tlosses.gan_loss(torch.from_numpy(pred), real, mode,
                         for_discriminator=for_d)
    close(t.numpy(), j)


def test_elementwise_losses_and_sqrt_floor():
    R = np.random.RandomState(7)
    a, b = R.randn(2, 3, 4, 4).astype(np.float32), R.randn(2, 3, 4, 4).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    close(tlosses.l1(ta, tb).numpy(), jlosses.l1(jnp.asarray(a), jnp.asarray(b)))
    close(tlosses.mse(ta, tb).numpy(), jlosses.mse(jnp.asarray(a), jnp.asarray(b)))
    close(tlosses.sqrt_mse(ta, tb).numpy(),
          jlosses.sqrt_mse(jnp.asarray(a), jnp.asarray(b)))
    # equal inputs: the 1e-12 floor keeps value and gradient finite
    x = torch.from_numpy(a).requires_grad_(True)
    v = tlosses.sqrt_mse(x, torch.from_numpy(a))
    (g,) = torch.autograd.grad(v, x)
    close(v.detach().numpy(), jlosses.sqrt_mse(jnp.asarray(a), jnp.asarray(a)))
    assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("hw,c", [(6, 5), (3, 32)])
def test_gram_and_gram_pair_err(hw, c):
    """gram and the fp32 (direct) gram_pair_err, including hw*hw < c/2, where
    only bf16 inputs take the JAX package's kernel-matrix identity; values
    and the gradient with respect to the student feature."""
    R = np.random.RandomState(8)
    f = R.randn(2, hw, hw, c).astype(np.float32)
    t = R.randn(2, hw, hw, c).astype(np.float32)
    close(tlosses.gram(nchw(f)).numpy(), jlosses.gram(jnp.asarray(f)))
    jv, jg = jax.value_and_grad(
        lambda a: jlosses.gram_pair_err(a, jnp.asarray(t)))(jnp.asarray(f))
    tf = nchw(f).requires_grad_(True)
    tv = tlosses.gram_pair_err(tf, nchw(t))
    (tg,) = torch.autograd.grad(tv, tf)
    close(tv.detach().numpy(), jv)
    close(nhwc(tg), jg, 1e-6 * max(1.0, float(np.max(np.abs(jg)))))


# ---------------------------------------------------------------------------
# config and schedules (the port's own copies)
# ---------------------------------------------------------------------------

ARGVS = [
    [],
    ["--model", "pix2pix", "--dataroot", "./database/cityscapes",
     "--backbone", "resnet", "--fused_resblock", "on", "--lambda_L1", "7"],
    ["--model", "cyclegan", "--lambda_weight", "1e-4", "--online_distillation"],
    ["--model", "srgan", "--mesh_shape", "2,4"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a[:2]) or "defaults")
def test_config_parse_matches(argv):
    j, t = jconfig.parse(argv), tconfig.parse(argv)
    port = dataclasses.asdict(t)
    # the port keeps --gpu_ids as a field (its CLIs' device); JAX drops it
    assert port.pop("gpu_ids") == "0"
    assert port == dataclasses.asdict(j)


@pytest.mark.parametrize("policy", ["linear", "step", "cosine"])
def test_schedules_match(policy):
    cfg = tconfig.Config(lr_policy=policy, n_epochs=5, n_epochs_decay=7,
                         lr_decay_iters=3, epoch_count=2, ema_beta=0.7)
    for epoch in range(1, 15):
        assert tschedule.lr_for_epoch(cfg, epoch) == \
            jschedule.lr_for_epoch(cfg, epoch)
        assert tschedule.ema_beta_for_epoch(cfg, epoch) == \
            jschedule.ema_beta_for_epoch(cfg, epoch)
