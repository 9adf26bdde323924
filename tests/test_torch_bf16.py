"""The port's bf16 compute path (``--compute_dtype bfloat16``, the JAX
package's default) against gcc_tpu's bf16 run on the CPU.

Same weights, same numpy batches (made from a seed), both sides in bf16 with
fp32 parameters; gcc_tpu's fused stage (kernel B2) runs its Pallas kernels in
interpret mode, the port its kernels' plain versions. The bounds show that
the port reproduces bf16's rounding, not fp32's:

* a single-rounding layer (a conv with its bias, a transpose conv,
  BatchNorm in train and eval mode, InstanceNorm, the mask gate): within one
  bf16 ulp of gcc_tpu's bf16 output (ulp at the larger magnitude);
* a composed result: rms(port_bf16 - jax_bf16) <= 1/4 rms(jax_bf16 - fp32)
  for the same weights and batch. The fp32 side is gcc_tpu's fp32 run for
  the layers, the stage and the forwards, and the port's fp32 run for the
  engine steps (tests/test_torch_{unet,pix2pix}.py hold it to gcc_tpu's fp32
  engine within 5e-5, far below the bf16 differences), which spares a second
  JAX compile of each step. The measured ratio stands beside each bound.

gcc_tpu's programs are compiled with xla_allow_excess_precision off, so
that XLA rounds where the JAX source rounds, as the port (eager PyTorch)
does. With XLA's default the two first differ at a conv with a bias: XLA
keeps the conv's output in fp32 into the bias add (gcc_tpu/ops/layers.py:
70-80 rounds it to bf16 first), 29 % of a layer's outputs one or more ulps
apart; the U-Net's output was then at ratio 1.14, above any bound the rule
allows. Compiled that way, every layer alone and each generator forward
here are gcc_tpu's bit for bit; the engine steps' remaining differences
come from the frameworks' fp32 summation orders inside convolutions,
which a deep bf16 forward spreads (STEP_BOUNDS,
test_teacher_first_difference_bf16).

The B2 stage's plain versions sum the depthwise taps by kernel row,
((t0 + t1) + t2) + ((t3 + t4) + t5) + ((t6 + t7) + t8): in tap order, one
a in ~1000 rounded to the other bf16 neighbour of XLA's and the difference
spread through b, b-hat and the backward (dx at 0.33 of the bf16-fp32
difference); by rows, y and dx are gcc_tpu's bit for bit (measured).

The generators' and discriminators' forwards:
tests/test_torch_bf16_nets.py; the engine steps at learning rate 0
(STEP_BOUNDS): tests/test_torch_bf16_step.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gcc_tpu import losses as jlosses  # noqa: E402
from gcc_tpu.ops import layers as jl  # noqa: E402
from gcc_tpu.ops import mask as jmask  # noqa: E402
from gcc_tpu.ops.pallas.mobile_block import fused_sep_stage as jax_stage  # noqa: E402
from gcc_tpu_torch import losses  # noqa: E402
from gcc_tpu_torch.config import Config  # noqa: E402
from gcc_tpu_torch.engines.pix2pix import Pix2PixEngine  # noqa: E402
from gcc_tpu_torch.ops import layers, mask  # noqa: E402
from gcc_tpu_torch.ops import mobile_block as mb  # noqa: E402
from gcc_tpu_torch.utils.weights import load_jax_variables  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401
from torch_bf16_pix2pix_common import (  # noqa: E402
    BF, CONFIGS, LR, bf16_round, f32, max_ulps, nchw, nhwc, ratio, trajectory,
)


# ---------------------------------------------------------------------------
# single-rounding layers
# ---------------------------------------------------------------------------

def _layer(case, rng):
    """(JAX module, its variables, the port's module, NHWC input)."""
    x = (rng.randn(2, 8, 8, 6) * 2).astype(np.float32)
    if case in ("conv_bias", "conv_transpose"):
        jmod = (jl.Conv(5, (3, 3), (2, 2), 1) if case == "conv_bias" else
                jl.ConvTranspose(5, (4, 4), (2, 2), 1))
        port = (layers.Conv(6, 5, (3, 3), (2, 2), 1) if case == "conv_bias"
                else layers.ConvTranspose(6, 5, (4, 4), (2, 2), 1))
        v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
        v = {"params": {"kernel": np.asarray(v["params"]["kernel"]) * 5,
                        "bias": rng.randn(5).astype(np.float32)}}
    elif case.startswith("batchnorm"):
        jmod = jl.BatchNorm(use_running_average=case == "batchnorm_eval")
        port = layers.BatchNorm(6).train(case == "batchnorm_train")
        v = {"params": {"scale": 1 + rng.rand(6).astype(np.float32),
                        "bias": rng.randn(6).astype(np.float32)},
             "batch_stats": {"mean": rng.randn(6).astype(np.float32),
                             "var": 0.5 + rng.rand(6).astype(np.float32)}}
    elif case == "instance_norm":
        return jl.InstanceNorm(), {}, layers.InstanceNorm(), x
    else:  # the mask gate: alphas on both sides of the threshold and at it
        alpha = np.array([0.2, 0.5, 0.9, 0.7, 0.1, 1.0], np.float32)
        jmod, port = jmask.MaskGate(6), mask.MaskGate(6)
        v = {"params": {}, "arch": {"alpha": alpha}}
    load_jax_variables(port, v)
    return jmod, v, port, x


@pytest.mark.parametrize("case", ["conv_bias", "conv_transpose",
                                  "batchnorm_train", "batchnorm_eval",
                                  "instance_norm", "mask_gate"])
def test_layer_within_one_ulp(case):
    """Each layer's bf16 output is gcc_tpu's within one bf16 ulp, and bf16.
    Measured: 0 ulps in every case (bf16 BatchNorm takes gcc_tpu's one-pass
    statistics; with two-pass ones 0.4 % of a deeper BatchNorm's outputs
    were one ulp off)."""
    jmod, v, port, x = _layer(case, np.random.RandomState(1))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jmod.apply(v, xb, mutable=["batch_stats"])[0] if v else \
        jmod.apply({}, xb)
    assert want.dtype == jnp.bfloat16
    got = port(nchw(f32(xb)).to(BF))
    assert got.dtype == BF
    assert max_ulps(nhwc(got), f32(want)) <= 1.0


# ---------------------------------------------------------------------------
# the B2 stage: the plain versions against gcc_tpu's Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("relu,with_res", [(True, False), (False, True)])
def test_stage_plain_matches_jax_bf16(relu, with_res):
    """y, dx, dW_dw and dW_pw of one stage in bf16 (B 2, 8x8, C 16, M 24 or
    16). y and dx are bf16, the weight gradients fp32. Measured: y and dx
    equal gcc_tpu's bit for bit (ratio 0); dW differ by fp32 summation
    order only (ratios 4.0e-5 and 1.7e-4 for dW_dw, 2.4e-6 and 1.9e-5 for
    dW_pw)."""
    B, H, W, C = 2, 8, 8, 16
    M = 16 if with_res else 24
    rng = np.random.RandomState(0)
    x = rng.randn(B, H, W, C).astype(np.float32)
    dwk = (rng.randn(3, 3, 1, C) * 0.2).astype(np.float32)
    pwk = (rng.randn(1, 1, C, M) * 0.2).astype(np.float32)
    res = rng.randn(B, H, W, M).astype(np.float32) if with_res else None
    g = rng.randn(B, H, W, M).astype(np.float32)

    def jax_run(dt):
        r = None if res is None else jnp.asarray(res).astype(dt)
        y, vjp = jax.vjp(lambda a, d, p: jax_stage(a, d, p, r, relu),
                         jnp.asarray(x).astype(dt), jnp.asarray(dwk),
                         jnp.asarray(pwk))
        return (y,) + vjp(jnp.asarray(g).astype(dt))

    jb, j32 = jax_run(jnp.bfloat16), jax_run(jnp.float32)
    tx = nchw(bf16_round(x)).to(BF).requires_grad_(True)
    tdw = torch.from_numpy(np.ascontiguousarray(
        np.transpose(dwk, (3, 2, 0, 1)))).requires_grad_(True)
    tpw = torch.from_numpy(np.ascontiguousarray(
        np.transpose(pwk, (3, 2, 0, 1)))).requires_grad_(True)
    tres = None if res is None else nchw(bf16_round(res)).to(BF)
    ty = mb.fused_sep_stage(tx, tdw, tpw, tres, relu)
    grads = torch.autograd.grad(ty, (tx, tdw, tpw), nchw(bf16_round(g)).to(BF))
    assert ty.dtype == grads[0].dtype == BF
    assert grads[1].dtype == grads[2].dtype == torch.float32
    port = [nhwc(ty), nhwc(grads[0])] + [
        np.transpose(t.numpy(), (2, 3, 1, 0)) for t in grads[1:]]
    for name, p, b, r, bound in zip(("y", "dx", "dW_dw", "dW_pw"), port, jb,
                                    j32, (0.0, 0.0, 0.05, 0.05)):
        got = ratio(p, f32(b), f32(r))
        assert got <= bound, f"{name}: ratio {got}"


# ---------------------------------------------------------------------------
# the gram distillation term on both of its paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,hw", [(32, 4), (8, 4)])
def test_gram_pair_err_bf16(c, hw):
    """(32, 4x4): 2 hw <= c, the kernel-matrix identity; (8, 4x4): the direct
    grams. bf16 features against gcc_tpu's bf16 within 1e-5 relative
    (measured: 1.0e-6 and 2.0e-6 on the identity, fp32 summation order; 0
    on the direct grams), the ratio against the fp32 features' loss at most
    1/4 (measured 2.9e-3 and 0)."""
    rng = np.random.RandomState(2)
    f = rng.randn(2, hw, hw, c).astype(np.float32)
    t = (f + 0.5 * rng.randn(2, hw, hw, c)).astype(np.float32)
    for use_sqrt in (True, False):
        jb = float(jlosses.gram_pair_err(jnp.asarray(f).astype(jnp.bfloat16),
                                         jnp.asarray(t).astype(jnp.bfloat16),
                                         use_sqrt))
        j32 = float(jlosses.gram_pair_err(jnp.asarray(f), jnp.asarray(t),
                                          use_sqrt))
        got = float(losses.gram_pair_err(nchw(f).to(BF), nchw(t).to(BF),
                                          use_sqrt))
        assert abs(got - jb) <= 1e-5 * abs(jb)
        assert abs(got - jb) <= 0.25 * abs(jb - j32)


# ---------------------------------------------------------------------------
# the cooperative iteration: train_step + arch_step
# ---------------------------------------------------------------------------

def test_loss_trajectory_bf16():
    """Three U-Net iterations at lr 2e-4: every loss within 1e-2 of
    gcc_tpu's bf16 value, relative (measured at most 2.1e-3, 5.8e-3 and
    6.1e-3 by iteration; fp32 is 5.0e-3, 7.7e-3 and 8.8e-3 from it). The
    ratio rule does not apply past the first update: Adam's first steps are
    +-lr whatever the gradient's size, so a weight whose gradient is within
    bf16 noise of 0 steps either way (the first-step sign class of fp32
    parity, wider in bf16)."""
    for i, rec in enumerate(trajectory("unet", 3, LR)):
        j, b = rec["jax"][0], rec[BF][0]
        for k in j:
            assert abs(b[k] - j[k]) <= 1e-2 * abs(j[k]), \
                f"iteration {i} {k}: jax {j[k]} port {b[k]}"


# ---------------------------------------------------------------------------
# the port alone: the dtype stays bf16, and the entry points cast to it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_activations_stay_bf16(name):
    """Forward hooks on every module of G, D, the teacher G and D and the
    TransformConvs: each output tensor of one train_step + arch_step on a
    bf16 batch is bf16 (a bf16 activation times an fp32 parameter would
    promote to fp32 in torch). The fused stages are hooked too."""
    kw, student = CONFIGS[name]
    eng = Pix2PixEngine(Config(**kw), filter_cfgs=student, device="cpu")
    state = eng.init_state(seed=1)
    seen, bad = [], []

    def hook(mod, inp, out):
        for t in out if isinstance(out, (list, tuple)) else [out]:
            if isinstance(t, torch.Tensor):
                seen.append(type(mod).__name__)
                if t.dtype != BF:
                    bad.append((type(mod).__name__, t.dtype))

    for net in state.nets.values():
        for m in net.modules():
            m.register_forward_hook(hook)
    stage = mb.fused_sep_stage

    def audited(x, *a, **k):
        y = stage(x, *a, **k)
        seen.append("fused_sep_stage")
        if y.dtype != BF:
            bad.append(("fused_sep_stage", y.dtype))
        return y

    mb.fused_sep_stage = audited
    try:
        rng = np.random.RandomState(0)
        b = [{k: nchw(rng.rand(2, 32, 32, 3) * 2 - 1).to(BF) for k in "AB"}
             for _ in range(2)]
        state, m = eng.train_arch_step(state, b[0], b[1], LR, 0.9)
    finally:
        mb.fused_sep_stage = stage
    assert not bad, bad[:5]
    assert {"Conv", "BatchNorm", "MaskGate", "TransformConvs"} <= set(seen)
    if name == "resnet_fused":
        assert "fused_sep_stage" in seen
    assert all(v.dtype == torch.float32 for v in m.values())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_set_input_matches_jax(dtype):
    """cli.train's set_input: a float32 host batch and a uint8 (packed) one,
    --direction BtoA, against gcc_tpu.cli.train.set_input, in
    --compute_dtype: a float batch bit for bit; a uint8 one within one ulp
    (XLA divides by 255 as a product with its reciprocal; measured: bf16
    bit for bit, fp32 81 % of values one ulp of 1 apart)."""
    from gcc_tpu import config as jconfig
    from gcc_tpu.cli.train import set_input as jax_set_input
    from gcc_tpu_torch import config as tconfig
    from gcc_tpu_torch.cli.train import set_input

    argv = f"--model pix2pix --direction BtoA --compute_dtype {dtype}".split()
    rng = np.random.RandomState(4)
    for batch in ({"A": rng.rand(2, 8, 8, 3).astype(np.float32) * 2 - 1,
                   "B": rng.rand(2, 8, 8, 3).astype(np.float32) * 2 - 1},
                  {"A": rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8),
                   "B": rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)}):
        want = jax_set_input(jconfig.parse(argv), dict(batch))
        got = set_input(tconfig.parse(argv), dict(batch), "cpu")
        for k in "AB":
            assert got[k].dtype == getattr(torch, dtype)
            if batch[k].dtype == np.float32:
                np.testing.assert_array_equal(nhwc(got[k]), f32(want[k]))
            elif dtype == "bfloat16":
                assert max_ulps(nhwc(got[k]), f32(want[k])) <= 1.0
            else:  # one ulp of 1: x / 255 * 2 - 1 ends in a step of 2^-23
                np.testing.assert_allclose(nhwc(got[k]), f32(want[k]), rtol=0,
                                           atol=2.0 ** -23)


def test_cli_computes_in_the_flag_dtype(tmp_path):
    """python -m gcc_tpu_torch.cli.train on pix2pix: with default flags it
    logs bf16 and every engine step gets bf16 batches; --compute_dtype
    float32 logs float32 and gives float32 batches (the fp32 path, held to
    gcc_tpu by the fp32 parity files). SAGAN logs bf16 too, as every family
    computes in bf16 by default."""
    import logging
    from gcc_tpu_torch import config as tconfig
    from gcc_tpu_torch.cli import train as ttrain

    flags = ("--dataroot synthetic --dataset_mode synthetic --model pix2pix "
             "--ngf 4 --ndf 4 --num_downs 5 --crop_size 32 --load_size 32 "
             "--batch_size 2 --max_dataset_size 4 --num_threads 1 "
             "--n_epochs 1 --n_epochs_decay 0 --print_freq 2 --teacher_ngf 8 "
             "--teacher_ndf 8 --online_distillation --darts_discriminator "
             f"--gpu_ids -1 --checkpoints_dir {tmp_path}")
    seen = []
    orig = Pix2PixEngine.train_arch_step

    def spy(self, state, batch, val_batch, *a, **k):
        seen.append((batch["A"].dtype, val_batch["B"].dtype))
        return orig(self, state, batch, val_batch, *a, **k)

    Pix2PixEngine.train_arch_step = spy
    try:
        for name, extra, dt in (("bf", "", BF),
                                ("fp", " --compute_dtype float32",
                                 torch.float32)):
            seen.clear()
            assert ttrain.main(f"{flags}{extra} --name {name}".split()) == 0
            assert seen and all(s == (dt, dt) for s in seen)
            log = (tmp_path / name / "logger.log").read_text()
            word = str(dt).replace("torch.", "")
            assert f"port: computes in {word} (--compute_dtype {word})" in log
    finally:
        Pix2PixEngine.train_arch_step = orig
    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    logger = logging.getLogger("bf16-test")
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    ttrain.check_knobs(tconfig.parse(["--model", "sagan"]), logger)
    assert "port: computes in bfloat16 (--compute_dtype bfloat16)" in lines[0]
