"""The port's entry points, ``python -m gcc_tpu_torch.cli.{train,test}``, on
the CPU (``--gpu_ids -1``), against the JAX package's.

* The three-stage pix2pix workflow (sparsity pretrain -> prune to a budget
  + GCC train -> test from the checkpoint's cfg) for the U-Net, the same
  with the resnet backbone and fused blocks, a SAGAN train -> test, and
  the three stages of CycleGAN (per-direction budgets and best
  checkpoints) and SRGAN (--generator_only pretraining, a teacher from
  --teacher_initial_path, PSNR/SSIM per set): the files and log lines of
  tests/test_data_cli.py's round trips.
* Prune-on-startup from a stage-1 checkpoint written by gcc_tpu gives
  ``gcc_tpu.cli.train.build_engine``'s cfgs (U-Net, resnet, SAGAN, SRGAN,
  CycleGAN's two directions and horse2zebra's reference cfgs).
* A checkpoint trained by the port and one written by the JAX engine, each
  evaluated by ``gcc_tpu.cli.test`` (fp32 convolutions) and by the port's:
  the same proxy metric within 1e-4 relative; the port's CycleGAN and
  SRGAN checkpoints give gcc_tpu.cli.test's per-direction pixel-FID and
  per-set PSNR/SSIM within 1e-4 relative.
* Resume: 2 epochs straight equal 1 epoch + ``--continue_train`` for the
  second, bit for bit (parameters, Adam moments, EMA, step, dropout rng).
* SIGTERM after the first iteration's log line: exit 0 with
  ``preempted_in_epoch`` in the meta, then ``--continue_train`` restarts it.
* ``--check_numerics`` names a non-finite loss; without ``--gpu_ids -1``
  the CLIs need a card; XLA-only features raise.
* ``--inception_path`` naming a file: cli.get_real_stat, then the real
  FID branch at the epoch end and in the test CLI, the same value twice.
"""

import ast
import json
import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gcc_tpu.cli import test as jtest  # noqa: E402
from gcc_tpu.cli.train import build_engine as jbuild_engine  # noqa: E402
from gcc_tpu.config import parse as jparse  # noqa: E402
from gcc_tpu.utils import checkpoint as jckpt  # noqa: E402
from gcc_tpu_torch.cli import test as ttest  # noqa: E402
from gcc_tpu_torch.cli import train as ttrain  # noqa: E402
from gcc_tpu_torch.config import parse  # noqa: E402
from gcc_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from gcc_tpu_torch.utils.weights import export_jax_variables  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
UNET = ("--dataroot synthetic --dataset_mode synthetic --model pix2pix "
        "--ngf 4 --ndf 4 --num_downs 5 --crop_size 32 --load_size 32 "
        "--batch_size 4 --max_dataset_size 8 --num_threads 2 "
        "--n_epochs_decay 0 --save_epoch_freq 1 --print_freq 4")
GCC = ("--teacher_ngf 8 --teacher_ndf 8 --online_distillation "
       "--darts_discriminator --arch_lr_step --lambda_content 50 "
       "--lambda_gram 1e4")
CPU = " --gpu_ids -1"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny nets run best on one intra-op thread, and the test workers that
    share the host's cores then do not oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(args: str, exp) -> int:
    return ttrain.main(f"{args} --checkpoints_dir {exp}{CPU}".split())


def _test(args: str, exp) -> int:
    return ttest.main(f"{args} --checkpoints_dir {exp}{CPU}".split())


def _log(exp, name) -> str:
    return (Path(exp) / name / "logger.log").read_text()


def _metric(exp, name):
    """The test CLI's last metric: a number, or a dict of named ones."""
    return ast.literal_eval(re.findall(r"metrics: (.+)", _log(exp, name))[-1])


def test_three_stage_workflow_unet(tmp_path):
    exp = tmp_path / "exp"
    assert _train(f"{UNET} --n_epochs 1 --lambda_scale 1e-2 --name s1 "
                  f"--profile_steps 1", exp) == 0
    assert (exp / "s1" / "profile" / "trace.json").stat().st_size > 0
    s1 = exp / "s1" / "checkpoints"
    assert {"model_best_AtoB.ckpt", "model_1.ckpt", "train_state.ckpt",
            "train_state.json"} <= set(os.listdir(s1))
    assert {"opt.txt", "metrics.jsonl", "logger.log"} <= set(
        os.listdir(exp / "s1"))
    assert _train(f"{UNET} --n_epochs 1 {GCC} --scale_prune "
                  f"--target_budget 0.001 --pretrain_path "
                  f"{s1 / 'model_best_AtoB.ckpt'} --name s2", exp) == 0
    log = _log(exp, "s2")
    for line in ("pruned filter_cfgs", "pruned channel_cfgs",
                 "[proxy] pixel-FID (no inception weights)",
                 "d/mask_0/alpha sparsity ratio", "End of epoch 1 / 1",
                 "saving best model at epoch 1"):
        assert line in log, line
    best = exp / "s2" / "checkpoints" / "model_best_AtoB.ckpt"
    fc, cc = ckpt.restore_cfg(ckpt.load_checkpoint(str(best)))
    assert fc is not None and cc is not None
    assert fc != [4, 8, 16, 32, 32, 32, 16, 8, 4]  # actually pruned
    rec = [json.loads(x) for x in
           (exp / "s2" / "metrics.jsonl").read_text().splitlines()]
    assert [r["iters"] for r in rec] == [4, 8] and "D_arch" in rec[0]
    assert _test(f"{UNET} --pretrain_path {best} --name s3 --ntest 2",
                 exp) == 0
    assert sorted(os.listdir(exp / "s3" / "test_results")) == [
        f"synthetic_{i}_{v}.png" for i in (0, 1)
        for v in ("fake_B", "real_A", "real_B")]
    assert "dumped 2 results" in _log(exp, "s3")
    assert np.isfinite(_metric(exp, "s3"))


def test_resnet_fused_round_trip(tmp_path):
    exp = tmp_path / "exp"
    res = UNET + " --backbone resnet --fused_resblock on"
    assert _train(f"{res} --n_epochs 1 --lambda_scale 1e-2 --name r1",
                  exp) == 0
    s1 = exp / "r1" / "checkpoints" / "model_best_AtoB.ckpt"
    assert _train(f"{res} --n_epochs 1 {GCC} --scale_prune "
                  f"--target_budget 0.002 --pretrain_path {s1} --name r2",
                  exp) == 0
    assert "pruned filter_cfgs" in _log(exp, "r2")
    best = exp / "r2" / "checkpoints" / "model_best_AtoB.ckpt"
    assert _test(f"{res} --pretrain_path {best} --name r3 --ntest 2",
                 exp) == 0
    assert len(os.listdir(exp / "r3" / "test_results")) == 6


def test_sagan_round_trip(tmp_path):
    exp = tmp_path / "exp"
    sg = ("--dataroot synthetic --dataset_mode synthetic --model sagan "
          "--ngf 4 --ndf 4 --z_dim 16 --batch_size 4 --max_dataset_size 20 "
          "--num_threads 2 --n_epochs 1 --print_freq 8 --save_epoch_freq 1")
    assert _train(f"{sg} --teacher_ngf 8 --teacher_ndf 8 "
                  f"--online_distillation --darts_discriminator "
                  f"--lambda_content 1 --lambda_gram 1 --lr_policy plateau "
                  f"--arch_lr_step --name sg", exp) == 0
    best = exp / "sg" / "checkpoints" / "model_best_AtoB.ckpt"
    assert best.exists() and "End of epoch 1 / 1" in _log(exp, "sg")
    assert _test(f"{sg} --pretrain_path {best} --name sg_test --ntest 2",
                 exp) == 0
    assert sorted(os.listdir(exp / "sg_test" / "test_results"))[:2] == [
        "synthetic_0_fake_img.png", "synthetic_0_real_img.png"]


CG = ("--dataroot synthetic --dataset_mode synthetic --model cyclegan "
      "--ngf 4 --ndf 4 --crop_size 32 --load_size 32 --batch_size 1 "
      "--max_dataset_size 3 --num_threads 2 --n_epochs 1 --n_epochs_decay 0 "
      "--save_epoch_freq 1 --print_freq 1 --pool_size 2")
SR = ("--dataroot synthetic --dataset_mode synthetic --model srgan "
      "--ngf 8 --ndf 8 --image_size 32 --batch_size 2 --max_dataset_size 4 "
      "--num_threads 2 --n_epochs 1 --n_epochs_decay 0 --save_epoch_freq 1 "
      "--print_freq 2")


def _close(ours, theirs):
    """Each named metric within 1e-4 relative."""
    assert set(ours) == set(theirs)
    for k in ours:
        assert np.isfinite(ours[k]), k
        assert abs(ours[k] - theirs[k]) <= 1e-4 * abs(theirs[k]), \
            (k, ours[k], theirs[k])


def test_cyclegan_three_stages(tmp_path):
    """scripts/cyclegan/*.sh at tiny widths: heavy-sparsity pretraining,
    prune each direction to its budget on startup + GCC training, the
    test CLI; gcc_tpu.cli.test reads the port's checkpoint and gives the
    same pixel-FID per direction."""
    exp = tmp_path / "exp"
    assert _train(f"{CG} --lambda_weight 1e-3 --name c1", exp) == 0
    s1 = exp / "c1" / "checkpoints"
    assert {"model_1.ckpt", "model_best_AtoB.ckpt",
            "model_best_BtoA.ckpt"} <= set(os.listdir(s1))
    assert _train(f"{CG} --teacher_ngf 8 --teacher_ndf 8 "
                  f"--darts_discriminator --arch_lr 1e-4 --arch_lr_step "
                  f"--norm_prune --pretrain_path {s1 / 'model_1.ckpt'} "
                  f"--target_budget 0.002 --target_budget_B 0.0021 "
                  f"--online_distillation --lambda_content 0.01 "
                  f"--lambda_gram 10 --name c2", exp) == 0
    log = _log(exp, "c2")
    for line in ("pruned cfg_AtoB", "pruned cfg_BtoA",
                 "[proxy] AtoB pixel-FID", "[proxy] BtoA pixel-FID",
                 "d_a/mask_0/alpha sparsity ratio",
                 "d_b/mask_3/alpha sparsity ratio", "End of epoch 1 / 1",
                 "saving best [AtoB] at epoch 1",
                 "saving best [BtoA] at epoch 1"):
        assert line in log, line
    best = exp / "c2" / "checkpoints" / "model_best_AtoB.ckpt"
    cfg_a, cfg_b = ckpt.restore_cfg(ckpt.load_checkpoint(str(best)))
    assert cfg_a is not None and cfg_b is not None
    assert _test(f"{CG} --pretrain_path {best} --name c3 --ntest 2",
                 exp) == 0
    assert sorted(os.listdir(exp / "c3" / "test_results")) == [
        f"synthetic_{i}_{v}.png" for i in (0, 1)
        for v in ("fake_A", "fake_B", "real_A", "real_B", "rec_A", "rec_B")]
    assert jtest.main(f"{CG} --pretrain_path {best} --ntest 2 "
                      f"--compute_dtype float32 --checkpoints_dir {exp} "
                      f"--name j3".split()) == 0
    _close(_metric(exp, "c3"), _metric(exp, "j3"))


def test_srgan_three_stages(tmp_path):
    """scripts/srgan/*.sh at tiny widths: --generator_only sparsity
    pretraining, prune on startup + GCC training from a teacher checkpoint,
    the test CLI; gcc_tpu.cli.test reads the port's checkpoint and gives
    the same PSNR and SSIM."""
    exp = tmp_path / "exp"
    assert _train(f"{SR} --generator_only --name t0", exp) == 0
    assert _train(f"{SR} --generator_only --lambda_scale 1e-2 --name s1",
                  exp) == 0
    assert "content: " in _log(exp, "s1")
    teacher = exp / "t0" / "checkpoints" / "model_1.ckpt"
    assert _train(f"{SR} --teacher_ngf 8 --teacher_ndf 8 --scale_prune "
                  f"--target_budget 0.0037 --pretrain_path "
                  f"{exp / 's1' / 'checkpoints' / 'model_1.ckpt'} "
                  f"--teacher_initial_path {teacher} --darts_discriminator "
                  f"--arch_lr 1e-4 --arch_lr_step --online_distillation "
                  f"--lambda_gram 0.1 --lambda_content 0.1 --name s2",
                  exp) == 0
    log = _log(exp, "s2")
    for line in ("pruned filter_cfgs", "loaded teacher G from",
                 "perceptual loss DISABLED", "val: PSNR: ",
                 "saving best [val_psnr] at epoch 1",
                 "d/mask_0/alpha sparsity ratio", "End of epoch 1 / 1"):
        assert line in log, line
    best = exp / "s2" / "checkpoints" / "model_best_val_psnr.ckpt"
    fc, _ = ckpt.restore_cfg(ckpt.load_checkpoint(str(best)))
    assert fc is not None and fc != [8] * 16
    assert _test(f"{SR} --pretrain_path {best} --name s3 --ntest 2",
                 exp) == 0
    assert sorted(os.listdir(exp / "s3" / "test_results")) == [
        f"synthetic_{i}_{v}.png" for i in (0, 1)
        for v in ("fake_hr", "real_hr")]
    assert jtest.main(f"{SR} --pretrain_path {best} --ntest 2 "
                      f"--compute_dtype float32 --checkpoints_dir {exp} "
                      f"--name j3".split()) == 0
    _close(_metric(exp, "s3"), _metric(exp, "j3"))


@pytest.mark.parametrize("dataroot", ["synthetic", "synthetic/horse2zebra"])
def test_cyclegan_prune_on_startup_matches_jax(tmp_path, dataroot):
    path = str(tmp_path / "s1.ckpt")
    args = (f"{CG} --dataroot {dataroot} --norm_prune --target_budget 0.002 "
            f"--target_budget_B 0.0021 --pretrain_path {path}").split()
    nets = ttrain.engine_class("cyclegan")(parse(args),
                                           device="cpu").build_nets()
    rng = np.random.RandomState(0)
    payload = {f"G_{s}": {"params": _spread_tree(
        export_jax_variables(nets[f"g_{s.lower()}"])["params"], rng)}
        for s in "AB"}
    jckpt.save_checkpoint(path, {**payload, "epoch": 1,
                                 "cfg": (None, None), "fid": None})
    ours = ttrain.build_engine(parse(args), device="cpu")
    theirs = jbuild_engine(jparse(args))
    assert (ours.cfg_AtoB, ours.cfg_BtoA) == (theirs.cfg_AtoB,
                                              theirs.cfg_BtoA)
    assert ours.cfg_AtoB != ours.cfg_BtoA


def _spread_tree(tree, rng):
    if isinstance(tree, dict):
        return {k: _spread_tree(tree[k], rng) for k in sorted(tree)}
    return (np.asarray(rng.rand(*tree.shape), np.float32)
            * np.exp(rng.uniform(-6, 2, tree.shape[-1:])).astype(np.float32))


@pytest.mark.parametrize("flags,budget", [
    pytest.param(UNET + " --scale_prune", 0.0005, id="unet"),
    pytest.param(UNET + " --backbone resnet --scale_prune", 0.002,
                 id="resnet"),
    pytest.param("--dataroot synthetic --dataset_mode synthetic --model "
                 "sagan --ngf 8 --z_dim 16 --scale_prune", 0.004, id="sagan"),
    pytest.param("--dataroot synthetic/sr --dataset_mode synthetic --model "
                 "srgan --ngf 8 --image_size 32 --scale_prune", 0.0037,
                 id="srgan")])
def test_prune_on_startup_matches_jax(tmp_path, flags, budget):
    """A stage-1 checkpoint written by gcc_tpu (spread weights, as after
    sparsity pretraining) pruned on startup by both packages."""
    path = str(tmp_path / "s1.ckpt")
    cfg = parse(f"{flags} --target_budget {budget} --pretrain_path "
                f"{path}".split())
    net = ttrain.engine_class(cfg.model)(cfg, device="cpu").build_nets()["g"]
    params = _spread_tree(export_jax_variables(net)["params"],
                          np.random.RandomState(0))
    jckpt.save_checkpoint(path, {"G": {"params": params}, "epoch": 1,
                                 "cfg": (None, None), "fid": 1.0})
    ours = ttrain.build_engine(cfg, device="cpu")
    theirs = jbuild_engine(jparse(f"{flags} --target_budget {budget} "
                                  f"--pretrain_path {path}".split()))
    assert ours.filter_cfgs == theirs.filter_cfgs
    assert getattr(ours, "channel_cfgs", None) == theirs.channel_cfgs
    assert ours.filter_cfgs is not None


def test_proxy_metric_matches_jax_test_cli(tmp_path):
    """Both packages' test CLIs on a checkpoint the port trained and on one
    the JAX engine wrote: the same pixel-FID within 1e-4 relative."""
    import jax
    from gcc_tpu.engines.pix2pix import Pix2PixEngine as JEngine
    exp = tmp_path / "exp"
    small = UNET
    assert _train(f"{small} --n_epochs 1 --name p", exp) == 0
    port_ckpt = exp / "p" / "checkpoints" / "model_best_AtoB.ckpt"
    jcfg = jparse(f"{small} --compute_dtype float32".split())
    jeng = JEngine(jcfg)
    state = jeng.init_state(jax.random.PRNGKey(3))
    payload = jeng.checkpoint_payload(state, 1, None)
    rng = np.random.RandomState(1)
    payload["G"] = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (0.5 + rng.rand(*np.shape(a))
                                   ).astype(np.float32), payload["G"])
    jax_ckpt = tmp_path / "jax_model.ckpt"
    jckpt.save_checkpoint(str(jax_ckpt), payload)
    for tag, path in (("port", port_ckpt), ("jax", jax_ckpt)):
        args = (f"{small} --pretrain_path {path} --ntest 6 "
                f"--checkpoints_dir {exp}")
        assert jtest.main(f"{args} --compute_dtype float32 --name j_{tag}"
                          .split()) == 0
        assert _test(f"{small} --pretrain_path {path} --ntest 6 "
                     f"--name t_{tag}", exp) == 0
        j, t = _metric(exp, f"j_{tag}"), _metric(exp, f"t_{tag}")
        assert np.isfinite(t) and abs(t - j) <= 1e-4 * abs(j), (tag, t, j)
    # batched eval forwards (the last batch trimmed to the cap): the same
    assert _test(f"{small} --pretrain_path {port_ckpt} --ntest 6 "
                 f"--eval_batch 4 --name t_batched", exp) == 0
    batched, single = _metric(exp, "t_batched"), _metric(exp, "t_port")
    assert abs(batched - single) <= 1e-4 * abs(single)


def _final_state(path) -> dict:
    return ckpt.load_checkpoint(str(path))["state"]


def _same(a, b, where="state"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_resume_equals_uninterrupted(tmp_path):
    exp = tmp_path / "exp"
    base = f"{UNET} {GCC} --save_epoch_freq 1"
    assert _train(f"{base} --n_epochs 2 --name straight", exp) == 0
    assert _train(f"{base} --n_epochs 1 --name resumed", exp) == 0
    meta = exp / "resumed" / "checkpoints" / "train_state.json"
    assert json.loads(meta.read_text()) == {"epoch": 1}
    assert _train(f"{base} --n_epochs 2 --continue_train --name resumed",
                  exp) == 0
    assert json.loads(meta.read_text()) == {"epoch": 2}
    assert "continuing at epoch 2" in _log(exp, "resumed")
    a = _final_state(exp / "straight" / "checkpoints" / "train_state.ckpt")
    b = _final_state(exp / "resumed" / "checkpoints" / "train_state.ckpt")
    assert a["step"] == b["step"] == 4
    _same(a, b)


def test_sigterm_preempts_then_resumes(tmp_path):
    """A subprocess run gets SIGTERM shortly after its first iteration's
    log line, in an epoch of 30 iterations: it saves the full state
    mid-epoch and exits 0."""
    exp = tmp_path / "exp"
    run = f"{UNET} --n_epochs 1 --max_dataset_size 120 --ntest 4 --name pre"
    args = f"{run} --print_freq 1 --checkpoints_dir {exp}{CPU}".split()
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "gcc_tpu_torch.cli.train", *args], cwd=ROOT,
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    timer = threading.Timer(0.05, proc.send_signal, (signal.SIGTERM,))
    try:
        for line in proc.stderr:
            if "(epoch: 1, iters:" in line and timer.ident is None:
                timer.start()  # once, after the first iteration's line
        assert proc.wait(timeout=120) == 0
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    meta = json.loads((exp / "pre" / "checkpoints" / "train_state.json")
                      .read_text())
    assert meta == {"epoch": 0, "preempted_in_epoch": 1}
    assert "SIGTERM: full train state saved mid-epoch 1" in _log(exp, "pre")
    assert _train(f"{run} --continue_train", exp) == 0
    assert "continuing at epoch 1" in _log(exp, "pre")
    assert "End of epoch 1 / 1" in _log(exp, "pre")


def test_check_numerics_names_the_loss(tmp_path):
    with pytest.raises(FloatingPointError, match="G_L1"):
        _train(f"{UNET} --n_epochs 1 --lambda_L1 inf --check_numerics "
               f"--name nan", tmp_path)
    assert "non-finite loss at epoch 1" in _log(tmp_path, "nan")
    # --debug_nans: autograd's anomaly mode names the backward that made a
    # nan, and is switched off again when the run ends
    with pytest.raises(RuntimeError, match="nan"):
        _train(f"{UNET} --n_epochs 1 --lambda_L1 inf --debug_nans "
               f"--name anomaly", tmp_path)
    assert not torch.is_anomaly_enabled()


def test_initial_teacher_and_distillation_paths(tmp_path):
    """--initial_path loads the student G, --teacher_initial_path the
    teacher G, --distillation_path the frozen teacher's G and D, each from
    a model checkpoint; a net of another shape is refused."""
    exp = tmp_path / "exp"
    for ngf in (4, 8):
        assert _train(f"{UNET} --n_epochs 1 --ngf {ngf} --ndf {ngf} "
                      f"--name n{ngf}", exp) == 0
    small, big = (exp / f"n{n}" / "checkpoints" / "model_1.ckpt"
                  for n in (4, 8))
    assert _train(f"{UNET} --n_epochs 1 {GCC} --initial_path {small} "
                  f"--teacher_initial_path {big} --name online", exp) == 0
    assert _train(f"{UNET} --n_epochs 1 --teacher_ngf 8 --teacher_ndf 8 "
                  f"--normal_distillation --distillation_path {big} "
                  f"--lambda_content 50 --name normal", exp) == 0
    for name, line in (("online", "loaded initial G from"),
                       ("online", "loaded teacher G from"),
                       ("normal", "loaded frozen teacher from")):
        assert line in _log(exp, name)
    with pytest.raises(ValueError, match="does not fit"):
        _train(f"{UNET} --n_epochs 1 --initial_path {big} --name bad", exp)


def test_cli_off_the_main_thread(tmp_path):
    """Embedded use: SIGTERM cannot be caught outside the main thread, so
    the run goes on without the handler."""
    out = {}
    thread = threading.Thread(target=lambda: out.update(rc=_train(
        f"{UNET} --n_epochs 1 --name th", tmp_path)))
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive() and out == {"rc": 0}


def test_refusals(tmp_path):
    base = f"{UNET} --n_epochs 1 --checkpoints_dir {tmp_path}"
    if not torch.cuda.is_available():
        for args in (base, f"{CG} --checkpoints_dir {tmp_path}",
                     f"{SR} --checkpoints_dir {tmp_path}"):
            with pytest.raises(RuntimeError, match="CUDA"):
                ttrain.main(f"{args} --name card".split())
    for flag, match in (("--gpu_ids 0,1", "Queue A item 7"),
                        ("--mesh_shape 2,1", "mesh_shape"),
                        ("--spatial_shards 2", "spatial_shards"),
                        ("--memory_guard strict", "memory_guard"),
                        ("--device_cache on", "device_cache")):
        with pytest.raises(NotImplementedError, match=match):
            ttrain.main(f"{base} {flag} --name r".split())
    packed = tmp_path / "packed"
    packed.mkdir()
    (packed / "gcc_pack.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="packed root"):
        _train(f"{UNET} --dataroot {packed} --dataset_mode aligned "
               f"--n_epochs 1 --name p", tmp_path)


def test_real_fid_through_the_clis(tmp_path):
    """--inception_path naming a file (random InceptionV3 weights through
    the port's ingestion): cli.get_real_stat writes real_stat_B.npz, the
    epoch-end eval and the test CLI log the real ``FID:`` line and no
    [proxy] line, and two test runs of one checkpoint give the same FID."""
    from gcc_tpu.utils import torch_ref_evaluators as tre
    from gcc_tpu_torch.cli import get_real_stat
    from gcc_tpu_torch.metrics.ingest import ingest_evaluator

    tm = tre.TFIDInception()
    tre.randomize(tm, seed=7)
    pth, weights = tmp_path / "pt_inception.pth", tmp_path / "inception.npz"
    torch.save(tm.state_dict(), pth)
    ingest_evaluator("inception", str(pth), str(weights), parity=False,
                     device="cpu")
    root = tmp_path / "synthetic_root"  # holds real_stat_B.npz
    root.mkdir()
    flags = f"{UNET} --dataroot {root} --inception_path {weights}"
    assert get_real_stat.main(f"{flags}{CPU}".split()) == 0
    assert (root / "real_stat_B.npz").exists()
    exp = tmp_path / "exp"
    assert _train(f"{flags} --n_epochs 1 --name w", exp) == 0
    assert re.search(r"FID: [0-9.]+", _log(exp, "w"))
    assert "[proxy]" not in _log(exp, "w")
    best = exp / "w" / "checkpoints" / "model_best_AtoB.ckpt"
    values = []
    for name in ("f1", "f2"):
        assert _test(f"{flags} --pretrain_path {best} --ntest 4 "
                     f"--name {name}", exp) == 0
        assert "[proxy]" not in _log(exp, name)
        assert re.search(r"FID: [0-9.]+", _log(exp, name))
        values.append(_metric(exp, name))
    assert np.isfinite(values[0]) and values[0] == values[1]


def test_plateau_matches_jax():
    from gcc_tpu.utils.schedule import Plateau as JPlateau
    from gcc_tpu_torch.utils.schedule import Plateau
    ours, theirs = Plateau(2e-4), JPlateau(2e-4)
    metrics = [5.0, 4.0, 4.0, 3.99, 4.1, 4.2, 4.3, 4.4, 4.5, 3.0] + [3.0] * 14
    assert [ours.step(m) for m in metrics] == \
        [theirs.step(m) for m in metrics]
    assert ours.lr < 2e-4


def test_arch_lr_step_at_one_epoch():
    """--arch_lr_step with --n_epochs 1 (the scripts' stage 2 cut to one
    epoch): pix2pix's step size n_epochs - 1 is 0. gcc_tpu.cli.train
    divides by it (ROADMAP Queue C); the port keeps the multiplier 1 before
    the first scheduler step, and refuses to step past it."""
    from gcc_tpu.utils.schedule import multiplier_after_steps
    cfg = parse(f"{UNET} --n_epochs 1 --arch_lr_step --arch_lr 3e-4".split())
    with pytest.raises(ZeroDivisionError):  # gcc_tpu/cli/train.py:314-317
        multiplier_after_steps("step", 0, lr_decay_iters=cfg.n_epochs - 1)
    assert ttrain._arch_lr(cfg, 1, None) == 3e-4
    with pytest.raises(ValueError, match="--n_epochs 2 or more"):
        ttrain._arch_lr(cfg.replace(n_epochs_decay=1), 2, None)
    two = cfg.replace(n_epochs=3)
    assert [ttrain._arch_lr(two, e, None) for e in (1, 2, 3)] == \
        [3e-4, 3e-4, pytest.approx(3e-5)]
