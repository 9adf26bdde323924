"""The port's entry points, ``python -m gcc_tpu_torch.cli.{train,test}``, on
the CPU (``--gpu_ids -1``) with the U-Net, against the JAX package's.

* The three-stage pix2pix workflow (sparsity pretrain -> prune to a budget
  + GCC train -> test from the checkpoint's cfg): the files and log lines
  of tests/test_data_cli.py's round trips.
* A checkpoint trained by the port and one written by the JAX engine, each
  evaluated by ``gcc_tpu.cli.test`` (fp32 convolutions) and by the port's:
  the same proxy metric within 1e-4 relative.
* Resume: 2 epochs straight equal 1 epoch + ``--continue_train`` for the
  second, bit for bit (parameters, Adam moments, EMA, step, dropout rng).
* SIGTERM after the first iteration's log line: exit 0 with
  ``preempted_in_epoch`` in the meta, then ``--continue_train`` restarts it.
* ``--check_numerics`` names a non-finite loss; ``--initial_path``,
  ``--teacher_initial_path`` and ``--distillation_path`` load their nets;
  the CLI runs off the main thread.
"""

import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gcc_tpu.cli import test as jtest  # noqa: E402
from gcc_tpu.config import parse as jparse  # noqa: E402
from gcc_tpu.utils import checkpoint as jckpt  # noqa: E402
from gcc_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from torch_limits import child_env, one_thread, watched  # noqa: E402,F401
from torch_cli_common import (  # noqa: E402
    CPU,
    GCC,
    ROOT,
    UNET,
    _final_state,
    _log,
    _metric,
    _same,
    _test,
    _train,
)


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
                  f"{s1 / 'model_best_AtoB.ckpt'} --name s2 "
                  f"--profile_steps 1", exp) == 0
    # the operator's trace of a GCC iteration holds the engine's spans
    trace = (exp / "s2" / "profile" / "trace.json").read_text()
    for span in ("gcc.step", "gcc.teacher_d", "gcc.teacher_g",
                 "gcc.student_d", "gcc.student_g", "gcc.arch", "gcc.adam"):
        assert f'"name": "{span}"' in trace, span
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
    proc = subprocess.Popen(
        [sys.executable, "-m", "gcc_tpu_torch.cli.train", *args], cwd=ROOT,
        env=child_env(PYTHONPATH=str(ROOT)), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    timer = threading.Timer(0.05, proc.send_signal, (signal.SIGTERM,))
    with watched(proc, 120, "test_sigterm_preempts_then_resumes"):
        try:
            for line in proc.stderr:
                if "(epoch: 1, iters:" in line and timer.ident is None:
                    timer.start()  # once, after the first iteration's line
            assert proc.wait(timeout=120) == 0
        finally:
            timer.cancel()
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
