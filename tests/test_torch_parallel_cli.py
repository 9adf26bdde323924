"""The port's data-parallel training through its CLI on the CPU:
cli.train --gpu_ids -1 --mesh_shape 2 (two Gloo ranks).

* One epoch, one checkpoint from rank 0 that loads into the 1-process
  engine, a resume; a request that does not divide the batch is reduced
  and logged.
* A rank that raises, or hangs, fails the run within its timeout.
* SIGTERM stops both ranks at one iteration, rank 0 saves, and the run
  resumes on two ranks.
* --spatial_shards on two ranks shards the epoch-end eval.
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parallel_workers as W  # noqa: E402

from gcc_tpu_torch.cli import train as ttrain  # noqa: E402
from gcc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from torch_limits import (  # noqa: E402,F401
    child_env, one_thread, spawn_within, watched,
)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 180.0  # seconds a case's ranks and commands may take in all


@pytest.fixture(autouse=True)
def _ranks_limit(request):
    """The ranks that a case spawns killed after LIMIT, and the case failed
    by name."""
    with spawn_within(LIMIT, request.node.nodeid):
        yield


def _leaves(tree, prefix=""):
    if not isinstance(tree, dict):
        yield prefix.rstrip("/"), np.asarray(tree)
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], f"{prefix}{k}/")


CLI = ("--dataroot synthetic --dataset_mode synthetic --model pix2pix "
       "--ngf 4 --ndf 4 --teacher_ngf 4 --teacher_ndf 4 --num_downs 5 "
       "--crop_size 32 --load_size 32 --max_dataset_size 8 --batch_size 4 "
       "--n_epochs_decay 0 --compute_dtype float32 --num_threads 1 "
       "--online_distillation --darts_discriminator --gpu_ids -1")


def _log(exp, name):
    with open(os.path.join(exp, name, "logger.log")) as f:
        return f.read()


def test_cli_mesh_trains_checkpoints_and_resumes(tmp_path):
    from gcc_tpu_torch.config import parse
    from gcc_tpu_torch.utils.checkpoint import load_checkpoint, load_state
    from gcc_tpu_torch.utils.weights import load_jax_variables
    exp = str(tmp_path)
    base = f"{CLI} --checkpoints_dir {exp} --name dp"
    assert ttrain.main(f"{base} --n_epochs 1 --mesh_shape 2".split()) == 0
    log = _log(exp, "dp")
    assert "mesh: 2 data-parallel ranks on the CPU (Gloo)" in log
    assert log.count("device: cpu") == 1  # rank 0 alone logs
    ckpts = sorted(os.listdir(os.path.join(exp, "dp", "checkpoints")))
    assert ckpts == ["model_1.ckpt", "model_best_AtoB.ckpt",
                     "train_state.ckpt", "train_state.json"]
    # rank 0's checkpoint loads into the 1-process engine
    cfg = parse(base.split())
    eng = ttrain.build_engine(cfg, device="cpu")
    state = eng.init_state(seed=1)
    ck = load_checkpoint(os.path.join(exp, "dp", "checkpoints",
                                      "model_1.ckpt"))
    eng.load_net_params(state, ck)
    load_state(os.path.join(exp, "dp", "checkpoints", "train_state.ckpt"),
               state)
    for key in ("g", "d"):
        got = dict(_leaves(W.to_jax_nets(state)[key]))
        for path, a in _leaves(ck["G" if key == "g" else "D"]):
            np.testing.assert_array_equal(got[path], a)
    assert state.step == 2
    # resume on two ranks: epoch 2 from the saved state
    assert ttrain.main(f"{base} --n_epochs 2 --mesh_shape 2 "
                       f"--continue_train".split()) == 0
    assert "continuing at epoch 2" in _log(exp, "dp")
    load_state(os.path.join(exp, "dp", "checkpoints", "train_state.ckpt"),
               state)
    assert state.step == 4
    # a request that does not divide the batch: the largest count that does
    assert ttrain.main(f"{CLI} --checkpoints_dir {exp} --name three "
                       f"--n_epochs 1 --mesh_shape 3".split()) == 0
    assert ("mesh: 2 data-parallel ranks on the CPU (Gloo) (requested 3; "
            "the largest count that divides --batch_size 4)") \
        in _log(exp, "three")


def test_cli_refusals(tmp_path):
    from gcc_tpu_torch.cli import test as ttest
    from gcc_tpu_torch.config import parse
    # --spatial_shards on 2 ranks: every rank runs the epoch-end eval's
    # generator passes over its rows, rank 0 scores them; the metric is the
    # unsharded eval's of the same final weights
    exp = str(tmp_path)
    assert ttrain.main(f"{CLI} --mesh_shape 2 --spatial_shards 2 --n_epochs 1 "
                       f"--name sp --checkpoints_dir {exp}".split()) == 0
    assert ttest.main(f"{CLI} --name sp_test --checkpoints_dir {exp} "
                      f"--pretrain_path {exp}/sp/checkpoints/model_1.ckpt"
                      .split()) == 0
    fid = [ln.split("pixel-FID (no inception weights): ")[1]
           for ln in _log(exp, "sp").splitlines() if "pixel-FID" in ln]
    assert len(fid) == 1 and fid[0] in _log(exp, "sp_test")
    # a mesh of two axes: the product of its axes as data-parallel ranks
    assert ttrain.mesh_plan(parse(f"{CLI} --mesh_shape 2,2".split())) \
        == ("cpu", [None] * 4)
    if torch.cuda.device_count() < 8:
        with pytest.raises(NotImplementedError, match="needs them"):
            ttrain.main(f"{CLI} --gpu_ids 0,1,2,3,4,5,6,7".split())


@pytest.mark.parametrize("fault", ["raises", "hangs"])
def test_cli_rank_failure_fails_the_run(fault, tmp_path):
    """Rank 1 raises in its second iteration, or stops answering: the run
    fails within the ranks' timeout (5 s here), the other rank brought
    down."""
    from gcc_tpu_torch.config import parse
    cfg = parse(f"{CLI} --checkpoints_dir {tmp_path} --name f "
                f"--n_epochs 1".split())
    t0 = time.time()
    with pytest.raises(Exception, match="rank 1|Gloo|timed out|Timeout|"
                       "terminated|exit"):
        pmesh.spawn(W.rank_cli_fault, 2, args=(cfg, fault), threads=1,
                    timeout=5.0)
    assert time.time() - t0 < 60


def test_cli_mesh_sigterm_preempts_then_resumes(tmp_path):
    """SIGTERM to the command after its first iteration's log line: both
    ranks stop at the same iteration, rank 0 saves the state mid-epoch, the
    command exits 0, and --continue_train on two ranks restarts the epoch."""
    import json
    import signal
    import subprocess
    import sys
    import threading
    exp = tmp_path / "exp"
    run = (f"{CLI} --mesh_shape 2 --n_epochs 1 --max_dataset_size 120 "
           f"--ntest 4 --name pre --checkpoints_dir {exp}")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gcc_tpu_torch.cli.train", *run.split(),
         "--print_freq", "1"], cwd=ROOT, env=child_env(PYTHONPATH=ROOT),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    timer = threading.Timer(0.05, proc.send_signal, (signal.SIGTERM,))
    with watched(proc, LIMIT, "test_cli_mesh_sigterm_preempts_then_resumes"):
        try:
            for line in proc.stderr:
                if "(epoch: 1, iters:" in line and timer.ident is None:
                    timer.start()
            assert proc.wait(timeout=120) == 0
        finally:
            timer.cancel()
    meta = json.loads((exp / "pre" / "checkpoints" / "train_state.json")
                      .read_text())
    assert meta == {"epoch": 0, "preempted_in_epoch": 1}
    assert "SIGTERM: full train state saved mid-epoch 1" in _log(exp, "pre")
    assert ttrain.main(f"{run} --continue_train".split()) == 0
    assert "continuing at epoch 1" in _log(exp, "pre")
