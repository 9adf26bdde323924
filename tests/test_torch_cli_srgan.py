"""SRGAN's three stages through the port's ``gcc_tpu_torch.cli.{train,test}``
on the CPU (``--gpu_ids -1``): --generator_only pretraining, a teacher from
--teacher_initial_path, PSNR/SSIM per set; gcc_tpu.cli.test reads the
port's checkpoint and gives the same PSNR and SSIM within 1e-4 relative.
"""

import os
import pytest

torch = pytest.importorskip("torch")

from gcc_tpu.cli import test as jtest  # noqa: E402
from gcc_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401
from torch_cli_common import (  # noqa: E402
    SR,
    _close,
    _log,
    _metric,
    _test,
    _train,
)


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
