"""The port's SAGAN train -> test through ``gcc_tpu_torch.cli.{train,test}``
on the CPU (``--gpu_ids -1``).
"""

import os
import pytest

torch = pytest.importorskip("torch")

from torch_limits import one_thread  # noqa: E402,F401
from torch_cli_common import _log, _test, _train  # noqa: E402


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
