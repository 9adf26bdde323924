"""The port's three-stage pix2pix workflow through ``gcc_tpu_torch.cli.{train,
test}`` on the CPU (``--gpu_ids -1``) with the resnet backbone and its
fused blocks.
"""

import os
import pytest

torch = pytest.importorskip("torch")

from torch_limits import one_thread  # noqa: E402,F401
from torch_cli_common import GCC, UNET, _log, _test, _train  # noqa: E402


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
