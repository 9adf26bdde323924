"""CycleGAN through the port's ``gcc_tpu_torch.cli.{train,test}`` on the CPU
(``--gpu_ids -1``), against the JAX package's.

* The three stages (per-direction budgets and best checkpoints);
  gcc_tpu.cli.test reads the port's checkpoint and gives the same
  pixel-FID per direction within 1e-4 relative.
* Prune-on-startup from a stage-1 checkpoint written by gcc_tpu gives
  ``gcc_tpu.cli.train.build_engine``'s two directions' cfgs (synthetic and
  horse2zebra's reference cfgs).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gcc_tpu.cli import test as jtest  # noqa: E402
from gcc_tpu.cli.train import build_engine as jbuild_engine  # noqa: E402
from gcc_tpu.config import parse as jparse  # noqa: E402
from gcc_tpu.utils import checkpoint as jckpt  # noqa: E402
from gcc_tpu_torch.cli import train as ttrain  # noqa: E402
from gcc_tpu_torch.config import parse  # noqa: E402
from gcc_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from gcc_tpu_torch.utils.weights import export_jax_variables  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401
from torch_cli_common import (  # noqa: E402
    CG,
    _close,
    _log,
    _metric,
    _spread_tree,
    _test,
    _train,
)


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
