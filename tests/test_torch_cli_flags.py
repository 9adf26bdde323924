"""Flags of the port's ``gcc_tpu_torch.cli.train`` on the CPU
(``--gpu_ids -1``), against the JAX package's.

* Prune-on-startup from a stage-1 checkpoint written by gcc_tpu gives
  ``gcc_tpu.cli.train.build_engine``'s cfgs (U-Net, resnet, SAGAN, SRGAN).
* Without ``--gpu_ids -1`` the CLIs need a card; meshes and spatial shards
  degrade or raise as planned; ``--memory_guard strict`` is skipped on the
  CPU; ``--device_cache on`` raises on a packed store it cannot cache, and
  a packed root without the phase raises.
* The plateau schedule and ``--arch_lr_step`` at one epoch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gcc_tpu.cli.train import build_engine as jbuild_engine  # noqa: E402
from gcc_tpu.config import parse as jparse  # noqa: E402
from gcc_tpu.utils import checkpoint as jckpt  # noqa: E402
from gcc_tpu_torch.cli import train as ttrain  # noqa: E402
from gcc_tpu_torch.config import parse  # noqa: E402
from gcc_tpu_torch.utils.weights import export_jax_variables  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401
from torch_cli_common import (  # noqa: E402
    CG,
    CPU,
    SR,
    UNET,
    _log,
    _spread_tree,
    _train,
)


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


def test_refusals(tmp_path):
    base = f"{UNET} --n_epochs 1 --checkpoints_dir {tmp_path}"
    if not torch.cuda.is_available():
        for args in (base, f"{CG} --checkpoints_dir {tmp_path}",
                     f"{SR} --checkpoints_dir {tmp_path}"):
            with pytest.raises(RuntimeError, match="CUDA"):
                ttrain.main(f"{args} --name card".split())
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        ttrain.main(f"{base} --gpu_ids 0,1 --name r".split())
    # a mesh of two axes asks for the product of its axes as ranks, as the
    # JAX package's training mesh does
    assert ttrain.mesh_plan(parse(f"{base}{CPU} --mesh_shape 2,1".split())) \
        == ("cpu", [None, None])
    # --spatial_shards shards the epoch-end eval's rows; in one process it
    # degrades to 1 shard, with the JAX package's warning
    assert _train(f"{UNET} --n_epochs 1 --spatial_shards 2 --name sp",
                  tmp_path) == 0
    assert ("spatial_apply: 2 shards requested but only 1 ranks; degrading "
            "to 1") in _log(tmp_path, "sp")
    # --memory_guard strict runs: measured on a card, skipped on the CPU
    assert _train(f"{UNET} --n_epochs 1 --memory_guard strict --name g",
                  tmp_path) == 0
    assert ("memory guard: no device memory statistics on the CPU; "
            "skipped") in _log(tmp_path, "g")
    # --device_cache on raises on a packed store it cannot cache (items of
    # two shapes)
    from PIL import Image

    from gcc_tpu_torch.config import Config
    from gcc_tpu_torch.data.packed import pack_dataset
    src = tmp_path / "src" / "train"
    src.mkdir(parents=True)
    for i, (w, h) in enumerate([(64, 40), (64, 48)]):
        Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(
            src / f"{i}.png")
    flags = ("--dataset_mode aligned --preprocess scale_width_and_crop "
             "--n_epochs 1 --device_cache on")
    root = pack_dataset(Config(dataroot=str(tmp_path / "src"),
                               dataset_mode="aligned", load_size=32,
                               crop_size=32,
                               preprocess="scale_width_and_crop"),
                        num_threads=1)
    with pytest.raises(ValueError, match="not device-cacheable"):
        _train(f"{UNET} --dataroot {root} {flags} --name c", tmp_path)
    # a packed root whose metadata holds no phase
    packed = tmp_path / "packed"
    packed.mkdir()
    (packed / "gcc_pack.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="has no phase"):
        _train(f"{UNET} --dataroot {packed} --dataset_mode aligned "
               f"--n_epochs 1 --name p", tmp_path)


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
