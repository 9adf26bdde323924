"""The port's training and test CLIs on packed roots, on the CPU
(``--gpu_ids -1``).

Two iterations of ``python -m gcc_tpu_torch.cli.train`` from a root packed
by ``python -m gcc_tpu_torch.cli.prepare`` give the losses of the image
folder it was packed from within 1e-5, streaming (uint8 batches normalized
by set_input) and with ``--device_cache on`` (the device store and
FusedCachedStep): the U-Net in both directions (BtoA swaps the cached
batches) and SAGAN (z drawn by the packed store). The test CLI reads the
packed root and reports the folder's metric. One loader thread: the
crop draws of items decoded on two threads come in either order.
"""

import json
import os
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from gcc_tpu_torch.cli import prepare  # noqa: E402
from gcc_tpu_torch.cli import test as ttest  # noqa: E402
from gcc_tpu_torch.cli import train as ttrain  # noqa: E402
from torch_data_roots import _imgs  # noqa: E402
from torch_limits import one_thread  # noqa: E402,F401

UNET = ("--model pix2pix --dataset_mode aligned --ngf 4 --ndf 4 "
        "--num_downs 5 --crop_size 32 --load_size 36 --batch_size 4 "
        "--num_threads 1 --n_epochs 1 --n_epochs_decay 0 --save_epoch_freq 1 "
        "--print_freq 4 --teacher_ngf 8 --teacher_ndf 8 --online_distillation "
        "--darts_discriminator --lambda_content 50 --lambda_gram 1e4 "
        # fp32: on the CPU the device cache serves float32 whatever
        # --compute_dtype says (gcc_tpu/data/__init__.py:93-95), so only fp32
        # runs of the three sources can be equal
        "--compute_dtype float32")
SAGAN = ("--model sagan --dataset_mode sa --ngf 4 --ndf 4 --z_dim 16 "
         "--batch_size 4 --num_threads 1 --n_epochs 1 --print_freq 4 "
         "--save_epoch_freq 1 --teacher_ngf 8 --teacher_ndf 8 "
         "--online_distillation --darts_discriminator --lambda_content 1 "
         # fp32, as UNET above: SAGAN computes in bf16 by default
         "--lambda_gram 1 --compute_dtype float32")
CPU = " --gpu_ids -1"


def _roots(tmp_path, flags, sagan):
    """An image root (train 8, val 4) and its packed root: train at the
    run's flags, val at the eval's load size (256; SAGAN's crop)."""
    src = tmp_path / "src"
    w, h = (180, 170) if sagan else (72, 36)
    _imgs(str(src / "train"), 8, w, h, 0)
    _imgs(str(src / "val"), 4, w, h, 1)
    out = str(tmp_path / "src_packed")
    for phase, extra in (("train", ""), ("val", " --load_size 256")):
        assert prepare.main(f"{flags} --dataroot {src} --phase {phase}"
                            f"{extra}".split()) == 0
    return str(src), out


def _losses(exp, name):
    with open(Path(exp) / name / "metrics.jsonl") as f:
        rows = [json.loads(x) for x in f if x.strip()]
    return [{k: v for k, v in r.items() if k not in ("epoch", "iters", "lr")}
            for r in rows]


@pytest.mark.parametrize("flags,sagan", [
    (UNET, False), (UNET + " --direction BtoA", False), (SAGAN, True)],
    ids=["unet", "unet-BtoA", "sagan"])
def test_packed_runs_equal_the_folder_run(tmp_path, flags, sagan):
    src, out = _roots(tmp_path, flags, sagan)
    exp = tmp_path / "exp"
    runs = {"folder": f"--dataroot {src}",
            "stream": f"--dataroot {out} --device_cache off",
            "cache": f"--dataroot {out} --device_cache on"}
    for name, root in runs.items():
        assert ttrain.main(f"{flags} {root} --name {name} --checkpoints_dir "
                           f"{exp}{CPU}".split()) == 0
    want = _losses(exp, "folder")
    assert len(want) == 2
    for name in ("stream", "cache"):
        got = _losses(exp, name)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert abs(g[k] - w[k]) <= 1e-5 * max(1.0, abs(w[k])), (
                    name, k, g[k], w[k])
    logs = {n: (exp / n / "logger.log").read_text() for n in runs}
    assert "device_cache: batches materialize" in logs["cache"]
    assert "device_cache" not in logs["stream"]
    assert all("data: waited" in x for x in logs.values())
    if sagan:
        return
    # the test CLI on the packed root reports the folder's metric
    ckpt = exp / "cache" / "checkpoints" / "model_1.ckpt"
    metrics = []
    for name, root in (("t_folder", src), ("t_packed", out)):
        assert ttest.main(f"{flags} --dataroot {root} --pretrain_path {ckpt} "
                          f"--name {name} --checkpoints_dir {exp}{CPU}"
                          .split()) == 0
        text = (exp / name / "logger.log").read_text()
        metrics.append(float(re.findall(r"metrics: ([-0-9.e]+)", text)[-1]))
        assert os.listdir(exp / name / "test_results")
    assert abs(metrics[0] - metrics[1]) <= 1e-5 * max(1.0, abs(metrics[0]))


SRGAN = ("--model srgan --dataset_mode sr --ngf 8 --ndf 8 --image_size 32 "
         "--batch_size 2 --num_threads 1 --n_epochs 1 --n_epochs_decay 0 "
         "--save_epoch_freq 1 --print_freq 2")


def test_srgan_reads_its_test_sets_from_the_packed_root(tmp_path):
    """SRGAN from a root packed with its train phase and a Set5 phase: the
    folder's losses (--device_cache auto streams sr on the CPU), and the
    epoch-end eval finds Set5 among the packed phases, as on the folder."""
    src = tmp_path / "src"
    _imgs(str(src / "train"), 4, 48, 40, 0)
    _imgs(str(src / "Set5"), 2, 37, 29, 1)
    out = str(tmp_path / "src_packed")
    for phase in ("train", "Set5"):
        assert prepare.main(f"{SRGAN} --dataroot {src} --phase {phase}"
                            .split()) == 0
    exp = tmp_path / "exp"
    for name, root in (("folder", src), ("packed", out)):
        assert ttrain.main(f"{SRGAN} --dataroot {root} --name {name} "
                           f"--checkpoints_dir {exp}{CPU}".split()) == 0
    want, got = _losses(exp, "folder"), _losses(exp, "packed")
    assert len(want) == len(got) == 2
    for g, w in zip(got, want):
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-5 * max(1.0, abs(w[k])), k
    for name in ("folder", "packed"):
        log = (exp / name / "logger.log").read_text()
        assert re.search(r"Set5: PSNR: [0-9.]+ \| SSIM", log), name
        assert "val: PSNR" not in log
