"""Flags and helpers of the port's CLI tests (tests/test_torch_cli_*.py):
the tiny configurations of each family, in-process runs of
``gcc_tpu_torch.cli.{train,test}`` on the CPU (``--gpu_ids -1``), and the
log and metric readers.
"""

import ast
import re
from pathlib import Path

import numpy as np

from gcc_tpu_torch.cli import test as ttest
from gcc_tpu_torch.cli import train as ttrain
from gcc_tpu_torch.utils import checkpoint as ckpt


ROOT = Path(__file__).resolve().parents[1]

UNET = ("--dataroot synthetic --dataset_mode synthetic --model pix2pix "
        "--ngf 4 --ndf 4 --num_downs 5 --crop_size 32 --load_size 32 "
        "--batch_size 4 --max_dataset_size 8 --num_threads 2 "
        "--n_epochs_decay 0 --save_epoch_freq 1 --print_freq 4")

GCC = ("--teacher_ngf 8 --teacher_ndf 8 --online_distillation "
       "--darts_discriminator --arch_lr_step --lambda_content 50 "
       "--lambda_gram 1e4")

CPU = " --gpu_ids -1"


def _train(args: str, exp) -> int:
    return ttrain.main(f"{args} --checkpoints_dir {exp}{CPU}".split())


def _test(args: str, exp) -> int:
    return ttest.main(f"{args} --checkpoints_dir {exp}{CPU}".split())


def _log(exp, name) -> str:
    return (Path(exp) / name / "logger.log").read_text()


def _metric(exp, name):
    """The test CLI's last metric: a number, or a dict of named ones."""
    return ast.literal_eval(re.findall(r"metrics: (.+)", _log(exp, name))[-1])


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


def _spread_tree(tree, rng):
    if isinstance(tree, dict):
        return {k: _spread_tree(tree[k], rng) for k in sorted(tree)}
    return (np.asarray(rng.rand(*tree.shape), np.float32)
            * np.exp(rng.uniform(-6, 2, tree.shape[-1:])).astype(np.float32))


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
