"""``--inception_path`` naming a file, through the port's CLIs on the CPU
(``--gpu_ids -1``): cli.get_real_stat, then the real FID branch at the
epoch end and in the test CLI, the same value twice.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_limits import one_thread  # noqa: E402,F401
from torch_cli_common import (  # noqa: E402
    CPU,
    UNET,
    _log,
    _metric,
    _test,
    _train,
)


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
