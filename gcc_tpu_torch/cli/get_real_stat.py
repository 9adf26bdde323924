"""Real-image InceptionV3 statistics for FID (port of
gcc_tpu/cli/get_real_stat.py; the reference's metric/get_real_stat.py:13-89).

    python -m gcc_tpu_torch.cli.get_real_stat --dataroot ... \
        --inception_path inception.npz [--gpu_ids -1]

Runs the dataset's real side (serial, unflipped) through the FID
InceptionV3 on the card (the CPU with ``--gpu_ids -1``) and saves mu and
sigma to <dataroot>/real_stat_<side>.npz, side B for AtoB and A for BtoA.
"""

from __future__ import annotations

import os

import numpy as np


def main(argv=None) -> int:
    from gcc_tpu_torch import config as config_mod
    from gcc_tpu_torch.cli.train import run_device
    from gcc_tpu_torch.data import create_dataset
    from gcc_tpu_torch.metrics.fid import activation_statistics
    from gcc_tpu_torch.metrics.inception import InceptionExtractor

    cfg = config_mod.parse(argv)
    if not cfg.inception_path or not os.path.exists(cfg.inception_path):
        raise FileNotFoundError(
            "--inception_path must point to the FID InceptionV3 weights (the "
            "TF-FID .pth, or the .npz that python -m gcc_tpu_torch.cli."
            "convert --evaluator inception writes)")
    dev = run_device(cfg)
    extractor = InceptionExtractor.get(cfg.inception_path, dev)

    loader = create_dataset(cfg.replace(serial_batches=True, no_flip=True),
                            seed=0)
    side = "B" if cfg.direction == "AtoB" else "A"
    key = {"aligned": side, "unaligned": side,
           "sa": "real_img", "sr": "hr",
           "synthetic": "B"}[cfg.dataset_mode]
    acts = np.concatenate([extractor.activations(np.asarray(batch[key]))
                           for batch in loader])
    mu, sigma = activation_statistics(acts)
    out = os.path.join(cfg.dataroot, f"real_stat_{side}.npz")
    np.savez(out, mu=mu, sigma=sigma)
    print(f"saved {out} ({len(acts)} images)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
