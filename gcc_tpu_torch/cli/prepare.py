"""Offline dataset packer of the port: decode once, stream forever
(gcc_tpu/cli/prepare.py).

    python -m gcc_tpu_torch.cli.prepare --dataroot database/cityscapes \\
        --dataset_mode aligned --phase train [--load_size 256] \\
        [--pack_output database/cityscapes_packed]

Runs the deterministic transform prefix (decode + resize / center-crop)
over every image of --dataroot/--phase once and writes a packed root of
mmap-able uint8 blobs (gcc_tpu_torch/data/packed.py), byte for byte the
root that ``python -m gcc_tpu.cli.prepare`` writes. Point --dataroot of
cli.train / cli.test at the packed root afterwards: it is detected and
streams batches with no image decode.

Pack each phase you need (train / val / test / Set5 ...) into the same
output directory; the metadata merges. The per-model presets apply as in
cli.train, so the packed load_size/preprocess match what training uses.
"""

from __future__ import annotations


def main(argv=None) -> int:
    from gcc_tpu_torch import config as config_mod
    from gcc_tpu_torch.data.packed import pack_dataset

    cfg = config_mod.parse(argv)
    out = pack_dataset(cfg, out_dir=cfg.pack_output or None,
                       num_threads=cfg.num_threads)
    print(f"packed root ready: {out}\n"
          f"use it with: python -m gcc_tpu_torch.cli.train --dataroot {out} "
          f"...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
