"""Serving-export entry point of the port (gcc_tpu/cli/export.py).

Loads a checkpoint (either package's: the nets are flax's bytes in the JAX
layout), rebuilds the pruned generator from the ``cfg`` stored in it (the
pruned topology is data, the reference's test.py:140-141) and writes it as
a self-contained ``torch.export`` program (utils/serve_export.py): weights
inside, symbolic batch, no CUDA kernel of the port. The artifact runs
without gcc_tpu_torch, gcc_tpu or the checkpoint:

    import torch
    g = torch.export.load(p).module()
    fake = g(x)            # any batch size, NCHW, in --serve_dtype

Usage (the model and size flags of cli.test, plus the export's own):
  python -m gcc_tpu_torch.cli.export --model pix2pix --dataroot unused \\
      --pretrain_path experiments/run/checkpoints/model_best.ckpt \\
      --name run [--serve_dtype bfloat16] [--quantize int8] \\
      [--static_batch 8] [--platforms cpu,cuda] [--output_dir DIR]

The export traces on the run's device, chosen as in ``cli.train``
(``--gpu_ids -1`` is the CPU, the default the card). Every platform in
``--platforms`` must be present: the saved artifact is loaded on each and
called on the example input.
"""

from __future__ import annotations

import argparse
import os

PLATFORMS = ("cpu", "cuda")


def parse_platforms(text: str):
    """The comma-separated platforms, each ``cpu`` or ``cuda``."""
    platforms = tuple(p.strip() for p in text.split(",") if p.strip())
    for p in platforms:
        if p == "tpu":
            raise ValueError("--platforms tpu: the port's artifacts run on "
                             "cpu and cuda; ask for cuda to serve on the card")
        if p not in PLATFORMS:
            raise ValueError(f"--platforms {p}: expected a list of "
                             f"{' and '.join(PLATFORMS)}")
    if not platforms:
        raise ValueError("--platforms: no platform given")
    return platforms


def main(argv=None) -> int:
    ep = argparse.ArgumentParser(add_help=False)
    ep.add_argument("--output_dir", default=None,
                    help="artifact dir (default <run_dir>/serving)")
    ep.add_argument("--platforms", default="cpu,cuda",
                    help="comma-separated platforms the artifact must run "
                         "on (cpu, cuda); each is checked after saving")
    ep.add_argument("--static_batch", type=int, default=0,
                    help="fix the batch dim (default 0 = symbolic batch)")
    ep.add_argument("--serve_dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="weights+input dtype of the artifact")
    ep.add_argument("--quantize", default="none", choices=("none", "int8"),
                    help="int8: per-output-channel weight-only quantization"
                         " - int8 weights + fp32 scales in the artifact,"
                         " dequantized to serve_dtype inside the program")
    ea, rest = ep.parse_known_args(argv)

    import torch

    from gcc_tpu_torch import config as config_mod
    from gcc_tpu_torch.cli.test import rebuild_engine
    from gcc_tpu_torch.cli.train import run_device
    from gcc_tpu_torch.device import resolve_device
    from gcc_tpu_torch.utils import serve_export as sx
    from gcc_tpu_torch.utils.checkpoint import load_checkpoint
    from gcc_tpu_torch.utils.logging import get_logger

    cfg = config_mod.parse(rest).replace(isTrain=False)
    platforms = parse_platforms(ea.platforms)
    dev = run_device(cfg)
    devices = [resolve_device(p) for p in platforms]  # raises if absent
    run_dir = os.path.join(cfg.checkpoints_dir, cfg.name)
    os.makedirs(run_dir, exist_ok=True)
    logger = get_logger(os.path.join(run_dir, "logger.log"))

    if not cfg.pretrain_path or not os.path.exists(cfg.pretrain_path):
        raise FileNotFoundError("pretrain model path must exist")
    ckpt = load_checkpoint(cfg.pretrain_path)
    engine = rebuild_engine(cfg, ckpt, device=dev)
    state = engine.init_state(seed=cfg.seed)
    engine.load_net_params(state, ckpt, load_discriminator=False)

    out_dir = ea.output_dir or os.path.join(run_dir, "serving")
    os.makedirs(out_dir, exist_ok=True)
    dtype = torch.bfloat16 if ea.serve_dtype == "bfloat16" else torch.float32
    shape = sx.example_input_shape(cfg)
    if ea.static_batch > 0:
        shape = (ea.static_batch,) + shape[1:]
    example = torch.randn(shape, generator=torch.Generator().manual_seed(
        cfg.seed)).to(dtype)

    directions = ("AtoB", "BtoA") if "cyclegan" in cfg.model else (None,)
    written = []
    for d in directions:
        prog = sx.export_generator(
            engine, state, shape, direction=d or "AtoB",
            poly_batch=ea.static_batch <= 0, dtype=dtype,
            weight_quant=None if ea.quantize == "none" else ea.quantize)
        tag = f"_{d}" if d else ""
        if ea.quantize != "none":
            tag += f"_{ea.quantize}"
        path = os.path.join(out_dir, f"{cfg.model}_G{tag}.pt2")
        size = sx.save_exported(prog, path)
        for device in devices:
            with torch.no_grad():
                out = sx.load_exported(path, device)(example.to(device))
            if out.shape[0] != shape[0] or not bool(torch.isfinite(out).all()):
                raise RuntimeError(f"{path} on {device}: output of shape "
                                   f"{tuple(out.shape)} or not finite")
        logger.info(f"exported {path} ({size/1e6:.2f} MB, "
                    f"quantize={ea.quantize}, "
                    f"platforms={platforms}, dtype={ea.serve_dtype}, "
                    f"batch={'symbolic' if ea.static_batch <= 0 else ea.static_batch}, "
                    f"input={tuple(shape[1:])})")
        written.append(path)
    print("\n".join(written))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
