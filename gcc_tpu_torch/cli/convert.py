"""Convert checkpoints between the reference (torch) and the port (port of
gcc_tpu/cli/convert.py).

Forward (default): brings trained reference models across — generators and
discriminators port layer-for-layer (``utils/torch_port``) into the port's
checkpoint, flax's bytes with JAX-layout nets (``utils/checkpoint``); the
``cfg`` pruned-architecture tuple is carried over so the rebuilt topology
matches.

Reverse (--reverse): exports a checkpoint of either package back to the
reference's .pth container (``utils/torch_export``).

Evaluator ingestion (--evaluator): validates a user-supplied pretrained
evaluator .pth (TF-FID InceptionV3, DRN-D-105, torchvision VGG19), checks
the loaded network on the card against float64 on the CPU, and writes the
.npz for --inception_path/--drn_path/--vgg_path (``metrics/ingest``). It
runs on the card unless ``--gpu_ids -1`` asks for the CPU.

Usage:
  python -m gcc_tpu_torch.cli.convert --model pix2pix \\
      --pretrain_path /path/model_best_BtoA.pth --output converted.ckpt
  python -m gcc_tpu_torch.cli.convert --model pix2pix --reverse \\
      --pretrain_path experiments/run/checkpoints/model_best_BtoA.ckpt \\
      --output model_best_BtoA.pth
  python -m gcc_tpu_torch.cli.convert --evaluator inception \\
      --pretrain_path pt_inception-2015-12-05-6726825d.pth \\
      --output inception.npz
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

# the numpy scalar types a reference checkpoint's metric can be saved as
# (its 'fid' is the float64 that metric/fid_score.py returns)
_NP_CORE = np._core if hasattr(np, "_core") else np.core  # numpy 2 / 1
_NUMPY_SCALARS = [_NP_CORE.multiarray.scalar, np.dtype,
                  np.dtypes.Float64DType, np.dtypes.Float32DType]


def load_reference(path: str) -> dict:
    """A reference checkpoint, read with ``weights_only=True`` (tensors,
    containers, numbers and numpy scalars only)."""
    with torch.serialization.safe_globals(_NUMPY_SCALARS):
        return torch.load(path, map_location="cpu", weights_only=True)


def convert(model: str, in_path: str, out_path: str,
            num_downs: int = 8, n_blocks: int = 9) -> dict:
    from gcc_tpu_torch.utils import torch_port as tp
    from gcc_tpu_torch.utils.checkpoint import save_checkpoint

    ckpt = load_reference(in_path)
    out = {"epoch": ckpt.get("epoch"), "cfg": ckpt.get("cfg", (None, None)),
           "fid": ckpt.get("fid", ckpt.get("psnr"))}
    if "pix2pix" in model:
        params, stats = tp.port_unet_generator(ckpt["G"], num_downs)
        out["G"] = {"params": params, "batch_stats": stats}
        if "D" in ckpt:
            masked = any("alpha" in k for k in ckpt["D"])
            p, s, arch = tp.port_patchgan(ckpt["D"], masked=masked)
            out["D"] = {"params": p, "batch_stats": s}
            if arch:
                out["D"]["arch"] = arch
    elif "cyclegan" in model:
        out["G_A"] = {"params": tp.port_mobile_resnet(ckpt["G_A"], n_blocks)}
        out["G_B"] = {"params": tp.port_mobile_resnet(ckpt["G_B"], n_blocks)}
        for key in ("D_A", "D_B"):
            if key in ckpt:
                masked = any("alpha" in k for k in ckpt[key])
                p, s, arch = tp.port_patchgan(ckpt[key], masked=masked)
                out[key] = {"params": p}
                if s:
                    out[key]["batch_stats"] = s
                if arch:
                    out[key]["arch"] = arch
    elif model == "sagan":
        p, s, spec = tp.port_sagan_generator(ckpt["G"])
        out["G"] = {"params": p, "batch_stats": s, "spectral": spec}
        if "D" in ckpt:
            masked = any("alpha" in k for k in ckpt["D"])
            p, spec, arch = tp.port_sagan_discriminator(ckpt["D"], masked)
            out["D"] = {"params": p, "spectral": spec}
            if arch:
                out["D"]["arch"] = arch
    elif model == "srgan":
        p, s = tp.port_srresnet(ckpt["G"])
        out["G"] = {"params": p, "batch_stats": s}
    else:
        raise NotImplementedError(model)
    save_checkpoint(out_path, out)
    return out


def convert_reverse(model: str, in_path: str, out_path: str,
                    num_downs: int = 8, n_blocks: int = 9) -> dict:
    from gcc_tpu_torch.utils.checkpoint import load_checkpoint
    from gcc_tpu_torch.utils.torch_export import export_checkpoint
    return export_checkpoint(model, load_checkpoint(in_path), out_path,
                             num_downs=num_downs, n_blocks=n_blocks)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model", default=None)
    p.add_argument("--pretrain_path", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--num_downs", type=int, default=8)
    p.add_argument("--n_blocks", type=int, default=9)
    p.add_argument("--reverse", action="store_true",
                   help="export a checkpoint to the reference .pth format")
    p.add_argument("--evaluator", default=None,
                   choices=["inception", "drn", "vgg"],
                   help="ingest a pretrained evaluator .pth: validate keys/"
                        "shapes, self-check the forward, emit native .npz")
    p.add_argument("--drn_layers", default=None,
                   help="comma DRN layer counts (default 1,1,3,4,23,3,1,1)")
    p.add_argument("--no_parity_check", action="store_true",
                   help="skip the forward self-check")
    p.add_argument("--gpu_ids", default="0",
                   help="the card of --evaluator's self-check; -1 for the CPU")
    a = p.parse_args(argv)
    if a.evaluator:
        from gcc_tpu_torch.cli.train import run_device
        from gcc_tpu_torch.metrics.ingest import ingest_evaluator
        layers = ([int(v) for v in a.drn_layers.split(",")]
                  if a.drn_layers else None)
        report = ingest_evaluator(a.evaluator, a.pretrain_path, a.output,
                                  layers=layers,
                                  parity=not a.no_parity_check,
                                  device=run_device(a))
        print(json.dumps(report))
        return 0
    if not a.model:
        p.error("--model is required (unless --evaluator is used)")
    fn = convert_reverse if a.reverse else convert
    fn(a.model, a.pretrain_path, a.output, a.num_downs, a.n_blocks)
    print(f"converted {a.pretrain_path} -> {a.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
