"""Evaluator-weights ingestion: validate, convert, self-check (port of
gcc_tpu/metrics/ingest.py).

The pretrained evaluators cannot be downloaded here (reference sources:
metric/inception.py:13 TF-FID InceptionV3, metric/drn.py:8-18 DRN-D-105,
models/GANLoss.py:95-144 torchvision VGG19); a user brings the ``.pth``:

  python -m gcc_tpu_torch.cli.convert --evaluator inception \\
      --pretrain_path pt_inception-2015-12-05-6726825d.pth \\
      --output inception.npz

Per evaluator:
  1. load the state dict (a file saved by torch, read with
     ``weights_only=True``, or an ``.npz``), descending into the common
     'state_dict'/'model' containers and noting it;
  2. key and shape validation against the port's network, which carries
     the reference's names: every missing, unexpected or wrongly shaped
     key is reported with an actionable message (``IngestError``). The
     keys the evaluator never reads are set aside first: DataParallel's
     ``module.`` prefixes, BatchNorm's ``num_batches_tracked``, the TF-FID
     file's 1008-way ``fc`` head, DRN's fixed ``up`` kernel and VGG's
     ``classifier.*``;
  3. self-check: the strict-loaded network runs on the entry point's
     device (fp32, TF32 off) and on the CPU in float64 from the same
     weights and inputs; they must agree to 1e-4 relative (the port's
     network is the torch topology itself, so this takes the place of the
     JAX package's comparison with its torch oracle);
  4. write the ``.npz`` of the validated state dict (what --inception_path,
     --drn_path and --vgg_path read) and reload it, bit for bit.

The report has the JAX package's keys; ``forward_rel_err_vs_torch`` is
step 3's difference.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence

import numpy as np
import torch

EVALUATORS = ("inception", "drn", "vgg")

_SOURCES = {
    "inception": "the TF-FID InceptionV3 .pth (reference metric/"
                 "inception.py:13: pt_inception-2015-12-05-6726825d.pth)",
    "drn": "a DRN-D-105 DRNSeg cityscapes checkpoint (reference "
           "metric/drn.py:8-18; 'module.' DataParallel prefixes are fine)",
    "vgg": "a torchvision vgg19 state_dict (reference models/"
           "GANLoss.py:95-144; classifier.* keys are ignored)",
}
_FLAGS = {"inception": "--inception_path", "drn": "--drn_path",
          "vgg": "--vgg_path"}


class IngestError(ValueError):
    """Validation failure with an actionable message."""


def _load_sd(path: str) -> tuple:
    """The file's state dict as {key: np.ndarray}, descending into
    containers, and a note when it did."""
    note = None
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}, note
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for container in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(container), dict):
            obj = obj[container]
            note = f"descended into '{container}'"
            break
    if not isinstance(obj, dict):
        raise IngestError(
            f"{path} does not contain a state_dict (got "
            f"{type(obj).__name__}); save model.state_dict() directly")
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in obj.items()}, note


def _net(kind: str, layers):
    """A fresh CPU network of one evaluator."""
    if kind == "inception":
        from gcc_tpu_torch.metrics.inception import FIDInceptionV3
        return FIDInceptionV3()
    if kind == "drn":
        from gcc_tpu_torch.metrics.miou import DRNSeg
        return DRNSeg(layers=tuple(layers))
    from gcc_tpu_torch.metrics.vgg import TruncatedVGG19
    return TruncatedVGG19()


def _relevant(kind: str, sd: Dict) -> Dict:
    """The keys the evaluator reads, under the reference's names."""
    from gcc_tpu_torch.metrics.inception import HEAD_KEYS
    from gcc_tpu_torch.metrics.miou import UP_KEYS
    from gcc_tpu_torch.utils.weights import clean_state_dict
    sd = clean_state_dict(sd, ignore={"inception": HEAD_KEYS,
                                      "drn": UP_KEYS}.get(kind, ()))
    if kind == "vgg":
        sd = {k: v for k, v in sd.items() if not k.startswith("classifier.")}
    return sd


def _expected(kind: str, net) -> Dict[str, tuple]:
    shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    if kind == "vgg":  # the port's conv_<idx> is torchvision's features.<idx>
        shapes = {"features." + k[len("conv_"):]: s
                  for k, s in shapes.items()}
    return shapes


def _validate(kind: str, sd: Dict, want: Dict[str, tuple]) -> Dict:
    got = {k: tuple(np.shape(v)) for k, v in sd.items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    bad = sorted(k for k in set(want) & set(got) if want[k] != got[k])
    if missing or extra or bad:
        lines = [f"{kind}: the file does not match the evaluator "
                 f"architecture"]
        for name, items in (("missing", missing), ("unexpected", extra)):
            for k in items[:10]:
                lines.append(f"  {name}: {k}")
        for k in bad[:10]:
            lines.append(f"  shape mismatch at {k}: file has {got[k]}, "
                         f"architecture wants {want[k]}")
        n_more = max(0, len(missing) + len(extra) + len(bad) - 30)
        if n_more:
            lines.append(f"  ... and {n_more} more")
        lines.append(f"expected source: {_SOURCES[kind]}")
        raise IngestError("\n".join(lines))
    return {"leaves": len(want)}


def _load(kind: str, net, sd: Dict):
    """net, strict-loaded with sd, in eval mode."""
    if kind == "vgg":
        from gcc_tpu_torch.metrics.vgg import load_torch_vgg19
        from gcc_tpu_torch.utils.weights import load_jax_variables
        load_jax_variables(net, {"params": load_torch_vgg19(sd)})
    else:
        net.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                             for k, v in sd.items()}, strict=True)
    return net.eval()


def _forward(kind: str, net, x_nhwc: np.ndarray, device, dtype):
    from gcc_tpu_torch.device import exact_fp32
    from gcc_tpu_torch.metrics.miou import upsample_logits_8x
    net = net.to(device=device, dtype=dtype)
    x = torch.from_numpy(x_nhwc).to(device=device, dtype=dtype)
    with torch.no_grad(), exact_fp32():
        out = net(x.permute(0, 3, 1, 2))
        if kind == "drn":
            out = upsample_logits_8x(out)
    return out.cpu().double().numpy()


def _self_check(kind: str, net, device, tol: float) -> float:
    """The network on ``device`` in fp32 against the same weights on the
    CPU in float64, on the JAX package's check inputs."""
    rng = np.random.RandomState(0)
    if kind == "inception":
        x = rng.rand(2, 96, 96, 3).astype(np.float32)  # (0, 1)
    else:
        x = rng.randn(1, 32, 32, 3).astype(np.float32)
    ours = _forward(kind, copy.deepcopy(net), x, device, torch.float32)
    ref = _forward(kind, copy.deepcopy(net), x, torch.device("cpu"),
                   torch.float64)
    rel = float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-8))
    if not np.isfinite(rel) or rel > tol:
        raise IngestError(
            f"{kind}: the network on {device} disagrees with the float64 CPU "
            f"run of the same weights (rel err {rel:.2e} > {tol:g}); the file "
            f"loads but does not compute a stable function — wrong variant? "
            f"expected source: {_SOURCES[kind]}")
    return rel


def ingest_evaluator(kind: str, in_path: str, out_path: str,
                     layers: Optional[Sequence[int]] = None,
                     parity: bool = True, logger=None,
                     parity_tol: float = 1e-4, device=None) -> Dict:
    """Validate, convert and self-check one evaluator checkpoint on
    ``device`` (the card unless the CPU is asked for). Returns a report;
    raises IngestError with an actionable message on any failure."""
    from gcc_tpu_torch.device import resolve_device
    from gcc_tpu_torch.metrics.miou import DRN_D_105_LAYERS

    log = logger.info if logger else print
    if kind not in EVALUATORS:
        raise IngestError(f"unknown evaluator '{kind}' "
                          f"(choose from {', '.join(EVALUATORS)})")
    dev = resolve_device(device)
    layers = tuple(layers or DRN_D_105_LAYERS)
    report: Dict = {"evaluator": kind, "input": in_path, "output": out_path}

    raw, note = _load_sd(in_path)
    if note:
        report["container"] = note
    report["keys_in_file"] = len(raw)

    # 2. structural validation under the reference's names
    sd = _relevant(kind, raw)
    net = _net(kind, layers)
    report.update(_validate(kind, sd, _expected(kind, net)))
    _load(kind, net, sd)
    log(f"{kind}: key/shape validation OK ({report['leaves']} leaves)")

    # 3. the device's forward against float64 on the CPU
    if parity:
        rel = _self_check(kind, net, dev, parity_tol)
        report["forward_rel_err_vs_torch"] = rel
        log(f"{kind}: forward on {dev} vs float64 CPU OK (rel err "
            f"{rel:.2e})")

    # 4. the npz, and a bitwise reload
    np.savez(out_path, **sd)
    real_out = out_path if out_path.endswith(".npz") else out_path + ".npz"
    report["output"] = real_out
    again = _load(kind, _net(kind, layers),
                  _relevant(kind, _load_sd(real_out)[0]))
    mine, theirs = net.state_dict(), again.state_dict()
    if any(not torch.equal(mine[k], theirs[k]) for k in mine):
        raise IngestError(f"{kind}: npz round-trip is not bitwise "
                          f"(internal error — please report)")
    report["roundtrip"] = "bitwise"
    log(f"{kind}: wrote {real_out} (use it via {_FLAGS[kind]})")
    return report
