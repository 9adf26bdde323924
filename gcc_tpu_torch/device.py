"""Device resolution and the compute dtype of the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: ``cuda`` if present, else an error — there is
    no silent CPU path. Pass ``device="cpu"`` to run on the CPU, where every
    kernel wrapper takes its plain PyTorch version.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        dev = torch.device("cuda")
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def configure_precision(device: torch.device) -> None:
    """The bf16 settings of an engine that computes in bf16 on ``device``.

    The TPU sums the products of bf16 operands in fp32 (the MXU's
    preferred_element_type=f32), so on the card cuBLAS may not reduce a bf16
    matmul in bf16: allow_bf16_reduced_precision_reduction goes off, for the
    whole process, as torch keeps it. cuDNN's bf16 convolutions accumulate
    in fp32 already, and the stage kernels sum in fp32 (csrc/). Nothing
    changes on the CPU."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False


def compute_dtype(cfg) -> torch.dtype:
    """The dtype a run's batches are cast to, and so the dtype its engine
    computes in (the dtype follows the data, as in the JAX package):
    ``--compute_dtype``, for every family."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """TF32 off for cuDNN convolutions and for matmuls inside the block, the
    caller's settings restored after it: the evaluator networks' metrics do
    not depend on what an engine set."""
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = matmul
