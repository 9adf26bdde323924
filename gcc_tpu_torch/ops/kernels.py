"""Build and bind the port's CUDA kernels (``gcc_tpu_torch/csrc/*.cu``).

Each source compiles with nvcc into its own shared library with a plain C
interface, loaded with ctypes. Libraries go to ``build/gcc_tpu_torch/`` at
the repository root, named with a hash of their source and flags, so an
edited source is rebuilt and an unchanged one is loaded as is. ``build()``
starts one nvcc per source, all at once. Nothing here runs at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gcc_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point, by source name (pointers and the stream
# as c_void_p, ints as c_int, floats as c_float); every entry point returns cudaError_t as int,
# but the *_partials entry points, gcc_attn_bwd_groups,
# gcc_attn_bwd_bf16_groups, gcc_attn_bf16_serves and gcc_attn_bf16_smem,
# which return a count (or 1/0, or bytes) and take no stream
SIGNATURES: Dict[str, Dict[str, list]] = {
    "mobile_block": {
        "gcc_stage_fwd": [_P] * 9 + [_I] * 6 + [_P],
        "gcc_stage_bwd_pw_partials": [_I] * 6,
        "gcc_stage_bwd_pw": [_P] * 9 + [_I] * 7 + [_P],
        "gcc_stage_bwd_dw": [_P] * 8 + [_I] * 4 + [_P],
    },
    "mobile_block_bf16": {
        "gcc_stage_fwd_bf16": [_P] * 9 + [_I] * 7 + [_P],
        "gcc_stage_bwd_pw_bf16_partials": [_I] * 6,
        "gcc_stage_bwd_pw_bf16": [_P] * 9 + [_I] * 7 + [_P],
        "gcc_stage_bwd_dw_bf16_partials": [_I],
        "gcc_stage_bwd_dw_bf16": [_P] * 8 + [_I] * 4 + [_P],
        "gcc_bf16x2_probe": [_P] * 4 + [_I] + [_P],
    },
    "flash_attention": {
        "gcc_attn_fwd": [_P] * 5 + [_I] * 4 + [_P],
        "gcc_attn_bwd_groups": [_I],
        "gcc_attn_bwd": [_P] * 10 + [_I] * 4 + [_P],
        "gcc_attn_fwd_bf16_wide": [_P] * 5 + [_I] * 4 + [_P],
        "gcc_attn_bwd_bf16_wide": [_P] * 10 + [_I] * 4 + [_P],
    },
    "flash_attention_bf16": {
        "gcc_attn_bf16_serves": [_I] * 3,
        "gcc_attn_bf16_smem": [_I] * 3,
        "gcc_attn_fwd_bf16": [_P] * 5 + [_I] * 4 + [_P],
        "gcc_attn_bwd_bf16_groups": [_I] * 4,
        "gcc_attn_bwd_bf16": [_P] * 10 + [_I] * 4 + [_P],
    },
    "batch_norm_bf16": {
        "gcc_bn_fwd_bf16": [_P] * 9 + [_I] * 4 + [_F] * 4 + [_P],
        "gcc_bn_bwd_bf16": [_P] * 9 + [_I] * 4 + [_P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    """Library path of ``csrc/<name>.cu``, named by a hash of the source, of
    every header in ``csrc/`` (any source may include them) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names: List[str] = None) -> float:
    """Compile every source in ``names`` (default: all) that has no current
    library, one nvcc process per source, all started together. Returns the
    seconds it took; raises with nvcc's output if any build fails."""
    names = list(SIGNATURES) if names is None else names
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def launch(name: str, fn: str, *args) -> None:
    """Call entry point ``fn`` of library ``name`` on the current stream of
    the current device; raise if it reports a CUDA error."""
    entry = _ENTRIES.get((name, fn))
    if entry is None:
        entry = _ENTRIES[(name, fn)] = getattr(library(name), fn)
    # the current stream's handle, without building a torch.cuda.Stream
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    err = entry(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} failed with CUDA error {err}")


def check(device: torch.device, name: str, t: torch.Tensor, shape,
          dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what every kernel entry point takes (weights are float32,
    activations float32 or, where an entry point has a bf16 variant,
    bfloat16)."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}"
                         f"{'' if t.is_contiguous() else ', non-contiguous'}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def bf16_err(got: torch.Tensor, ref: torch.Tensor) -> Tuple[float, float,
                                                             float]:
    """(max |got - ref| in bf16 ulps of max |ref|, max |got - ref|, the
    share of elements that differ at all): how a bf16 kernel's output is
    held to its plain version's."""
    top = float(ref.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)
    d = (got.float() - ref.float()).abs()
    return float(d.max()) / ulp, float(d.max()), float((d > 0).float().mean())


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def on_device(dev: torch.device):
    """A context in which dev is the current CUDA device: none to enter
    where it is already (the common case, and a cost the host pays every
    call)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def ptr(t) -> int:
    """Device pointer of a tensor, or NULL for None."""
    return None if t is None else t.data_ptr()
