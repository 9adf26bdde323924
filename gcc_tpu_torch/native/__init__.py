"""ctypes bindings for the native image transform engine (port of
gcc_tpu/native/__init__.py).

``image_ops.cpp`` is built with g++ at first use into ``build/gcc_tpu_torch/``
at the repository root, named with a hash of the source and the flags (as
ops/kernels.py names the CUDA libraries), so an edited source is rebuilt and
an unchanged one is loaded as is. Nothing builds at import.

Unlike the JAX package, which quietly keeps the PIL path when the build
fails, a failed build raises with the compiler's output: ``--native_loader``
asks for this engine, and a run that silently took another path would not
be the run that was asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "image_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gcc_tpu_torch"
GXX_FLAGS = ["-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC",
             "-std=c++17", "-pthread"]

_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libgcc_image_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile image_ops.cpp unless its library exists; raise with g++'s
    output if the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("--native_loader: g++ not found; the native "
                           "engine builds with g++") from e
    if proc.returncode != 0:
        raise RuntimeError(f"--native_loader: g++ failed to build {SRC}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded engine, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.gcc_resize_bicubic_u8.argtypes = [
                _U8P, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int,
                ctypes.c_int]
            lib.gcc_transform_batch.argtypes = [
                ctypes.POINTER(_U8P), _IP, _IP, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                _IP, _IP, _IP, ctypes.c_int]
            _lib = lib
        return _lib


def resize_bicubic(img_u8: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """uint8 HWC(3) -> uint8 HWC(3), PIL's bicubic within one level."""
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    out = np.empty((out_h, out_w, 3), np.uint8)
    library().gcc_resize_bicubic_u8(
        img_u8.ctypes.data_as(_U8P), img_u8.shape[0], img_u8.shape[1],
        out.ctypes.data_as(_U8P), out_h, out_w)
    return out


def transform_batch(images_u8: Sequence[np.ndarray], load_size: int,
                    crop_size: int, crop_pos: Sequence,
                    flips: Sequence[bool],
                    num_threads: int = 8) -> np.ndarray:
    """Batch of uint8 HWC(3) images -> float32 NHWC in [-1, 1] (resize to
    load_size, crop at crop_pos, flip, normalize) on the C++ thread pool."""
    lib = library()
    n = len(images_u8)
    imgs = [np.ascontiguousarray(im, np.uint8) for im in images_u8]
    ptrs = (_U8P * n)(*[im.ctypes.data_as(_U8P) for im in imgs])
    hs = (ctypes.c_int * n)(*[im.shape[0] for im in imgs])
    ws = (ctypes.c_int * n)(*[im.shape[1] for im in imgs])
    cxs = (ctypes.c_int * n)(*[int(p[0]) for p in crop_pos])
    cys = (ctypes.c_int * n)(*[int(p[1]) for p in crop_pos])
    fl = (ctypes.c_int * n)(*[int(bool(f)) for f in flips])
    out = np.empty((n, crop_size, crop_size, 3), np.float32)
    lib.gcc_transform_batch(
        ptrs, hs, ws, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        load_size, crop_size, cxs, cys, fl, num_threads)
    return out
