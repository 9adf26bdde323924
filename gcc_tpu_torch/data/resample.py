"""Pillow's 8-bit resampling in numpy (libImaging/Resample.c), bit for bit.

The JAX package resizes through PIL (``Image.resize``); the port needs no
PIL, so it carries the same algorithm:

  * one coefficient table per axis: output pixel ``xx`` reads input pixels
    ``[xmin, xmin + n)`` around ``center = (xx + 0.5) * scale``, the filter's
    support widened by the downsampling factor, the weights normalised to
    sum 1 and rounded to fixed point with ``PRECISION_BITS`` fraction bits
    (away from zero);
  * the horizontal pass first, into a uint8 intermediate (rounded and
    clipped), then the vertical pass on that intermediate.

Each pass is one float64 matrix product with the fixed-point weights,
exact in integers (``_pass``), so the work runs in BLAS outside the GIL.

Images are HWC (or HW) uint8 arrays; sizes are PIL's ``(width, height)``.
``resize_float`` is Pillow's 32-bit float mode ("F") on the same windows,
with unrounded weights.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2
BILINEAR = "bilinear"
BICUBIC = "bicubic"


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    # Keys' cubic, in Resample.c's order of operations
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


FILTERS = {BILINEAR: (_bilinear, 1.0), BICUBIC: (_bicubic, 2.0)}


def float_coefficients(in_size: int, out_size: int, method: str
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """precompute_coeffs: (xmin (out,), float64 weights (out, ksize)
    normalised to sum 1, zero past each row's window)."""
    filt, fsupport = FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = fsupport * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # (int) truncates toward zero; a negative start clips to 0 either way
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)
    w = filt((x[None, :] + xmin[:, None] - center[:, None] + 0.5)
             * (1.0 / filterscale))
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for i in range(ksize):  # the C loop's order of summation
        ww = ww + w[:, i]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    return xmin, w


def coefficients(in_size: int, out_size: int, method: str
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """precompute_coeffs + normalize_coeffs_8bpc: (xmin (out,), fixed-point
    weights (out, ksize) int64, zero past each row's window)."""
    xmin, w = float_coefficients(in_size, out_size, method)
    one = float(1 << PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    return xmin, fixed.astype(np.int64)


def _dense(xmin: np.ndarray, k: np.ndarray, in_size: int) -> np.ndarray:
    """Per-row windows (xmin, weights) as a dense (out, in) float64 matrix."""
    cols = xmin[:, None] + np.arange(k.shape[1])[None, :]
    rows = np.broadcast_to(np.arange(len(xmin))[:, None], cols.shape)
    inside = cols < in_size  # past the window the weight is 0
    w = np.zeros((len(xmin), in_size))
    w[rows[inside], cols[inside]] = k[inside]
    return w


@functools.lru_cache(maxsize=16)
def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """The fixed-point coefficients as a dense (out, in) float64 matrix
    (read-only: one per size pair, shared)."""
    w = _dense(*coefficients(in_size, out_size, method), in_size)
    w.flags.writeable = False
    return w


def _pass(img: np.ndarray, axis: int, out_size: int, method: str
          ) -> np.ndarray:
    """One 1-D pass along ``axis`` (0: rows, 1: columns) of an HWC image.

    The sums of Resample.c are integer: pixel (< 2**8) times weight
    (|w| < 2**23), at most a few 2**30 in all, so a float64 product, whose
    mantissa holds 53 bits, computes each exactly in any order."""
    w = weight_matrix(img.shape[axis], out_size, method)
    src = np.moveaxis(img, axis, 0)
    acc = (w @ src.reshape(src.shape[0], -1).astype(np.float64)
           ).astype(np.int64) + (1 << (PRECISION_BITS - 1))
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out.reshape((out_size,) + src.shape[1:]), 0, axis)


def resize(img: np.ndarray, size: Tuple[int, int], method: str = BICUBIC
           ) -> np.ndarray:
    """``Image.fromarray(img).resize(size, method)`` for a uint8 HWC or HW
    array; ``size`` is (width, height)."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize takes uint8 images, not {img.dtype}")
    w, h = int(size[0]), int(size[1])
    out = img
    if w != img.shape[1]:
        out = _pass(out, 1, w, method)
    if h != img.shape[0]:
        out = _pass(out, 0, h, method)
    return out.copy() if out is img else out


def resize_float(img: np.ndarray, size: Tuple[int, int],
                 method: str = BILINEAR) -> np.ndarray:
    """``Image.fromarray(img).resize(size, method)`` for a float32 HW array,
    or each channel of an HWC one (Pillow's mode "F",
    ImagingResampleHorizontal/Vertical_32bpc): the same windows with float
    weights, each sum in float64, each pass rounded to float32; the
    horizontal pass first. ``size`` is (width, height)."""
    out = np.asarray(img, np.float32)
    for axis, n in ((1, int(size[0])), (0, int(size[1]))):
        if n != out.shape[axis]:
            w = _dense(*float_coefficients(out.shape[axis], n, method),
                       out.shape[axis])
            src = np.moveaxis(out, axis, 0).astype(np.float64)
            out = np.moveaxis((w @ src.reshape(src.shape[0], -1)).reshape(
                (n,) + src.shape[1:]).astype(np.float32), 0, axis)
    return np.ascontiguousarray(out)
