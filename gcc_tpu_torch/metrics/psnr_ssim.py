"""PSNR / SSIM on the Y (luma) channel — SRGAN's evaluation protocol
(copy of gcc_tpu/metrics/psnr_ssim.py; models/SRGAN.py:653-661,
data/sr_dataset.py:58-62).

y_channel reproduces convert_image(..., target='y-channel'): 4-pixel border
crop, ITU-R BT.601 weights [65.481, 128.553, 24.966] applied to [0,1] RGB,
/255 + 16 — values in [16, 235].

psnr/ssim reproduce skimage.metrics.peak_signal_noise_ratio and
structural_similarity defaults for 2-D float inputs (data_range=255,
win_size=7, uniform window, K1=0.01, K2=0.03, sample-covariance
normalization) — the reference calls exactly those (SRGAN.py:656, 660).
"""

from __future__ import annotations

import numpy as np

RGB_WEIGHTS = np.array([65.481, 128.553, 24.966], np.float64)


def y_channel(img_m11: np.ndarray) -> np.ndarray:
    """[-1,1] HWC (or NHWC) -> Y-channel HxW (or NxHxW), borders cropped."""
    x = np.asarray(img_m11, np.float64)
    if x.ndim == 3:
        x = x[None]
    x01 = (x + 1.0) / 2.0
    y = (255.0 * x01[:, 4:-4, 4:-4, :]) @ RGB_WEIGHTS / 255.0 + 16.0
    return y[0] if img_m11.ndim == 3 else y


def psnr_y(fake_m11: np.ndarray, real_m11: np.ndarray,
           data_range: float = 255.0) -> float:
    f, r = y_channel(fake_m11), y_channel(real_m11)
    err = np.mean((f - r) ** 2)
    return float(10.0 * np.log10(data_range ** 2 / err))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Mean filter with 'valid' windows via integral image."""
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    s = (c[size:, size:] - c[:-size, size:] - c[size:, :-size]
         + c[:-size, :-size])
    return s / (size * size)


def ssim_y(fake_m11: np.ndarray, real_m11: np.ndarray,
           data_range: float = 255.0, win_size: int = 7,
           k1: float = 0.01, k2: float = 0.03) -> float:
    """structural_similarity on Y channels with skimage float defaults."""
    x, y = y_channel(fake_m11), y_channel(real_m11)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)

    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1)  # sample covariance (skimage)

    ux = _uniform_filter(x, win_size)
    uy = _uniform_filter(y, win_size)
    uxx = _uniform_filter(x * x, win_size)
    uyy = _uniform_filter(y * y, win_size)
    uxy = _uniform_filter(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux ** 2 + uy ** 2 + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    # skimage computes over valid windows, then ignores another pad border;
    # with the integral-image 'valid' output the remaining crop is zero,
    # matching skimage's crop(S, pad) on its 'same'-size map.
    return float(s.mean())
