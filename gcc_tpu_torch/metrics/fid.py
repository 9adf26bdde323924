"""Fréchet distance and activation statistics (copy of gcc_tpu/metrics/fid.py;
metric/fid_score.py:219-284). The InceptionV3 feature extractor is
``metrics/inception.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def activation_statistics(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """mu, sigma of (N, D) activations (fid_score.py:_compute_statistics)."""
    acts = np.asarray(acts, np.float64)
    mu = acts.mean(axis=0)
    sigma = np.cov(acts, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), with the reference's
    eps-on-singular retry (fid_score.py:252-271)."""
    from scipy import linalg

    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    diff = mu1 - mu2

    # sqrtm's disp flag (the JAX package's disp=False) is gone from scipy
    # 1.18; the default returns the same matrix
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def fid_from_activations(fake_acts: np.ndarray, real_mu: np.ndarray,
                         real_sigma: np.ndarray) -> float:
    """FID of generated activations vs precomputed real stats (the
    real_stat*.npz contract, metric/get_real_stat.py:13-33)."""
    mu, sigma = activation_statistics(fake_acts)
    return frechet_distance(mu, sigma, real_mu, real_sigma)
