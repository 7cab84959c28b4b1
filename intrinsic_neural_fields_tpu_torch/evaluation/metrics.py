"""Image quality metrics (host numpy/scipy), as the reference computes them.

PSNR is masked, with MAX=1. SSIM follows skimage's `structural_similarity`
under the reference's call: 7x7 uniform windows, unbiased covariance,
K1=0.01/K2=0.03, border crop of the filter radius, channels averaged, and
skimage's float-input default data_range of 2.0. DSSIM = (1 - SSIM) / 2.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(fake_img, real_img, obj_mask_1d=None):
    """Masked PSNR with MAX=1 over [0,1] images."""
    if fake_img.shape != real_img.shape:
        raise ValueError(f"shape mismatch {fake_img.shape} vs {real_img.shape}")
    fake = np.asarray(fake_img, dtype=np.float64)
    real = np.asarray(real_img, dtype=np.float64)
    if obj_mask_1d is not None:
        fake = fake.reshape(-1, 3)[obj_mask_1d]
        real = real.reshape(-1, 3)[obj_mask_1d]
    mse = np.mean((fake - real) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(1.0 / np.sqrt(mse))


def epoch_psnr(epoch_mse):
    """-10 log10(MSE) over the accumulated per-sample MSE
    (reference evaluation_metrics.py:25-26)."""
    return -10.0 * np.log10(epoch_mse)


def _ssim_channel(X, Y, win_size, data_range, K1=0.01, K2=0.03):
    X = X.astype(np.float64)
    Y = Y.astype(np.float64)
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)

    def filt(a):
        return uniform_filter(a, size=win_size)

    ux, uy = filt(X), filt(Y)
    uxx, uyy, uxy = filt(X * X), filt(Y * Y), filt(X * Y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / ((ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
    pad = (win_size - 1) // 2
    return S[pad:-pad, pad:-pad].mean()


def structural_similarity(im1, im2, win_size=7, data_range=2.0):
    """Mean SSIM of [H,W] or [H,W,C] images (channels averaged)."""
    if im1.shape != im2.shape:
        raise ValueError(f"shape mismatch {im1.shape} vs {im2.shape}")
    if im1.ndim == 2:
        return _ssim_channel(im1, im2, win_size, data_range)
    return float(np.mean([
        _ssim_channel(im1[..., c], im2[..., c], win_size, data_range)
        for c in range(im1.shape[-1])
    ]))


def dssim(fake_image, real_image):
    """(1 - SSIM) / 2 of two [H,W,3] images."""
    if fake_image.shape != real_image.shape or fake_image.shape[2] != 3:
        raise ValueError(f"need two [H,W,3] images, got {fake_image.shape}, {real_image.shape}")
    return (1.0 - structural_similarity(fake_image, real_image)) / 2.0
