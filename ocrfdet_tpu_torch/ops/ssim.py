"""Windowed SSIM (counterpart of ocrfdet_tpu/ops/ssim.py): an 11 x 11
Gaussian window (sigma 1.5), per-channel depthwise convolutions with
zero 'same' padding, C1 = 0.01^2, C2 = 0.03^2, averaged over everything.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g)


def _depthwise(img, window):
    """img [B, C, H, W]; the window applied per channel, same padding."""
    C, k = img.shape[1], window.shape[-1]
    w = window.expand(C, 1, k, k)
    return F.conv2d(img, w, padding=k // 2, groups=C)


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM over [B, H, W, C] images in [0, 1]."""
    win = torch.from_numpy(_gaussian_window(window_size, sigma)).to(
        img1.dtype).to(img1.device)[None, None]
    a = img1.permute(0, 3, 1, 2)
    b = img2.permute(0, 3, 1, 2)
    mu1, mu2 = _depthwise(a, win), _depthwise(b, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _depthwise(a * a, win) - mu1_sq
    s2 = _depthwise(b * b, win) - mu2_sq
    s12 = _depthwise(a * b, win) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    num = (2 * mu12 + C1) * (2 * s12 + C2)
    den = (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)
    return (num / den).mean()
