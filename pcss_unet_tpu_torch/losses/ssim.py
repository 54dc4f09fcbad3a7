"""SSIM structural-similarity loss term (port of ``pcss_unet_tpu/losses/ssim.py``).

The reference imports ``pytorch_msssim`` (customLoss.py:5) and carries a
commented-out ``1 − SSIM`` term (customLoss.py:187-191).  Here the
capability is real: standard single-scale SSIM (Wang et al. 2004 formula,
11×11 Gaussian window σ=1.5, k1=0.01, k2=0.03, dynamic range 1.0 for
sigmoid outputs, VALID filtering), exposed as the config-gated loss weight
``ssim_weight`` (term = 1 − SSIM), default 0 for reference parity."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = (g / g.sum()).astype(np.float32)
    return np.outer(g, g)


def _filter(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """NHWC single-channel VALID filter."""
    out = F.conv2d(img.permute(0, 3, 1, 2), window.to(img.dtype)[None, None])
    return out.permute(0, 2, 3, 1)


def ssim(a: torch.Tensor, b: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM over NHWC single-channel images → scalar in [−1, 1]."""
    a = a.float()
    b = b.float()
    win = torch.as_tensor(_gaussian_window(window_size, sigma), device=a.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_a = _filter(a, win)
    mu_b = _filter(b, win)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    var_a = _filter(a * a, win) - mu_aa
    var_b = _filter(b * b, win) - mu_bb
    cov = _filter(a * b, win) - mu_ab
    num = (2 * mu_ab + c1) * (2 * cov + c2)
    den = (mu_aa + mu_bb + c1) * (var_a + var_b + c2)
    return torch.mean(num / den)


def ssim_loss(output: torch.Tensor, target: torch.Tensor, **kwargs) -> torch.Tensor:
    """1 − SSIM (customLoss.py:187-188 semantics, shipped working)."""
    return 1.0 - ssim(output, target, **kwargs)
