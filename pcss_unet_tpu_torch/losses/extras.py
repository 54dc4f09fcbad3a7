"""Auxiliary image-space loss terms (port of ``pcss_unet_tpu/losses/extras.py``).

The reference computes all three of these inside ``CustomLoss.forward`` and
then **discards them**, returning only the α-blend (customLoss.py:140-193).
Here they are real, config-gated terms (Config.high_freq_weight /
penumbra_weight / sobel_weight, default 0.0 for reference parity).  Images
are NHWC, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _depthwise_conv(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Single-channel NHWC conv with SAME padding (odd kernels)."""
    k = kernel.to(img.dtype)[None, None]                 # [1, 1, kh, kw]
    out = F.conv2d(img.permute(0, 3, 1, 2), k,
                   padding=(kernel.shape[0] // 2, kernel.shape[1] // 2))
    return out.permute(0, 2, 3, 1)


def _to_gray(img: torch.Tensor) -> torch.Tensor:
    # customLoss.py:119-120 / 165: mean over channels if multi-channel
    if img.shape[-1] > 1:
        img = img.mean(dim=-1, keepdim=True)
    return img


def gaussian_kernel(size: int = 5, sigma: float = 1.0,
                    device: str | torch.device = "cpu") -> torch.Tensor:
    """2-D Gaussian, normalized (customLoss.py:106-114)."""
    x = np.arange(size) - size // 2
    xx, yy = np.meshgrid(x, x, indexing="xy")
    k = np.exp(-(xx ** 2 + yy ** 2) / (2 * sigma ** 2))
    return torch.as_tensor((k / k.sum()).astype(np.float32), device=device)


def high_freq_loss(output: torch.Tensor, target: torch.Tensor,
                   size: int = 5, sigma: float = 1.0) -> torch.Tensor:
    """L1 between high-frequency residuals (img − gaussian_blur(img));
    customLoss.py:116-127, 140-142."""
    k = gaussian_kernel(size, sigma, output.device)
    o = _to_gray(output.float())
    t = _to_gray(target.float())
    ho = o - _depthwise_conv(o, k)
    ht = t - _depthwise_conv(t, k)
    return torch.mean(torch.abs(ho - ht))


def penumbra_weighted_l1(output: torch.Tensor, target: torch.Tensor,
                         lo: float = 0.1, hi: float = 0.9) -> torch.Tensor:
    """L1 restricted to the penumbra band 0.1<target<0.9, normalized by the
    band size (customLoss.py:145-153)."""
    mask = ((target > lo) & (target < hi)).float()
    num = torch.sum(torch.abs(output * mask - target * mask))
    return num / (mask.sum() + 1e-8)


def sobel_gradient_loss(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 between Sobel gradient magnitudes; target side has no gradient
    path (customLoss.py:163-185)."""
    sx = torch.tensor([[-1., 0, 1], [-2, 0, 2], [-1, 0, 1]],
                      device=output.device)
    sy = sx.T

    def magnitude(img):
        g = _to_gray(img.float())
        gx = _depthwise_conv(g, sx)
        gy = _depthwise_conv(g, sy)
        return torch.sqrt(gx ** 2 + gy ** 2 + 1e-6)

    tg = magnitude(target).detach()   # customLoss.py:177-178
    return torch.mean(torch.abs(magnitude(output) - tg))
