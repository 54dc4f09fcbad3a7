"""Auxiliary image-space loss terms (port of ``pcss_unet_tpu/losses/extras.py``).

The reference computes all three of these inside ``CustomLoss.forward`` and
then **discards them**, returning only the α-blend (customLoss.py:140-193).
Here they are real, config-gated terms (Config.high_freq_weight /
penumbra_weight / sobel_weight, default 0.0 for reference parity).  Images
are NHWC, as in the reference.  On a row shard (``rows``,
``parallel/spatial.py``) the stencils take their halo rows from the
neighbouring shards, and the high-frequency and Sobel terms stay means of
equal-size shards.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pcss_unet_tpu_torch.parallel.spatial import conv2d_rows
from pcss_unet_tpu_torch.utils.distributed import all_reduce_sum


def _depthwise_conv(img: torch.Tensor, kernel: torch.Tensor,
                    rows=None) -> torch.Tensor:
    """Single-channel NHWC conv with SAME padding (odd kernels); ``rows``:
    img is a row shard of the frames."""
    k = kernel.to(img.dtype)[None, None]                 # [1, 1, kh, kw]
    pad = (kernel.shape[0] // 2, kernel.shape[1] // 2)
    x = img.permute(0, 3, 1, 2)
    out = (F.conv2d(x, k, padding=pad) if rows is None
           else conv2d_rows(x, k, None, rows, pad))
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
                   size: int = 5, sigma: float = 1.0, rows=None) -> torch.Tensor:
    """L1 between high-frequency residuals (img − gaussian_blur(img));
    customLoss.py:116-127, 140-142."""
    k = gaussian_kernel(size, sigma, output.device)
    o = _to_gray(output.float())
    t = _to_gray(target.float())
    ho = o - _depthwise_conv(o, k, rows)
    ht = t - _depthwise_conv(t, k, rows)
    return torch.mean(torch.abs(ho - ht))


def penumbra_weighted_l1(output: torch.Tensor, target: torch.Tensor,
                         lo: float = 0.1, hi: float = 0.9,
                         group=None) -> torch.Tensor:
    """L1 restricted to the penumbra band 0.1<target<0.9, normalized by the
    band size (customLoss.py:145-153).  ``group``: the ratio of the process
    group's whole batch (both sums all-reduced, differentiably)."""
    mask = ((target > lo) & (target < hi)).float()
    sums = torch.stack([torch.sum(torch.abs(output * mask - target * mask)),
                        mask.sum()])
    if group is not None:
        sums = all_reduce_sum(sums, group)
    return sums[0] / (sums[1] + 1e-8)


def sobel_gradient_loss(output: torch.Tensor, target: torch.Tensor,
                        rows=None) -> torch.Tensor:
    """L1 between Sobel gradient magnitudes; target side has no gradient
    path (customLoss.py:163-185)."""
    sx = torch.tensor([[-1., 0, 1], [-2, 0, 2], [-1, 0, 1]],
                      device=output.device)
    sy = sx.T

    def magnitude(img):
        g = _to_gray(img.float())
        gx = _depthwise_conv(g, sx, rows)
        gy = _depthwise_conv(g, sy, rows)
        return torch.sqrt(gx ** 2 + gy ** 2 + 1e-6)

    tg = magnitude(target).detach()   # customLoss.py:177-178
    return torch.mean(torch.abs(magnitude(output) - tg))
