"""SSIM structural-similarity loss term (port of ``pcss_unet_tpu/losses/ssim.py``).

The reference imports ``pytorch_msssim`` (customLoss.py:5) and carries a
commented-out ``1 − SSIM`` term (customLoss.py:187-191).  Here the
capability is real: standard single-scale SSIM (Wang et al. 2004 formula,
11×11 Gaussian window σ=1.5, k1=0.01, k2=0.03, dynamic range 1.0 for
sigmoid outputs, VALID filtering), exposed as the config-gated loss weight
``ssim_weight`` (term = 1 − SSIM), default 0 for reference parity.

On a row shard (``rows``, ``parallel/spatial.py``) each shard takes the
10 rows below it from its neighbour and owns the map rows that start in it:
the map has 10 rows fewer than the frame, so the last shard owns 10 fewer
than the others, and the mean is the all-reduced sum over the all-reduced
count (``group``: every rank of the grid)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from pcss_unet_tpu_torch.utils.distributed import (all_reduce_sum,
                                                   halo_exchange)


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
         data_range: float = 1.0, rows=None, group=None) -> torch.Tensor:
    """Mean SSIM over NHWC single-channel images → scalar in [−1, 1];
    ``rows`` / ``group``: a and b are this rank's row shard of a grid's
    frames (the module docstring; ``group`` None: the data index's shards)."""
    a = a.float()
    b = b.float()
    h = a.shape[1]
    if rows is not None:
        both = halo_exchange(torch.cat([a, b], dim=-1), 0, window_size - 1,
                             rows, dim=1)
        a, b = both[..., :1], both[..., 1:]
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
    if rows is None:
        return torch.mean(num / den)
    # the map rows that start in this shard and end inside the frame
    own = max(0, min(h, h * rows.count - (window_size - 1) - rows.index * h))
    m = (num / den)[:, :own]
    sums = torch.stack([m.sum(), m.new_tensor(float(m.numel()))])
    sums = all_reduce_sum(sums, rows.group if group is None else group)
    return sums[0] / sums[1]


def ssim_loss(output: torch.Tensor, target: torch.Tensor, **kwargs) -> torch.Tensor:
    """1 − SSIM (customLoss.py:187-188 semantics, shipped working);
    ``kwargs``: ``ssim``'s."""
    return 1.0 - ssim(output, target, **kwargs)
