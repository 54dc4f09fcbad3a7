"""Temporal-instability metric, paper eq. 3 (port of
``pcss_unet_tpu/losses/temporal.py``).

Reference ``measure_temporal_instability`` (pert_loss.py:170-199):
``mean(exp(α·|I_t − warp(I_{t−1})|) − 1)`` averaged over consecutive frame
pairs, α=5 by reference default (the paper uses α=3, paper.md:133).  With
per-pixel motion vectors the previous frame is backward-warped first
(align-corners bilinear, edge-clamped), the quantity the paper reports for
moving sequences."""

from __future__ import annotations

import torch


def _warp(frame: torch.Tensor, motion: torch.Tensor) -> torch.Tensor:
    """Backward-warp [B,H,W,C] by motion [B,H,W,2] (dy, dx in pixels):
    out(y, x) = frame(y − dy, x − dx), bilinear, edge-clamped."""
    b, h, w, _ = frame.shape
    yy = torch.arange(h, dtype=torch.float32, device=frame.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=frame.device)[None, None, :]
    src_y = torch.clamp(yy - motion[..., 0], 0.0, h - 1)
    src_x = torch.clamp(xx - motion[..., 1], 0.0, w - 1)
    y0 = torch.floor(src_y).long()
    x0 = torch.floor(src_x).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (src_y - y0)[..., None]
    wx = (src_x - x0)[..., None]
    batch_idx = torch.arange(b, device=frame.device)[:, None, None]

    def gather(yi, xi):
        return frame[batch_idx, yi, xi]

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def measure_temporal_instability(frames: torch.Tensor,
                                 motion_vectors: torch.Tensor | None = None,
                                 alpha: float = 5.0) -> torch.Tensor:
    """frames: [T, B, H, W, C]; motion_vectors: [T-1, B, H, W, 2] or None.
    → scalar instability (0 for T < 2, pert_loss.py:182-183)."""
    t = frames.shape[0]
    if t < 2:
        return torch.zeros((), dtype=torch.float32, device=frames.device)
    prev = frames[:-1]
    cur = frames[1:]
    if motion_vectors is not None:
        prev = torch.stack([_warp(p, m) for p, m in zip(prev, motion_vectors)])
    diff = torch.abs(cur.float() - prev.float())
    weighted = torch.exp(alpha * diff) - 1.0        # pert_loss.py:196
    return torch.mean(weighted.reshape(t - 1, -1).mean(dim=1))
