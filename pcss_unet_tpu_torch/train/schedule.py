"""Learning-rate and gradient-clip schedules (port of
``pcss_unet_tpu/train/schedule.py``).

Reference LR schedule (main.py:959-969): LambdaLR with linear warmup over
``warmup_epochs`` then cosine decay floored at 1% of the base LR, stepped
once per epoch after validation.  Here the same curve is a per-step
schedule: evaluated at epoch boundaries it produces exactly the reference's
factors, and between boundaries it interpolates smoothly (set
``granularity='epoch'`` for the stair-stepped reference behavior).

Reference clip schedule (main.py:356-358, 405): global-norm clip with
max_norm 1.0 for the first half of training, then ``max(0.1, 1 −
epoch/num_epochs)``.

Both are plain functions of the step, a tensor (on the step's device, so
the train step never reads it on the host) or a Python int, and compute in
float32 as the reference does.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine_schedule(base_lr: float, warmup_epochs: int,
                           num_epochs: int, steps_per_epoch: int,
                           floor_fraction: float = 0.01,
                           granularity: str = "step") -> Callable:
    """→ schedule step → lr (a float32 tensor)."""
    warmup_steps = max(1, warmup_epochs * steps_per_epoch)
    total_steps = max(warmup_steps + 1, num_epochs * steps_per_epoch)

    def schedule(step) -> torch.Tensor:
        step = _f32(step)
        if granularity == "epoch":
            step = torch.floor(step / steps_per_epoch) * steps_per_epoch
        warm = step / warmup_steps
        progress = torch.clamp((step - warmup_steps)
                               / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
        decayed = torch.clamp(cos, min=floor_fraction)
        return base_lr * torch.where(step < warmup_steps, warm, decayed)

    return schedule


def clip_norm_for_step(step, steps_per_epoch: int, num_epochs: int,
                       initial: float = 1.0,
                       enabled: bool = True) -> torch.Tensor:
    """Dynamic max-norm: ``initial`` for the first half of training, then
    ``max(0.1, 1 − epoch_ratio)`` (main.py:356-358).  A float32 tensor on
    the step's device."""
    step = _f32(step)
    if not enabled:
        return torch.full_like(step, initial)
    epoch = step / steps_per_epoch
    ratio = epoch / max(1, num_epochs)
    late = torch.clamp(1.0 - ratio, min=0.1)
    return torch.where(ratio < 0.5, torch.full_like(step, initial), late)
