"""Input-perturbation temporal-stability loss (port of
``pcss_unet_tpu/losses/perturbation.py``; paper §perturbation training,
reference pert_loss.py:7-90).

- per-channel noise scale = std of that channel across the whole batch
  (Bessel-corrected, as torch ``.std()``) × ``std_factor=0.01``
  (pert_loss.py:40-56)
- ``p`` perturbed copies are re-forwarded through the model without
  gradients (the reference's ``no_grad``, pert_loss.py:78-81)
- loss = mean over copies of L1(original_output, perturbed_output)
  (pert_loss.py:83-90)

The JAX package runs the p forwards as one ``vmap``; here they run one
after another under ``torch.no_grad()``, each on the whole batch, which
keeps the vmap's semantics: each copy takes BatchNorm statistics over its
own B samples, and ``apply_fn`` (the train step's) gives every copy the
same dropout masks, as one dropout key under ``vmap`` does.  The noise
comes from ``generator`` (on the inputs' device), or is passed in as
``noise`` [p, *inputs.shape] so that a test can share it with the JAX
package.

With a process ``group`` the inputs are this rank's equal shard of the
group's batch: the noise is drawn for the whole batch from the (shared)
generator and sliced to the rank's rows, and the channel σ is the whole
batch's, so each rank computes its rows of the one-process result."""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from pcss_unet_tpu_torch.utils.distributed import rank_slice


def perturb_inputs(inputs: torch.Tensor, count: int, std_factor: float = 0.01,
                   noise_mode: str = "channel_std",
                   generator: torch.Generator | None = None,
                   noise: torch.Tensor | None = None,
                   group=None) -> torch.Tensor:
    """→ [p, B, H, W, C] noisy copies of NHWC ``inputs``.

    noise_mode:
    - 'channel_std' (default): per-channel σ scaled by ``std_factor``
      (pert_loss.py:40-56, Bessel-corrected like torch ``.std()``)
    - 'fixed_eps': ``std_factor``-scaled noise with a [−10, 10] clamp — the
      reference's *second, orphaned* EnhancedCustomLoss variant
      (customLoss.py:223-231)
    """
    world = 1 if group is None else dist.get_world_size(group)
    if noise is None:
        b = inputs.shape[0]
        noise = torch.randn((count, b * world, *inputs.shape[1:]),
                            generator=generator, device=inputs.device,
                            dtype=torch.float32)
        if group is not None:
            noise = noise[:, rank_slice(group, b)]
    x = inputs.float()[None]
    if noise_mode == "channel_std":
        if group is None:
            ch_std = torch.std(inputs.float(), dim=(0, 1, 2), correction=1)
        else:
            ch_std = _group_channel_std(inputs.float(), group, world)
        return x + noise * ch_std * std_factor
    if noise_mode == "fixed_eps":
        return torch.clamp(x + noise * std_factor, -10.0, 10.0)  # customLoss.py:231
    raise ValueError(f"unknown noise_mode: {noise_mode}")


def _group_channel_std(x: torch.Tensor, group, world: int) -> torch.Tensor:
    """Per-channel σ (Bessel-corrected) of the group's whole batch, of
    which ``x`` is this rank's shard: two passes, the mean then the squared
    deviations, each all-reduced."""
    n = x.numel() // x.shape[-1] * world
    s = x.sum(dim=(0, 1, 2))
    dist.all_reduce(s, group=group)
    ss = ((x - s / n) ** 2).sum(dim=(0, 1, 2))
    dist.all_reduce(ss, group=group)
    return torch.sqrt(ss / (n - 1))


def perturbation_loss(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                      inputs: torch.Tensor, original_output: torch.Tensor,
                      count: int = 3, std_factor: float = 0.01,
                      noise_mode: str = "channel_std", metric: str = "l1",
                      generator: torch.Generator | None = None,
                      noise: torch.Tensor | None = None,
                      group=None) -> torch.Tensor:
    """Mean drift of the model under small input perturbations.

    ``apply_fn``: x → model output (train-mode semantics, no state updates).
    Gradients flow through ``original_output`` only (pert_loss.py:78-81).
    ``metric``: 'l1' (pert_loss.py:83-90) or 'mse' (the orphaned variant,
    customLoss.py:238)."""
    if metric not in ("l1", "mse"):
        raise ValueError(f"unknown metric: {metric}")
    with torch.no_grad():
        perturbed = perturb_inputs(inputs, count, std_factor, noise_mode,
                                   generator, noise, group)
        outs = torch.stack([apply_fn(xp) for xp in perturbed])  # [p, B, H, W, 1]
    diffs = original_output[None].float() - outs.float()
    if metric == "l1":
        return torch.mean(torch.abs(diffs))
    return torch.mean(diffs ** 2)
