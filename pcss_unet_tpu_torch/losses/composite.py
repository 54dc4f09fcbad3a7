"""Composite training losses (port of ``pcss_unet_tpu/losses/composite.py``).

- ``standard_loss`` ≡ reference ``CustomLoss`` (customLoss.py:92-193):
  α·L1 + (1−α)·VGG, α=0.9, plus the three terms the reference computes and
  discards (high-freq / penumbra / Sobel) and 1−SSIM, config-gated with
  default weight 0 for parity.
- ``enhanced_loss`` ≡ reference ``EnhancedCustomLoss`` (pert_loss.py:92-167):
  standard blend + perturb_weight·perturbation, returning a components
  dict.  (In the reference this path crashes at construction — it imports
  a nonexistent ``VGGLoss``, pert_loss.py:111; the JAX package rebuilt it
  from the documented semantics, and this is that.)

Both take pre-computed model outputs; every term is a float32 scalar
tensor."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from pcss_unet_tpu_torch.losses.extras import (high_freq_loss,
                                               penumbra_weighted_l1,
                                               sobel_gradient_loss)
from pcss_unet_tpu_torch.losses.perturbation import perturbation_loss
from pcss_unet_tpu_torch.losses.ssim import ssim_loss
from pcss_unet_tpu_torch.losses.vgg import PerceptualLoss


@dataclass
class LossBundle:
    """Bound loss configuration: perceptual net + blend weights."""

    perceptual: PerceptualLoss
    alpha: float = 0.9                  # config.ini:32
    perturb_weight: float = 0.1         # config.ini:13
    perturbation_count: int = 3         # config.ini:12
    high_freq_weight: float = 0.0
    penumbra_weight: float = 0.0
    sobel_weight: float = 0.0
    ssim_weight: float = 0.0

    def base_terms(self, output: torch.Tensor, target: torch.Tensor,
                   group=None) -> dict:
        """The loss terms; every one is a mean over the batch (so the mean
        over a process group's equal shards is the whole batch's) except the
        penumbra ratio, which takes ``group`` itself."""
        output = output.float()
        target = target.float()
        terms = {
            "l1_loss": torch.mean(torch.abs(output - target)),
            "vgg_loss": self.perceptual(output, target),
        }
        if self.high_freq_weight:
            terms["high_freq_loss"] = high_freq_loss(output, target)
        if self.penumbra_weight:
            terms["penumbra_loss"] = penumbra_weighted_l1(output, target,
                                                          group=group)
        if self.sobel_weight:
            terms["sobel_loss"] = sobel_gradient_loss(output, target)
        if self.ssim_weight:
            terms["ssim_loss"] = ssim_loss(output, target)
        return terms

    def _blend(self, terms: dict) -> torch.Tensor:
        total = (self.alpha * terms["l1_loss"]
                 + (1.0 - self.alpha) * terms["vgg_loss"])
        total = total + self.high_freq_weight * terms.get("high_freq_loss", 0.0)
        total = total + self.penumbra_weight * terms.get("penumbra_loss", 0.0)
        total = total + self.sobel_weight * terms.get("sobel_loss", 0.0)
        total = total + self.ssim_weight * terms.get("ssim_loss", 0.0)
        return total


def standard_loss(bundle: LossBundle, output: torch.Tensor,
                  target: torch.Tensor, group=None) -> tuple[torch.Tensor, dict]:
    """α·L1 + (1−α)·VGG (+ gated extras).  → (total, components).
    ``group``: this rank's shard of a process group's batch."""
    terms = bundle.base_terms(output, target, group)
    total = bundle._blend(terms)
    terms["total_loss"] = total
    return total, terms


def enhanced_loss(bundle: LossBundle, apply_fn: Callable,
                  inputs: torch.Tensor, output: torch.Tensor,
                  target: torch.Tensor, training: bool = True,
                  generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None,
                  group=None) -> tuple[torch.Tensor, dict]:
    """standard blend + perturb_weight·perturbation (pert_loss.py:117-167).
    The perturbation term is skipped outside training or at weight 0,
    mirroring pert_loss.py:149.  ``generator`` / ``noise``: the
    perturbation's noise source (``perturbation_loss``); ``group``: this
    rank's shard of a process group's batch."""
    terms = bundle.base_terms(output, target, group)
    total = bundle._blend(terms)
    if training and bundle.perturb_weight > 0:
        pert = perturbation_loss(apply_fn, inputs, output,
                                 count=bundle.perturbation_count,
                                 generator=generator, noise=noise,
                                 group=group)
        total = total + bundle.perturb_weight * pert
        terms["perturbation_loss"] = pert
    else:
        terms["perturbation_loss"] = torch.zeros((), device=output.device)
    terms["total_loss"] = total
    return total, terms
