"""Multi-layer VGG-19 perceptual loss (port of ``pcss_unet_tpu/losses/vgg.py``).

Reference ``MultiLayerVGGLoss`` (customLoss.py:7-90): clamp both images to
[0,1], scrub non-finite values (nan→0.5, +inf→1, −inf→0), repeat the
grayscale mask to 3 channels, normalize with mean 0.485 / std 0.229 (+1e-8),
take L1 between VGG-19 features at torchvision indices (2,7,12,21,30), and
blend with weights (0.25,0.25,0.3,0.1,0.1) normalized to sum 1.

One shared tower with in-flight taps (``models/vgg.py``), run on output and
target together, a few images at a time (``CHUNK_PIXELS``), each tap
reduced to its L1 sum as it comes out: at 2048×1024 the tower's full-
resolution float32 features are 0.5 GB an image, and holding every tap of
a batch of 8 for both images would take ~15 GB.  The reference
computes its features under ``no_grad`` and re-wraps the result, so its VGG
term is **gradient-dead** (customLoss.py:69-71, 90): training gradients come
from L1 alone.  ``grad=False`` (default) reproduces that by running the
towers under ``torch.no_grad()``, the port's ``stop_gradient``, which also
keeps the towers' activations out of memory; ``grad=True`` enables real
perceptual gradients.

On a row shard (``rows``) the tower runs on the shard's rows with halos
from its neighbours; every shard's taps have the same element counts, so
the mean of the shards' losses is the frame's.
"""

from __future__ import annotations

from typing import Sequence

import torch

from pcss_unet_tpu_torch.models.vgg import (DEFAULT_TAP_WEIGHTS, DEFAULT_TAPS,
                                           load_vgg_params, vgg_from_params)
from pcss_unet_tpu_torch.utils.profiling import span

VGG_MEAN = 0.485   # customLoss.py:39
VGG_STD = 0.229    # customLoss.py:40
CHUNK_PIXELS = 1 << 22   # pixels per image per tower run: 2 images of 2048×1024


def _scrub(x: torch.Tensor) -> torch.Tensor:
    # customLoss.py:48-52 semantics
    x = torch.nan_to_num(x.float(), nan=0.5, posinf=1.0, neginf=0.0)
    return torch.clamp(x, 0.0, 1.0)


class PerceptualLoss:
    """Callable ``(output, target) -> scalar`` over NHWC single-channel
    images.  Holds the frozen VGG tower (``params``: HWIO numpy kernels as
    ``load_vgg_params`` returns them, or None to load ``weights_path``)."""

    def __init__(self, weights_path: str | None = None,
                 taps: Sequence[int] = DEFAULT_TAPS,
                 tap_weights: Sequence[float] = DEFAULT_TAP_WEIGHTS,
                 grad: bool = False, params: dict | None = None,
                 device: str | torch.device = "cpu"):
        if params is None:
            params = load_vgg_params(weights_path, taps=tuple(taps))
        self.model = vgg_from_params(params, tuple(taps), device)
        w = torch.tensor(tap_weights, dtype=torch.float32)
        # customLoss.py:34-36, in the tower's (ascending) tap order
        by_tap = dict(zip(taps, (w / w.sum()).tolist()))
        self.tap_weights = [by_tap[i] for i in sorted(by_tap)]
        self.grad = grad

    def _loss(self, output: torch.Tensor, target: torch.Tensor,
              rows=None) -> torch.Tensor:
        out, tgt = _scrub(output), _scrub(target)
        n, h, w = out.shape[:3]
        per = max(1, CHUNK_PIXELS // (h * w))     # images per tower run
        sums = [0.0] * len(self.tap_weights)
        counts = [0] * len(self.tap_weights)
        for i in range(0, n, per):
            both = torch.cat([out[i:i + per], tgt[i:i + per]])
            k = both.shape[0] // 2
            img3 = both.permute(0, 3, 1, 2).repeat(1, 3, 1, 1)  # gray → 3ch
            norm = (img3 - VGG_MEAN) / (VGG_STD + 1e-8)
            taps = self.model.iter_taps(norm.to(self.model.conv_0.weight.dtype),
                                        rows)
            for j, (_, f) in enumerate(taps):
                f = torch.nan_to_num(f.float(), nan=0.0, posinf=1.0, neginf=-1.0)
                sums[j] = sums[j] + torch.sum(torch.abs(f[:k] - f[k:]))
                counts[j] += f[:k].numel()
        total = torch.zeros((), dtype=torch.float32, device=output.device)
        for wt, s, c in zip(self.tap_weights, sums, counts):
            total = total + wt * (s / c)
        return total

    def __call__(self, output: torch.Tensor, target: torch.Tensor,
                 rows=None) -> torch.Tensor:
        """``rows``: output and target are this rank's row shards
        (``parallel/spatial.py::RowShard``)."""
        with span("loss.vgg"):
            if self.grad:
                return self._loss(output, target, rows)
            # reference's gradient-dead VGG branch (customLoss.py:69-71, 90)
            with torch.no_grad():
                return self._loss(output, target, rows)
