"""VGG-19 feature extractor for the multi-layer perceptual loss (port of
``pcss_unet_tpu/models/vgg.py``).

The reference builds five separate truncated torchvision ``vgg19.features``
towers ending at layer indices (2, 7, 12, 21, 30) and runs each one per loss
evaluation (customLoss.py:20-31, 66-83).  Here, as in the JAX package, the
tower runs once per image with the taps collected in flight (identical
math, ~2.5× fewer FLOPs).

Tap indices follow torchvision's ``features`` indexing (conv outputs,
pre-ReLU, of conv1_2 / conv2_2 / conv3_2 / conv4_2 / conv5_2).

On a row shard of a frame (``rows``, ``parallel/spatial.py``) the convs take
their halo rows from the neighbouring shards and the 2×2 max-pools stay in
the shard (its height a multiple of 2^``pools_before(taps)``).

Weights: ImageNet-pretrained weights load from the same ``.npz`` the JAX
package reads (``scripts/convert_vgg_weights.py``: ``conv_{idx}_kernel``
HWIO, ``conv_{idx}_bias``).  Without one the extractor falls back to fixed
seeded weights drawn with numpy (normal kernels of std √(1/fan_in), zero
biases).  The JAX package's fallback draws its
own numbers with ``jax.random``, so the two fallbacks differ; tests carry
the JAX parameters across instead.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pcss_unet_tpu_torch.parallel.spatial import conv2d_rows

# (torchvision index, out_channels) for every conv in vgg19.features
VGG19_CONVS: tuple[tuple[int, int], ...] = (
    (0, 64), (2, 64),
    (5, 128), (7, 128),
    (10, 256), (12, 256), (14, 256), (16, 256),
    (19, 512), (21, 512), (23, 512), (25, 512),
    (28, 512), (30, 512), (32, 512), (34, 512),
)
# torchvision indices of the max-pools between blocks
VGG19_POOLS = frozenset((4, 9, 18, 27, 36))

DEFAULT_TAPS = (2, 7, 12, 21, 30)      # customLoss.py:8
DEFAULT_TAP_WEIGHTS = (0.25, 0.25, 0.3, 0.1, 0.1)  # customLoss.py:8, normalized at :34-36


def pools_before(taps: Sequence[int]) -> int:
    """The max-pools the tower runs on its way to ``max(taps)``."""
    return sum(1 for i in VGG19_POOLS if i < max(taps))


class VGG19Features(nn.Module):
    """Runs vgg19.features up to ``max(taps)`` and returns the tap outputs.

    Input: [B, 3, H, W] already VGG-normalized, NCHW.  Convs are named
    ``conv_{idx}`` (OIHW weights), the JAX package's names."""

    def __init__(self, taps: Sequence[int] = DEFAULT_TAPS):
        super().__init__()
        self.taps = tuple(taps)
        cin = 3
        for idx, ch in VGG19_CONVS:
            if idx > max(self.taps):
                break
            self.add_module(f"conv_{idx}", nn.Conv2d(cin, ch, 3, padding=1))
            cin = ch

    def iter_taps(self, x: torch.Tensor, rows=None):
        """Yield the tap outputs in tower order (ascending index), so a
        caller can reduce each and let it go before the next.  ``rows``: x
        is this rank's row shard of the frames (``parallel/spatial.py::
        RowShard``)."""
        taps = set(self.taps)
        for idx in range(max(self.taps) + 1):
            conv = getattr(self, f"conv_{idx}", None)
            if conv is not None:
                x = (conv(x) if rows is None else
                     conv2d_rows(x, conv.weight, conv.bias, rows, conv.padding))
            elif idx in VGG19_POOLS:
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(x)          # ReLU slots in torchvision indexing
            if idx in taps:
                yield idx, x

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        outputs = dict(self.iter_taps(x))
        return [outputs[i] for i in self.taps]


def init_vgg_params(taps: Sequence[int] = DEFAULT_TAPS, seed: int = 0) -> dict:
    """Deterministic seeded weights (fallback when no pretrained artifact):
    ``{f"conv_{idx}": {"kernel": HWIO, "bias"}}`` as numpy float32."""
    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for idx, ch in VGG19_CONVS:
        if idx > max(taps):
            break
        std = np.sqrt(1.0 / (9 * cin))
        params[f"conv_{idx}"] = {
            "kernel": (rng.standard_normal((3, 3, cin, ch)) * std).astype(np.float32),
            "bias": np.zeros(ch, np.float32)}
        cin = ch
    return params


def vgg_weights_provenance(path: str | None) -> str:
    """What the perceptual loss will actually run on — recorded in
    resolved_config.json so a training run with random features is
    auditable, not silent."""
    if path and os.path.exists(path):
        return f"pretrained:{path}"
    return "random-seeded-fallback"


def load_vgg_params(path: str | None, taps: Sequence[int] = DEFAULT_TAPS) -> dict:
    """Load converted torchvision weights from .npz; keys
    ``conv_{idx}_kernel`` (HWIO) / ``conv_{idx}_bias``.  Falls back to the
    seeded weights when ``path`` is empty or missing (logged)."""
    if not path or not os.path.exists(path):
        logging.warning(
            "VGG weights artifact %s — perceptual loss will run on "
            "seeded-random features (no ImageNet parity). Produce it on a "
            "machine with torchvision: python scripts/convert_vgg_weights.py "
            "--out vgg19_imagenet.npz, then set vgg_weights_path",
            f"{path} NOT FOUND" if path else "not configured")
        return init_vgg_params(taps=taps)
    params = {}
    with np.load(path) as data:
        for idx, _ in VGG19_CONVS:
            if idx > max(taps):
                break
            params[f"conv_{idx}"] = {
                "kernel": np.asarray(data[f"conv_{idx}_kernel"], np.float32),
                "bias": np.asarray(data[f"conv_{idx}_bias"], np.float32)}
    return params


def vgg_from_params(params: dict, taps: Sequence[int] = DEFAULT_TAPS,
                    device: str | torch.device = "cpu") -> VGG19Features:
    """A frozen ``VGG19Features`` holding ``params`` (HWIO numpy kernels,
    as ``load_vgg_params`` returns them), on ``device``."""
    model = VGG19Features(taps)
    with torch.no_grad():
        for name, p in params.items():
            conv = getattr(model, name)
            conv.weight.copy_(torch.from_numpy(
                np.array(np.transpose(p["kernel"], (3, 2, 0, 1)))))
            conv.bias.copy_(torch.from_numpy(np.array(p["bias"])))
    model.requires_grad_(False)
    return model.eval().to(device)
