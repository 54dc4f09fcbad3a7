"""Feathered tile blending for halo-tiled inference (port of
``pcss_unet_tpu/ops/pallas/blend.py::blend_tiles_device``).

The reference expresses the overlapping scatter-accumulate as a ``lax.scan``
of ``dynamic_update_slice`` adds, not as a Pallas kernel.  Here it is a loop
of slice-adds on the tiles' device: each tile's weighted patch is added in
place into one [H, W, 1] accumulator, in tile order (the scan's order), so
the sums round as the scan's do.
"""

from __future__ import annotations

import torch


def blend_tiles_device(tiles: torch.Tensor, weights: torch.Tensor,
                       offsets, out_hw: tuple[int, int],
                       norm: torch.Tensor | None = None) -> torch.Tensor:
    """tiles [T, t, t, 1] · weights [t, t, 1] scattered at offsets [T, 2]
    (y, x) into a [H, W, 1] frame on the tiles' device, normalized by the
    accumulated weights.

    ``norm``: optional precomputed [H, W, 1] weight field (it depends only
    on host-known geometry — infer_tiled builds it once); when omitted it
    is accumulated in the same loop."""
    h, w = out_hw
    dev = tiles.device
    t = tiles.shape[1]
    wtile = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    acc = torch.zeros((h, w, 1), dtype=torch.float32, device=dev)
    build_norm = norm is None
    nrm = (torch.zeros_like(acc) if build_norm else
           torch.as_tensor(norm, dtype=torch.float32, device=dev))
    for tile, (y, x) in zip(tiles, [tuple(map(int, o)) for o in offsets]):
        acc[y:y + t, x:x + t] += tile.float() * wtile
        if build_norm:
            nrm[y:y + t, x:x + t] += wtile
    return acc / torch.clamp(nrm, min=1e-8)
