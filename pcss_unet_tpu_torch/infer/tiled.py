"""Scaled full-frame inference: spatial sharding and halo-tiled
decomposition (port of ``pcss_unet_tpu/infer/tiled.py``).

The reference has no tiled path at all — ``validate_direct`` is explicitly
non-tiled (main.py:583) and both CLIs are single-frame, single-GPU.

``infer_sharded_halo`` splits a frame's rows over the ``spatial`` axis of a
mesh (``parallel.make_mesh``): each spatial index runs the engine's whole
kernel posture on an aligned window of the frame with a halo of rows
around its own (``InferenceEngine.build_sharded_forward``), on its own
device, and the rows are gathered on the engine's device.  The frame is
padded by reflection to a multiple of n_spatial·align rows, more than the
engine's ×16, so rows near the bottom edge see a longer reflected border
than ``engine(frames)`` gives them: the oracle is the unsharded forward of
the same padded frame.  ``infer_sharded`` takes that path for a kernel
posture and, for a plain engine, runs the windows through the plain graph
(the reference partitions the plain graph with XLA; windows compute the
same plain forward of the same padded frame).

``infer_tiled`` cuts a frame into overlapping ``tile×tile`` tiles with a
``halo`` overlap, runs them through the engine in bounded batches
(``tile_batch``, so peak activation memory is per chunk, not per frame) and
blends the seams back with a separable linear feather (weights sum to 1
everywhere by construction), on the engine's device (``ops/blend.py``) or
on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from pcss_unet_tpu_torch.infer.frame import InferenceEngine
from pcss_unet_tpu_torch.models.unet import spatial_align, spatial_halo
from pcss_unet_tpu_torch.ops.blend import blend_tiles_device


def _sharded(engine: InferenceEngine, frames, mesh, halo: int | None,
             plain: bool) -> np.ndarray:
    frames = np.asarray(frames, np.float32)
    squeeze = frames.ndim == 3
    if squeeze:
        frames = frames[None]
    model = engine.plain_model if plain else engine.sharding_model()
    # shard_h (so every window start) keeps the model's pooling alignment,
    # and W too: window mode has no resize fix-up
    align = max(engine.pad_multiple, spatial_align(model))
    if halo is None:
        halo = spatial_halo(model)
    n_sp = mesh.shape["spatial"]
    n_dp = mesh.shape["data"]
    b, h, w, _ = frames.shape
    ph = (-h) % (align * n_sp)
    pw = (-w) % align
    if ph >= h:
        # too small to split n_sp ways (reflection needs pad < H): the
        # engine's own single-device pad and crop, as the reference does
        out = engine(frames)
        return out[0] if squeeze else out
    if ph or pw:
        frames = np.pad(frames, ((0, 0), (0, ph), (0, pw), (0, 0)),
                        mode="reflect")
    shard_batch = n_dp > 1 and b % n_dp == 0
    fwd = engine.build_sharded_forward(mesh, halo, shard_batch, plain=plain)
    out = fwd(frames).cpu().numpy()[:, :h, :w]
    return out[0] if squeeze else out


def infer_sharded(engine: InferenceEngine, frames: np.ndarray,
                  mesh) -> np.ndarray:
    """Full-frame inference with H over the mesh's 'spatial' axis and the
    batch over 'data' where it divides.  A kernel posture goes to
    ``infer_sharded_halo``; a plain engine runs the windows through its
    plain graph (halo ``spatial_halo``), the plain forward of the same
    padded frame.  Frames [B, H, W, 4] or [H, W, 4] → masks, float32
    numpy."""
    plain = engine.sharding_model() is engine.plain_model
    return _sharded(engine, frames, mesh, None, plain)


def infer_sharded_halo(engine: InferenceEngine, frames: np.ndarray, mesh,
                       halo: int | None = None) -> np.ndarray:
    """Spatially sharded inference that keeps the engine's kernel posture:
    each spatial index runs the kernels on an aligned (shard + 2·halo)-row
    window in window mode and keeps its own rows.  With the default halo,
    ``spatial_halo(model)``, the result is the unsharded forward of the
    same padded frame (where the kernels compute a window as they compute
    the frame).  Frames [B, H, W, 4] or [H, W, 4] → masks, float32
    numpy."""
    return _sharded(engine, frames, mesh, halo, plain=False)


def _feather_weights(tile: int, halo: int, dtype=np.float32) -> np.ndarray:
    """1-D feather: 1 in the interior, linear ramp across the full overlap
    region (2·halo) at each edge, so two adjacent tiles' ramps sum to
    exactly 1 everywhere in their shared strip."""
    w = np.ones(tile, dtype)
    ramp_len = min(2 * halo, tile // 2)
    if ramp_len > 0:
        ramp = (np.arange(1, ramp_len + 1, dtype=dtype)) / (ramp_len + 1)
        w[:ramp_len] = ramp
        w[-ramp_len:] = ramp[::-1]
    return w


def plan_tiles(size: int, tile: int, overlap: int) -> list[int]:
    """Start offsets covering [0, size) with ``overlap`` shared pixels;
    the last tile is right-aligned so every pixel is covered exactly."""
    if tile >= size:
        return [0]
    stride = tile - overlap
    if stride <= 0:
        # stride 0 would crash range(); a negative stride would silently
        # plan only the last tile and blend the rest of the frame to zero
        raise ValueError(f"tile ({tile}) must exceed the overlap "
                         f"({overlap} = 2*halo)")
    starts = list(range(0, size - tile, stride))
    starts.append(size - tile)
    return starts


def infer_tiled(engine: InferenceEngine, frame: np.ndarray,
                tile: int = 512, halo: int = 32,
                blend: str = "auto", tile_batch: int = 16) -> np.ndarray:
    """Single frame [H, W, 4] → mask [H, W, 1] via overlapping tiles.

    Tiles run through the engine in batches of ``tile_batch`` (0 = all at
    once; the last batch is padded with zero tiles to the same size), then
    blend back with feathered weights.  ``blend``: 'device' (the default
    for 'auto': on the engine's device, no host round trip of the
    full-resolution accumulators) or 'host' (numpy)."""
    if blend not in ("auto", "host", "device"):
        raise ValueError(f"unknown blend mode: {blend!r} "
                         "(expected auto | host | device)")
    if 2 * halo >= tile:
        raise ValueError(f"tile ({tile}) must exceed 2*halo ({2 * halo})")
    if tile % engine.pad_multiple:
        # run_padded takes already-aligned frames; an unaligned tile would
        # come back resized and break the blend's shape contract
        raise ValueError(f"tile ({tile}) must be a multiple of the "
                         f"engine's pad_multiple ({engine.pad_multiple})")
    frame = np.asarray(frame, np.float32)
    h, w, c = frame.shape
    pad_h = max(0, tile - h)
    pad_w = max(0, tile - w)
    if pad_h or pad_w:
        frame = np.pad(frame, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect")
    fh, fw, _ = frame.shape
    overlap = 2 * halo
    ys = plan_tiles(fh, tile, overlap)
    xs = plan_tiles(fw, tile, overlap)
    tiles = np.stack([frame[y:y + tile, x:x + tile] for y in ys for x in xs])

    n_tiles = len(tiles)
    tb = n_tiles if tile_batch <= 0 else min(tile_batch, n_tiles)
    pad_t = (-n_tiles) % tb
    if pad_t:   # equal chunks: one forward shape
        tiles = np.concatenate(
            [tiles, np.zeros((pad_t, tile, tile, c), np.float32)])
    chunks = [engine.run_padded(torch.from_numpy(tiles[i:i + tb]))
              for i in range(0, n_tiles + pad_t, tb)]
    outs = (chunks[0] if len(chunks) == 1
            else torch.cat(chunks))[:n_tiles]          # [T, tile, tile, 1]

    # feathered accumulation (weights sum to 1 where tiles overlap exactly
    # `overlap`; frame borders renormalize to 1 via the norm division)
    wy = _feather_weights(tile, halo)
    wx = _feather_weights(tile, halo)
    w2d = np.outer(wy, wx).astype(np.float32)[..., None]  # [tile, tile, 1]
    offsets = np.array([(y, x) for y in ys for x in xs], np.int32)
    # the weight-normalization field depends only on host-known geometry:
    # built once here, not accumulated per tile on the device
    norm = np.zeros((fh, fw, 1), np.float32)
    for y, x in offsets:
        norm[y:y + tile, x:x + tile] += w2d
    if blend == "host":
        acc = np.zeros((fh, fw, 1), np.float32)
        outs_np = outs.float().cpu().numpy()
        for t, (y, x) in enumerate(offsets):
            acc[y:y + tile, x:x + tile] += outs_np[t] * w2d
        out = acc / np.maximum(norm, 1e-8)
    else:
        out = blend_tiles_device(outs, torch.from_numpy(w2d), offsets,
                                 (fh, fw), norm=torch.from_numpy(norm))
        out = out.cpu().numpy()
    return out[:h, :w]
