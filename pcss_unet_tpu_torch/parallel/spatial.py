"""Row-sharded training: the partitioner's rules, written out (the JAX
package leaves them to XLA: ``pcss_unet_tpu/train/step.py`` jitted with the
batch sharded ``P('data', 'spatial')``).

Each of the S ranks of a data index holds rows [s·h, (s+1)·h) of every
frame of its samples, h = H / S at input resolution, and the same share of
every level below it (the shards are aligned, ``check_row_split``, so a
pool or a pixel-unshuffle stays inside its shard and a level's global
height is its shard's height times S).  What reaches across a shard's edge
takes the rows it needs from its neighbours (``utils/distributed.py::
halo_exchange``, forward and backward):

- ``conv2d_rows``: a convolution exchanges its vertical padding
  (``dilation`` rows for a 3×3), then convolves with no padding on H;
- ``rows_matrix``: a global resize matrix (align-corners, the head's folded
  chain) on this shard's output rows, from its input rows and the halo the
  matrix reaches (``ops/resize.py::shard_halo``, the window's columns taken
  with zeros beyond the frame);
- ``upsample2x_rows``: the decoder's 2× upsample, the frame's coefficients.

What is local stays as it is: 1×1 convs, pools, pointwise work.  BatchNorm
and the loss terms that are not equal-size means take their sums over the
whole grid (``models/unet.py::batch_norm_train``, ``losses/``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from pcss_unet_tpu_torch.ops.resize import (_window_of, apply_matrix,
                                            interp_matrix, matrix_on,
                                            resize_chain, shard_halo)
from pcss_unet_tpu_torch.utils.distributed import (grid_coords, halo_exchange,
                                                   spatial_group)


@dataclass(frozen=True)
class RowShard:
    """This rank's place in the row split: shard ``index`` of ``count``,
    its halos exchanged over ``group`` (the ranks of its data index)."""

    group: object
    index: int
    count: int


def row_shard(group, spatial: int) -> RowShard | None:
    """The row split of ``group``, a (data × ``spatial``) grid of ranks
    (``utils/distributed.py``), or None for ``spatial == 1``.  Where the grid
    has more than one data index, every process of the default group calls
    this (``spatial_group`` creates a group per data index)."""
    if spatial == 1:
        return None
    if group is None:
        raise ValueError(f"spatial_parallel={spatial} needs a process group "
                         "of data_parallel × spatial_parallel ranks")
    sub = spatial_group(group, spatial)
    return RowShard(sub, grid_coords(group, spatial)[1], spatial)


def conv2d_rows(x: torch.Tensor, weight: torch.Tensor, bias, rows: RowShard,
                padding: tuple[int, int], dilation=1) -> torch.Tensor:
    """``F.conv2d(x, weight, bias, padding=padding, dilation=dilation)`` of
    the whole frame, on this shard's rows of NCHW ``x``: the vertical
    padding's rows come from the neighbours (zeros beyond the frame)."""
    x = halo_exchange(x, padding[0], padding[0], rows, dim=2)
    return F.conv2d(x, weight, bias, padding=(0, padding[1]), dilation=dilation)


def rows_matrix(x: torch.Tensor, build, args: tuple, rows: RowShard,
                axis: int) -> torch.Tensor:
    """This shard's output rows of ``apply_matrix(frame, build(*args),
    axis)``: the global matrix's rows of this shard, on its input rows and
    the halo the matrix reaches (the same on every shard)."""
    m = build(*args)
    hi, ho = x.shape[axis], m.shape[0] // rows.count
    if m.shape[1] != hi * rows.count:
        raise ValueError(f"a {m.shape[1]}-row matrix input on {rows.count} "
                         f"shards of {hi} rows")
    above, below = shard_halo(build, args, rows.count)
    s = rows.index
    w = matrix_on(x.device, _window_of, build, args, (s * ho, (s + 1) * ho),
                  (s * hi - above, (s + 1) * hi + below))
    return apply_matrix(halo_exchange(x, above, below, rows, dim=axis), w, axis)


def upsample2x_rows(x: torch.Tensor, rows: RowShard) -> torch.Tensor:
    """The align-corners 2× upsample of the whole frame on this shard's
    rows of NCHW ``x``: the frame's coefficients on H (one halo row each
    side), the whole W matrix."""
    g, w = x.shape[2] * rows.count, x.shape[3]
    x = rows_matrix(x, interp_matrix, (g, 2 * g), rows, 2)
    return apply_matrix(x, matrix_on(x.device, interp_matrix, w, 2 * w), 3)


def check_row_split(frame_h: int, count: int, depth: int, *,
                    apply_dilation: bool = False, vgg_pools: int = 0,
                    ssim: bool = False) -> int:
    """Refuse a row split that the sharded ops do not compute exactly:
    ``frame_h`` rows over ``count`` shards must give each a multiple of the
    row alignment, max(2^depth, 2^vgg_pools) (a U-Net of ``depth`` levels:
    the pixel-unshuffle, depth − 1 pools and the frame's resize
    coefficients at every level; the VGG tower's ``vgg_pools`` max-pools,
    ``models/vgg.py::pools_before``), and every halo must fit in the
    neighbouring shard (the dilated encoders' 2^i rows at level i, the
    head's resize, SSIM's 10 rows where ``ssim``).  → the shard's height.
    (The JAX package's partitioner shards any height; ROADMAP Queue 3.)"""
    align = max(2 ** depth, 2 ** vgg_pools)
    h, rem = divmod(frame_h, count)
    if rem or h % align:
        raise ValueError(
            f"spatial_parallel={count}: a {frame_h}-row frame gives shards of "
            f"{frame_h / count:g} rows, not a multiple of the row alignment "
            f"{align} (max(2^depth, 2^VGG pools) = max({2 ** depth}, "
            f"{2 ** vgg_pools}))")
    need = {"SSIM's 11-row window": (10, h)} if ssim else {}
    if apply_dilation:
        for i in range(depth - 1):
            need[f"encoder level {i}'s dilation"] = (2 ** i, h // 2 ** (i + 1))
    g = frame_h // 2
    need["the head's resize"] = (max(shard_halo(resize_chain, ((g, 2 * g, g),),
                                                count)), h // 2)
    for what, (halo, rows) in need.items():
        if halo > rows:
            raise ValueError(f"spatial_parallel={count}: {what} needs {halo} "
                             f"rows of the neighbouring shard, which has {rows}")
    return h


def check_config_rows(cfg, frame_h: int, nets=()) -> int:
    """``check_row_split`` for training ``cfg`` on frames of ``frame_h``
    rows over ``cfg.spatial_parallel`` shards: for every U-Net that runs on
    the shards, the VGG tower's pools to its default taps (the loss's,
    ``train/loop.py::make_bundle``) and SSIM where ``cfg.ssim_weight``.
    The U-Nets are ``nets`` where they are built (the student, the
    distillation teacher: its checkpoint sets its depth), else the
    config's: ``model_depth`` and, with a ``distill_teacher``,
    ``distill_teacher_depth``.  → the shard's height."""
    from pcss_unet_tpu_torch.models.vgg import DEFAULT_TAPS, pools_before

    shapes = [(len(n.encoder_widths), n.apply_dilation) for n in nets
              if n is not None]
    if not shapes:
        shapes = [(cfg.model_depth, cfg.apply_dilation)]
        if cfg.distill_teacher:
            shapes.append((cfg.distill_teacher_depth, cfg.apply_dilation))
    for i, (depth, dilation) in enumerate(shapes):
        try:
            h = check_row_split(frame_h, cfg.spatial_parallel, depth,
                                apply_dilation=dilation,
                                vgg_pools=pools_before(DEFAULT_TAPS),
                                ssim=bool(cfg.ssim_weight))
        except ValueError as e:
            net = "the distillation teacher" if i else "the model"
            raise ValueError(f"{e} ({net}: depth {depth})") from None
    return h
