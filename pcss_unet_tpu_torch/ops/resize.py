"""Bilinear resize with ``align_corners=True`` semantics, as matrix
contractions (port of ``pcss_unet_tpu/ops/resize.py``).

Each axis resize is a product with a host-built interpolation matrix
(``interp_matrix``: two nonzeros per row), and chains of resizes fold into
one matrix per axis (``compose_resize_matrices``).  The JAX package bands
these products to save TPU matrix-unit work (``banded_apply``); that is
exact against the dense product, so the port keeps the dense one.

Numerics follow the reference: at a low-precision working dtype the matrix
is cast to that dtype first, the product accumulates in float32 and the
result is cast back; at float32 the product runs at full float32 precision;
at float64 it accumulates in float64 and the result is rounded to float32.

Public layout is NHWC (axes 1 and 2), like the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] align-corners interpolation matrix: row i has (1−f) at
    ⌊c⌋ and f at ⌊c⌋+1 for c = i·(in−1)/(out−1).  float32."""
    m = np.zeros((out_size, in_size), np.float32)
    if out_size == 1:
        m[0, 0] = 1.0
        return m
    coords = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.clip(np.floor(coords), 0, in_size - 1).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    f = (coords - lo).astype(np.float32)
    rows = np.arange(out_size)
    np.add.at(m, (rows, lo), 1.0 - f)
    np.add.at(m, (rows, hi), f)
    return m


@functools.lru_cache(maxsize=256)
def resize_chain(sizes: tuple[int, ...]) -> np.ndarray:
    """One axis's chain of align-corners resizes folded into one matrix:
    ``(544, 1088, 544)`` means 544→1088→544 (exact: a composition of linear
    maps).  Cached by the sizes: the fold is a host matmul."""
    m = None
    for a, b in zip(sizes[:-1], sizes[1:]):
        step = interp_matrix(a, b)
        m = step if m is None else step @ m
    return np.eye(sizes[0], dtype=np.float32) if m is None else m


def compose_resize_matrices(sizes_h: tuple[int, ...],
                            sizes_w: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """Fold a chain of align-corners resizes into one matrix per axis
    (``resize_chain`` of each)."""
    return resize_chain(tuple(sizes_h)), resize_chain(tuple(sizes_w))


@functools.lru_cache(maxsize=256)
def _matrix_cached(device: torch.device, build, args: tuple) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode, so a
    # later training forward in the process can save it for backward
    with torch.inference_mode(False):
        return torch.as_tensor(build(*args), device=device)


def matrix_on(device: torch.device, build, *args) -> torch.Tensor:
    """``build(*args)``, a host matrix that depends on its (hashable)
    arguments alone, as a tensor on ``device``: copied to a card once per
    arguments, because a copy from pageable host memory makes the host wait
    for the device, and a forward that copied its matrices on every call
    would wait on every one.  Not cached on the CPU (the tensor shares the
    host array) nor while tracing (``torch.export``: the traced constant is
    not a real tensor)."""
    if device.type == "cpu" or torch.compiler.is_compiling():
        return torch.as_tensor(build(*args), device=device)
    return _matrix_cached(device, build, args)


def apply_matrix(x: torch.Tensor, m: np.ndarray | torch.Tensor,
                 axis: int) -> torch.Tensor:
    """out[..., o, ...] = Σ_i m[o, i]·x[..., i, ...] along ``axis``, with the
    reference's cast points: the matrix in x's dtype, float32 accumulation,
    the result back in x's dtype.  ``m`` is a host array or a tensor on x's
    device (``matrix_on``)."""
    dtype = x.dtype
    # float64 (the training-parity nets) accumulates in float64 and rounds
    # the product to float32, as the reference's float32 result type does
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    mt = torch.as_tensor(m, device=x.device).to(dtype).to(acc)
    xa = x.to(acc)
    axis %= x.dim()
    if axis == x.dim() - 1:
        out = torch.matmul(xa, mt.T)
    elif axis == x.dim() - 2:
        out = torch.matmul(mt, xa)
    else:
        out = torch.movedim(torch.matmul(torch.movedim(xa, axis, -1),
                                         mt.T), -1, axis)
    return out.float().to(dtype)


def _is_identity(m: np.ndarray) -> bool:
    return m.shape[0] == m.shape[1] and np.array_equal(
        m, np.eye(m.shape[0], dtype=m.dtype))


def resize_with_matrices(x: torch.Tensor, m_h: np.ndarray | None,
                         m_w: np.ndarray | None) -> torch.Tensor:
    """Apply per-axis interpolation matrices to NHWC ``x`` (identity
    matrices are skipped, as in the reference)."""
    if m_h is not None and not _is_identity(m_h):
        x = apply_matrix(x, m_h, 1)
    if m_w is not None and not _is_identity(m_w):
        x = apply_matrix(x, m_w, 2)
    return x


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: tuple[int, int]) -> torch.Tensor:
    """Resize NHWC ``x`` to ``out_hw`` with align-corners bilinear
    (``F.interpolate(..., mode='bilinear', align_corners=True)``)."""
    out_h, out_w = out_hw
    _, h, w, _ = x.shape
    if h != out_h:
        x = apply_matrix(x, matrix_on(x.device, interp_matrix, h, out_h), 1)
    if w != out_w:
        x = apply_matrix(x, matrix_on(x.device, interp_matrix, w, out_w), 2)
    return x


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)``
    on NHWC ``x``."""
    _, h, w, _ = x.shape
    return resize_bilinear_align_corners(x, (h * 2, w * 2))


# Window-consistent resizes for spatially sharded inference: align-corners
# coefficients depend on the global image height, so a window's own resize
# is not a crop of the whole frame's.  These take the window's rows of the
# global matrix (cut on the host, the offsets being Python ints, and kept
# on the device by ``matrix_on``).  Output rows within the matrix band (≤ 2
# rows) of the window's edges lose what lies outside it; callers crop a
# margin of at least the network's receptive-field halo, which covers it.

@functools.lru_cache(maxsize=256)
def _window_of(build, args: tuple, rows: tuple[int, int],
               cols: tuple[int, int]) -> np.ndarray:
    return np.ascontiguousarray(build(*args)[rows[0]:rows[1], cols[0]:cols[1]])


def upsample2x_window(x: torch.Tensor, global_h: int, row_off: int,
                      axes: tuple[int, int] = (1, 2)) -> torch.Tensor:
    """Rows [2·row_off, 2·row_off + 2h) of the global align-corners 2×
    upsample of a ``global_h``-row image, from ``x``'s rows [row_off,
    row_off + h); the W axis is whole (the full W matrix).  ``axes``: the
    (H, W) axes, NHWC's by default."""
    ah, aw = axes
    h, w = x.shape[ah], x.shape[aw]
    m_h = matrix_on(x.device, _window_of, interp_matrix, (global_h, 2 * global_h),
                    (2 * row_off, 2 * row_off + 2 * h), (row_off, row_off + h))
    x = apply_matrix(x, m_h, ah)
    return apply_matrix(x, matrix_on(x.device, interp_matrix, w, 2 * w), aw)


def resize_rows_window(x: torch.Tensor, sizes_h: tuple[int, ...],
                       sizes_w: tuple[int, ...], out_off: int, in_off: int,
                       axes: tuple[int, int] = (1, 2)) -> torch.Tensor:
    """Apply a global square row-resize matrix to a window of ``x``: rows
    [out_off, out_off + h) × columns [in_off, in_off + h) of
    ``resize_chain(sizes_h)`` (the global matrix), then the whole
    ``resize_chain(sizes_w)`` (skipped where it is the identity).
    ``axes``: the (H, W) axes, NHWC's by default."""
    ah, aw = axes
    h = x.shape[ah]
    m_h = matrix_on(x.device, _window_of, resize_chain, (tuple(sizes_h),),
                    (out_off, out_off + h), (in_off, in_off + h))
    x = apply_matrix(x, m_h, ah)
    if not _is_identity(resize_chain(tuple(sizes_w))):
        x = apply_matrix(x, matrix_on(x.device, resize_chain, tuple(sizes_w)), aw)
    return x
