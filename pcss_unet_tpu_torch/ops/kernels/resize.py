"""The banded resize kernel behind ``ops/resize.py::apply_matrix`` (CUDA in
``csrc/resize.cu``).

It replaces no TPU kernel: the JAX package bands the same products in jnp
(``pcss_unet_tpu/ops/resize.py::banded_apply``).  Every matrix the port
resizes with is banded: an align-corners row has 2 nonzeros in adjacent
columns, the head's folded up-then-down chain 3, their transposes 3–4, and
the channels-major engine's zero-padded chains and the windows' cut
matrices the same or fewer.  So each axis resize is a stencil over at most
``MAX_BAND`` neighbouring inputs, and a dense [out, in] product spends
almost all its work on zeros.

**Band tables** (``band_tables``): for M [out, in], ``start[o]`` (int32),
the first column of row o's band, and ``weight[o, k]`` (float32), M[o,
start[o] + k] after rounding to the working dtype, the reference's cast
point (``m.to(dtype).to(float32)``).  The width is the widest row's span of
nonzeros; an all-zero row (a padded chain's pad outputs) has zero weights.
A matrix wider than ``MAX_BAND`` has no tables (None): on a card
``apply_matrix`` refuses it.

**The kernel**: out[.., o, ..] = round(Σ_k weight[o, k]·float(x[.., start[o]
+ k, ..])), each product and partial sum one float32 rounding, from 0 in
increasing k: ``banded_resize_plain`` exactly.  A float64 tensor (the
parity nets) sums in float64 and rounds each result to float32, the
reference's float32 result type.  It reads x in its own
memory order, as [outer, L, inner] along the axis (no transposing copy),
and writes the output in that order, so a channels-last tensor stays
channels-last.  Against the dense product it differs only in the order of
float32 sums (the dense one adds exact zeros too): within one rounding of
the dtype on finite inputs.  On a NaN or Inf input it confines the
non-finite value to the outputs whose band reads it; the dense product
spreads it along the whole axis (0·Inf).

``banded_resize`` counts its kernel launches in ``.launches``.
``BandedResize`` adds autograd: its backward is the same kernel on the
transposed tables, grad_x = round(Mᵀ·float(grad)), the cast points of the
dense product's backward at a low-precision dtype (at float64 the dense
backward rounds the incoming gradient to float32 where this one rounds
its result: both hold float32's precision), and it saves no activation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from pcss_unet_tpu_torch.ops.kernels import _build

MAX_BAND = 4
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float64: 3}
# how the card kernel walks the tensor (csrc/resize.cu): along inner one
# value a thread, along inner 16 bytes a thread, along the axis (inner == 1)
SCALAR, VECTOR, ROWS = 0, 1, 2


@dataclass(frozen=True, eq=False)
class Bands:
    """One matrix's band tables on a device: ``start`` [out] int32,
    ``weight`` [out, width] float32, and the matrix's input size."""

    start: torch.Tensor
    weight: torch.Tensor
    width: int
    in_size: int

    @property
    def out_size(self) -> int:
        return self.start.shape[0]


def rounded(m: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """float32 ``m`` rounded to ``dtype`` (to nearest, ties to even, as
    torch's casts), as float32.  numpy alone, so that it runs while
    ``torch.export`` traces (a traced tensor has no ``.numpy()``)."""
    m = np.ascontiguousarray(m, np.float32)
    if dtype == torch.bfloat16:
        u = m.view(np.uint32).astype(np.uint64)
        u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
        return u.astype(np.uint32).view(np.float32)
    if dtype == torch.float16:
        return m.astype(np.float16).astype(np.float32)
    return m


def band_tables(m: np.ndarray, dtype: torch.dtype
                ) -> tuple[np.ndarray, np.ndarray] | None:
    """(start [out] int32, weight [out, width] float32) of ``m`` [out, in]
    rounded to ``dtype``, or None where a row's nonzeros span more than
    ``MAX_BAND`` columns.  A row's band starts at its first nonzero, moved
    left where it would run past the last column; an all-zero row takes the
    previous row's start (0 at the top), so that the starts of a banded
    matrix keep their order."""
    mr = rounded(m, dtype)
    n_out, n_in = mr.shape
    nz = mr != 0
    live = nz.any(axis=1)
    first = nz.argmax(axis=1)
    last = n_in - 1 - nz[:, ::-1].argmax(axis=1)
    width = int(max(1, (last - first + 1)[live].max(initial=1)))
    if width > MAX_BAND:
        return None
    # all-zero rows: carry the last live row's start forward
    idx = np.maximum.accumulate(np.where(live, np.arange(n_out), -1))
    start = np.where(idx >= 0, first[np.maximum(idx, 0)], 0)
    start = np.minimum(start, n_in - width).astype(np.int32)
    weight = mr[np.arange(n_out)[:, None], start[:, None] + np.arange(width)]
    return start, np.ascontiguousarray(weight, np.float32)


def dense_of(start: np.ndarray, weight: np.ndarray, in_size: int) -> np.ndarray:
    """The [out, in] matrix that band tables describe."""
    m = np.zeros((start.shape[0], in_size), np.float32)
    rows = np.arange(start.shape[0])[:, None]
    m[rows, start[:, None] + np.arange(weight.shape[1])] = weight
    return m


def bands_on(m: np.ndarray, dtype: torch.dtype,
             device: torch.device) -> Bands | None:
    """``band_tables(m, dtype)`` as tensors on ``device`` (a copy from the
    host: callers cache the result, ``ops/resize.py::Matrix.bands``)."""
    tables = band_tables(m, dtype)
    if tables is None:
        return None
    start, weight = tables
    return Bands(torch.as_tensor(start, device=device),
                 torch.as_tensor(weight, device=device), weight.shape[1],
                 m.shape[1])


def _check(x: torch.Tensor, bands: Bands, axis: int) -> None:
    if x.shape[axis] != bands.in_size:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} is not the "
                         f"matrix's input size {bands.in_size}")
    if x.dtype not in DTYPES:
        raise ValueError(f"the kernel takes {list(DTYPES)}, got {x.dtype}")


def banded_resize_plain(x: torch.Tensor, bands: Bands,
                        axis: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: Σ_k weight[:, k]·x along
    ``axis`` at start + k, in float32 (float64 for float64 x) from 0 in
    increasing k, rounded once to x's dtype (to float32 for float64 x).
    Index selects and sums only, so ``torch.export`` traces it."""
    axis %= x.dim()
    _check(x, bands, axis)
    acc_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc_dtype)
    view = [1] * x.dim()
    view[axis] = bands.out_size
    start = bands.start.to(x.device).long()
    weight = bands.weight.to(x.device, acc_dtype)
    shape = list(x.shape)
    shape[axis] = bands.out_size
    acc = torch.zeros(shape, dtype=acc_dtype, device=x.device)
    for k in range(bands.width):
        acc = acc + weight[:, k].reshape(view) * xf.index_select(axis, start + k)
    return acc.float().to(x.dtype)


def memory_order(x: torch.Tensor) -> list[int] | None:
    """x's dims from outermost to innermost in memory, or None where x is
    not dense (not a permutation of a contiguous tensor).  Dims of size 1
    may sit anywhere."""
    order = sorted(range(x.dim()), key=lambda d: (x.stride(d), x.shape[d]),
                   reverse=True)
    expect = 1
    for d in reversed(order):
        if x.shape[d] != 1 and x.stride(d) != expect:
            return None
        expect *= x.shape[d]
    return order


def plan(x: torch.Tensor, axis: int, out_size: int
         ) -> tuple[torch.Tensor, torch.Tensor, tuple[int, int, int, int], int]:
    """→ (x, out, (outer, in, out, inner), mode): x as the kernel reads it
    (a contiguous copy only where x is not dense), the output allocated in
    x's memory order, the [outer, L, inner] sizes and the kernel's mode."""
    order = memory_order(x)
    if order is None:
        x, order = x.contiguous(), list(range(x.dim()))
    pos = order.index(axis)
    outer = math.prod(x.shape[d] for d in order[:pos])
    inner = math.prod(x.shape[d] for d in order[pos + 1:])
    shape = list(x.shape)
    shape[axis] = out_size
    out = torch.empty([shape[d] for d in order], dtype=x.dtype,
                      device=x.device).permute(*np.argsort(order).tolist())
    vec = 16 // x.element_size()
    if inner == 1:
        mode = ROWS
    elif inner % vec == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0:
        mode = VECTOR
    else:
        mode = SCALAR
    return x, out, (outer, x.shape[axis], out_size, inner), mode


@_build.on_device
def banded_resize(x: torch.Tensor, bands: Bands, axis: int) -> torch.Tensor:
    """out[.., o, ..] = Σ_k weight[o, k]·x[.., start[o] + k, ..] along
    ``axis``, float32 sums rounded to x's dtype (float32, bfloat16 or
    float16; float64 sums rounded to float32 for float64), in x's memory
    order.  The plain version on a CPU tensor."""
    axis %= x.dim()
    if x.device.type == "cpu":
        return banded_resize_plain(x, bands, axis)
    _check(x, bands, axis)
    _build.check_device(x, bands.start, bands.weight)
    out = _launch(x, bands, axis, torch.cuda.current_stream(x.device).cuda_stream)
    if out.numel():
        banded_resize.launches += 1
    return out


def _launch(x: torch.Tensor, bands: Bands, axis: int, stream) -> torch.Tensor:
    """The C entry on x as ``plan`` lays it out (none for an empty
    output); → the output."""
    x, out, sizes, mode = plan(x, axis, bands.out_size)
    _build.check_extent(x, out)
    if out.numel():
        _build.call("pcss_band_resize", x.data_ptr(), out.data_ptr(),
                    bands.start.data_ptr(), bands.weight.data_ptr(), *sizes,
                    bands.width, DTYPES[x.dtype], mode, stream)
    return out


banded_resize.launches = 0


class BandedResize(torch.autograd.Function):
    """``banded_resize`` with its gradient: ``apply(x, fwd, bwd, axis)``
    runs the kernel on ``fwd``, and its backward on ``bwd``, the transposed
    matrix's tables (whose own gradient is the forward's)."""

    @staticmethod
    def forward(ctx, x, fwd: Bands, bwd: Bands, axis: int):
        ctx.tables, ctx.axis = (bwd, fwd), axis
        return banded_resize(x, fwd, axis)

    @staticmethod
    def backward(ctx, grad):
        bwd, fwd = ctx.tables
        return BandedResize.apply(grad, bwd, fwd, ctx.axis), None, None, None
