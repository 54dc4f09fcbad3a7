"""K7 ``conv3x3_int8_nhwc``: a single int8 3×3 SAME conv on NHWC with a
per-band dynamic activation scale (port of
``pcss_unet_tpu/ops/pallas/conv3x3_int8.py``; CUDA in
``csrc/conv3x3_int8.cu`` and ``csrc/int8_conv.cuh``).

Per band of ``k_rows`` rows: ``a = max|band and its halo rows| / 127 +
1e-12`` (halo rows outside the frame zero), quantize (half to even, clip
±127), nine int8 taps into int32, ``acc · (a · w_scales) + bias``, an
optional LeakyReLU, ``out_dtype``.  The reference measured this kernel and
kept it out of the model; no model path calls it.  The result depends on
``k_rows``; ``co_tile`` only splits the work.  Both come from the copied
:func:`pick_tiles`.
"""

from __future__ import annotations

import torch

from pcss_unet_tpu_torch.ops.kernels import _build
from pcss_unet_tpu_torch.ops.kernels.block_int8 import (band_conv3x3_int8_plain,
                                                        pack_taps_i8)
from pcss_unet_tpu_torch.ops.kernels.taps import band_copy_shape


def pick_tiles(h: int, w: int, c: int, co: int) -> tuple[int, int] | None:
    """The reference's (k_rows, co_tile) within its TPU VMEM budget (a
    copy), or None."""
    if c % 128 or co % 128:
        return None
    budget = 14 * 1024 * 1024
    for cot in (256, 128):
        if co % cot:
            continue
        for k in (8, 4, 2):
            if h % k or (k * w) % 32:
                continue
            bands = 3 * 2 * k * w * c * 2
            ext = (k + 2) * w * c * 2
            extq = (k + 2) * w * c
            taps = 2 * k * w * c
            wgt = 2 * 9 * c * cot
            acc = k * w * cot * 4
            out = 2 * k * w * cot * 2
            if bands + ext + extq + taps + wgt + acc + out <= budget:
                return k, cot
    return None


def conv3x3_int8_plain(x, wq, w_scales, bias, *, k_rows: int,
                       negative_slope: float | None = None,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of the kernel (integer sums in float64)."""
    n, h, w, c = x.shape
    out = band_conv3x3_int8_plain(x, wq, w_scales, bias, k_rows=k_rows,
                                  c_chunk=c, negative_slope=negative_slope)
    return out.reshape(n, h, w, wq.shape[2]).to(out_dtype)


@_build.on_device
def conv3x3_int8_nhwc(x: torch.Tensor, wq: torch.Tensor,
                      w_scales: torch.Tensor, bias: torch.Tensor, *,
                      k_rows: int = 4, co_tile: int = 256,
                      negative_slope: float | None = None,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x [N,H,W,C] bf16/f32, wq [9,C,Co] int8 (tap dy·3+dx), w_scales
    [Co] f32, bias [Co] f32 → [N,H,W,Co] ``out_dtype``.  Needs C % 128 ==
    0, Co % co_tile == 0 and H % k_rows == 0."""
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, C], got {tuple(x.shape)}")
    n, h, w, c = x.shape
    co = wq.shape[2]
    if (c % 128 or k_rows < 1 or h % k_rows or co_tile < 1 or co % co_tile
            or tuple(wq.shape) != (9, c, co) or wq.dtype != torch.int8
            or w_scales.numel() != co or bias.numel() != co):
        raise ValueError(
            f"bad operands: x {tuple(x.shape)} (C % 128 == 0, H % k_rows == 0,"
            f" k_rows={k_rows}), wq {tuple(wq.shape)} {wq.dtype} "
            f"(Co % co_tile == 0, co_tile={co_tile})")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if x.device.type == "cpu":
        return conv3x3_int8_plain(x, wq, w_scales, bias, k_rows=k_rows,
                                  negative_slope=negative_slope,
                                  out_dtype=out_dtype)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel takes bfloat16 or float32, got {x.dtype}")
    _build.check_device(x, wq, w_scales, bias)
    x = _build.aligned(x)
    wp = pack_taps_i8(wq)
    ws = w_scales.float().reshape(-1).contiguous()
    b = bias.float().reshape(-1).contiguous()
    rowmax = torch.empty(n * h, dtype=torch.float32, device=x.device)
    xq = torch.empty(band_copy_shape(n, h, w, c, k_rows, c),
                     dtype=torch.int8, device=x.device)
    out = torch.empty((n, h, w, co), dtype=out_dtype, device=x.device)
    _build.check_extent(x, out)
    _build.call("pcss_conv3x3_int8_nhwc", x.data_ptr(), wp.data_ptr(),
                ws.data_ptr(), b.data_ptr(), out.data_ptr(), rowmax.data_ptr(),
                xq.data_ptr(), n, h, w, c, co, k_rows, co_tile,
                0.0 if negative_slope is None else float(negative_slope),
                int(negative_slope is not None),
                int(x.dtype == torch.bfloat16),
                int(out_dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    conv3x3_int8_nhwc.launches += 1
    return out


conv3x3_int8_nhwc.launches = 0
