"""K3 ``fused_block_int8_nhwc`` and K5 ``fused_block_int8_kchunked``: a
whole folded ConvBlock in int8 on NHWC (port of
``pcss_unet_tpu/ops/pallas/block_int8.py``; CUDA in ``csrc/block_int8.cu``
and ``csrc/int8_conv.cuh``).

Per band of ``k_rows`` rows: a dynamic activation scale over the band and
its halo rows, an int8 3×3 through the shared tap contraction (int32 sums),
dequantize, bias, LeakyReLU; a second scale over the band's hidden values,
an int8 1×1, dequantize, bias, LeakyReLU.  K3 rounds the hidden value to
bf16 before its scale.  K5, the reference's kernel for the 1024-channel
``dec_0`` whose 3×3 weights do not fit its TPU's VMEM, splits the 3×3
contraction into ``c_chunk``-channel chunks, each with its own scale, sums
their dequantized parts in float32 in chunk order, and keeps the hidden
value in float32.  The results depend on the band height (and chunk), so
callers pick them with the copied :func:`pick_k_rows_int8` /
:func:`pick_kchunked`, which return what the reference picks.
"""

from __future__ import annotations

import numpy as np
import torch

from pcss_unet_tpu_torch.ops.kernels import _build
from pcss_unet_tpu_torch.ops.kernels.taps import (band_copy_shape, band_rows,
                                                  band_scale,
                                                  conv3x3_band_taps, quant_i8,
                                                  quantize_bands_plain)


def pick_k_rows_int8(h: int, w: int, c: int, cout: int) -> int | None:
    """The reference's band height for the whole-block int8 kernel (a copy of
    its TPU VMEM-budget picker: the port must band exactly as it does), or
    None if the shape doesn't meet its constraints."""
    if c % 128 or cout % 64:
        return None
    budget = 14 * 1024 * 1024
    wgt = 9 * c * c + c * cout
    if wgt > 5 * 1024 * 1024:
        return None
    for k in (8, 4, 2):
        if h % k or (k * w) % 32:
            continue
        band = 2 * k * w * c * 2
        halo = 2 * 2 * w * c * 2
        extq = (k + 2) * w * c
        taps = 2 * k * w * c
        acc = k * w * c * 4
        hbuf = k * w * c * 2
        hq = k * w * c
        acc2 = k * w * cout * 4
        out = 2 * k * w * cout * 2
        if (band + halo + extq + taps + acc + hbuf + hq + acc2 + out
                + wgt <= budget):
            return k
    return None


def pick_kchunked(h: int, w: int, c: int, cout: int) -> tuple[int, int] | None:
    """The reference's (k_rows, c_chunk) for its contraction-chunked int8
    kernel (a copy), or None."""
    if c % 256 or cout % 64:
        return None
    budget = 14 * 1024 * 1024
    for cchunk in (256, 128):
        if c % cchunk:
            continue
        for k in (4, 2):
            if h % k or (k * w) % 32:
                continue
            band = 2 * k * w * cchunk * 2
            halo = 2 * 2 * w * cchunk * 2
            extq = (k + 2) * w * cchunk
            taps = 2 * k * w * cchunk
            wgt1 = 2 * 9 * cchunk * c
            accf = k * w * c * 4
            part = k * w * c * 4
            hq = k * w * c
            wgt2 = c * cout
            acc2 = k * w * cout * 4
            out = 2 * k * w * cout * 2
            if (band + halo + extq + taps + wgt1 + accf + part + hq
                    + wgt2 + acc2 + out <= budget):
                return k, cchunk
    return None


def pack_block_int8_params(params: dict, device: str | torch.device = "cpu"):
    """Folded ConvBlock params (HWIO) → (w1q [9, C, Cmid] int8, s1, b1,
    w2q [Cmid, Cout] int8, s2, b2), scales per output channel."""
    ka = np.asarray(params["conv_a"]["kernel"], np.float32)      # [3,3,C,Cmid]
    kb = np.asarray(params["conv_b"]["kernel"], np.float32)      # [1,1,Cmid,Cout]
    s1 = np.abs(ka).max(axis=(0, 1, 2)) / np.float32(127.0) + np.float32(1e-12)
    w1q = np.clip(np.round(ka / s1), -127, 127).astype(np.int8)
    s2 = np.abs(kb[0, 0]).max(axis=0) / np.float32(127.0) + np.float32(1e-12)
    w2q = np.clip(np.round(kb[0, 0] / s2), -127, 127).astype(np.int8)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return (t(w1q.reshape(9, ka.shape[2], ka.shape[3])), t(s1),
            t(np.asarray(params["conv_a"]["bias"], np.float32)), t(w2q),
            t(s2), t(np.asarray(params["conv_b"]["bias"], np.float32)))


# ------------------------------------------------------------ plain versions


def _leaky(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v >= 0, v, v * slope)


def band_conv3x3_int8_plain(x, wq, s, b, *, k_rows: int, c_chunk: int,
                            negative_slope: float | None) -> torch.Tensor:
    """The int8 3×3 stage every int8 kernel shares, band by band:
    ``f = Σ_j f32(int 3×3 of quant(x_j, a_j)) · (a_j · s)`` over the input
    channel chunks j in order, ``f + b``, LeakyReLU unless
    ``negative_slope`` is None.  ``a_j`` is chunk j's max |x| over the band
    and its halo rows (zero outside the frame) / 127 + 1e-12.  Returns
    float32 ``[N·bands, k_rows·W, Co]``.  Integer products run in float64,
    which holds every int8·int8 sum here exactly."""
    c = x.shape[-1]
    ext = band_rows(x, k_rows)                                    # bands + halos
    f = None
    for c0 in range(0, c, c_chunk):
        e = ext[..., c0:c0 + c_chunk]
        a = band_scale(e)                                         # [n·nb]
        acc = conv3x3_band_taps(quant_i8(e, a[:, None, None, None]).double(),
                                wq[:, c0:c0 + c_chunk].double(), k_rows)
        part = acc.float() * (a[:, None, None] * s.float())
        f = part if f is None else f + part
    f = f + b.float()
    return f if negative_slope is None else _leaky(f, negative_slope)


def _pointwise_int8_plain(hid, w2q, s2, b2, slope, shape, dtype):
    """Second half of the int8 blocks: per-band scale of the hidden values,
    int8 1×1, dequantize, bias, LeakyReLU, cast; ``shape`` is [N,H,W]."""
    a2 = band_scale(hid)
    acc2 = quant_i8(hid, a2[:, None, None]).double() @ w2q.double()
    out = acc2.float() * (a2[:, None, None] * s2.float()) + b2.float()
    return _leaky(out, slope).reshape(*shape, w2q.shape[1]).to(dtype)


def block_int8_nhwc_plain(x, w1q, s1, b1, w2q, s2, b2, *, k_rows: int,
                          negative_slope: float = 0.2) -> torch.Tensor:
    """Plain version of K3: one chunk, the hidden value rounded to bf16."""
    hid = band_conv3x3_int8_plain(x, w1q, s1, b1, k_rows=k_rows,
                                  c_chunk=x.shape[-1],
                                  negative_slope=negative_slope)
    return _pointwise_int8_plain(hid.to(torch.bfloat16).float(), w2q, s2, b2,
                                 negative_slope, x.shape[:3], x.dtype)


def block_int8_kchunked_plain(x, w1q, s1, b1, w2q, s2, b2, *, k_rows: int,
                              c_chunk: int,
                              negative_slope: float = 0.2) -> torch.Tensor:
    """Plain version of K5: ``c_chunk`` chunks, the hidden value float32."""
    hid = band_conv3x3_int8_plain(x, w1q, s1, b1, k_rows=k_rows,
                                  c_chunk=c_chunk,
                                  negative_slope=negative_slope)
    return _pointwise_int8_plain(hid, w2q, s2, b2, negative_slope,
                                 x.shape[:3], x.dtype)


# ----------------------------------------------------------------- kernels


def pack_taps_i8(wq: torch.Tensor) -> torch.Tensor:
    """[9, C, Co] int8 → the kernels' [9, C/16, Co, 16]: 16 input channels
    per 16-byte word, output channel minor.  For one (tap, word), eight
    consecutive output channels are 128 contiguous bytes: one core matrix of
    the 3×3's ``wgmma`` B operand and the rows of one ``ldmatrix`` B fragment
    of the 1×1 (``csrc/taps.cuh``)."""
    taps, c, co = wq.shape
    return wq.reshape(taps, c // 16, 16, co).permute(0, 1, 3, 2).contiguous()


def pack_pointwise_i8(w2q: torch.Tensor) -> torch.Tensor:
    """[Cmid, Cout] int8 → [Cmid/16, Cout, 16]: the 1×1 as one tap of
    :func:`pack_taps_i8`'s layout."""
    return pack_taps_i8(w2q[None])[0]


def _check_block(x, w1q, s1, b1, w2q, s2, b2, k_rows, c_chunk) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, C], got {tuple(x.shape)}")
    n, h, w, c = x.shape
    cmid, cout = w1q.shape[2], w2q.shape[1]
    c_chunk = c if c_chunk is None else c_chunk
    if (c % 128 or k_rows < 1 or h % k_rows or c_chunk % 16 or c_chunk < 16
            or c % c_chunk or tuple(w1q.shape) != (9, c, cmid)
            or tuple(w2q.shape) != (cmid, cout) or cmid % 16
            or w1q.dtype != torch.int8 or w2q.dtype != torch.int8
            or s1.numel() != cmid or b1.numel() != cmid
            or s2.numel() != cout or b2.numel() != cout):
        raise ValueError(
            f"bad operands: x {tuple(x.shape)} (C % 128 == 0, H % k_rows == 0, "
            f"k_rows={k_rows}, C % c_chunk == 0, c_chunk={c_chunk}), w1q "
            f"{tuple(w1q.shape)} {w1q.dtype}, w2q {tuple(w2q.shape)} "
            f"{w2q.dtype} (Cmid % 16 == 0)")


def _launch_block(x, w1q, s1, b1, w2q, s2, b2, k_rows, c_chunk,
                  negative_slope, hidden_dtype) -> torch.Tensor:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel takes bfloat16 or float32, got {x.dtype}")
    _build.check_device(x, w1q, s1, b1, w2q, s2, b2)
    n, h, w, c = x.shape
    cmid, cout = w1q.shape[2], w2q.shape[1]
    x = _build.aligned(x)
    w1p = pack_taps_i8(w1q)
    w2p = pack_pointwise_i8(w2q)
    f32 = [t.float().reshape(-1).contiguous() for t in (s1, b1, s2, b2)]
    rowmax = torch.empty(n * h * (c // c_chunk), dtype=torch.float32,
                         device=x.device)
    bandmax = torch.empty(n * (h // k_rows), dtype=torch.int32, device=x.device)
    xq = torch.empty(band_copy_shape(n, h, w, c, k_rows, c_chunk),
                     dtype=torch.int8, device=x.device)
    hbuf = torch.empty((n, h, w, cmid), dtype=hidden_dtype, device=x.device)
    out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    _build.check_extent(x, hbuf, out)
    _build.call("pcss_block_int8_nhwc", x.data_ptr(), w1p.data_ptr(),
                f32[0].data_ptr(), f32[1].data_ptr(), w2p.data_ptr(),
                f32[2].data_ptr(), f32[3].data_ptr(), out.data_ptr(),
                rowmax.data_ptr(), bandmax.data_ptr(), xq.data_ptr(),
                hbuf.data_ptr(),
                n, h, w, c, c_chunk, cmid, cout, k_rows, float(negative_slope),
                int(x.dtype == torch.bfloat16),
                int(hidden_dtype == torch.float32),
                torch.cuda.current_stream(x.device).cuda_stream)
    return out


@_build.on_device
def fused_block_int8_nhwc(x: torch.Tensor, w1q: torch.Tensor, s1: torch.Tensor,
                          b1: torch.Tensor, w2q: torch.Tensor, s2: torch.Tensor,
                          b2: torch.Tensor, *, k_rows: int,
                          negative_slope: float = 0.2) -> torch.Tensor:
    """K3.  x [N,H,W,C] bf16/f32; w1q [9,C,Cmid] int8 with per-out-channel
    scales s1 [Cmid] f32, b1 [Cmid] f32; w2q [Cmid,Cout] int8, s2 [Cout]
    f32, b2 [Cout] f32 → [N,H,W,Cout] in x's dtype.  ``k_rows`` must
    divide H."""
    _check_block(x, w1q, s1, b1, w2q, s2, b2, k_rows, None)
    if x.device.type == "cpu":
        return block_int8_nhwc_plain(x, w1q, s1, b1, w2q, s2, b2,
                                     k_rows=k_rows,
                                     negative_slope=negative_slope)
    out = _launch_block(x, w1q, s1, b1, w2q, s2, b2, k_rows, x.shape[-1],
                        negative_slope, torch.bfloat16)
    fused_block_int8_nhwc.launches += 1
    return out


@_build.on_device
def fused_block_int8_kchunked(x: torch.Tensor, w1q: torch.Tensor,
                              s1: torch.Tensor, b1: torch.Tensor,
                              w2q: torch.Tensor, s2: torch.Tensor,
                              b2: torch.Tensor, *, k_rows: int, c_chunk: int,
                              negative_slope: float = 0.2) -> torch.Tensor:
    """K5.  Operands as :func:`fused_block_int8_nhwc`; the 3×3 contraction
    runs in ``c_chunk``-channel chunks, each with its own activation scale,
    summed in float32, and the hidden value stays float32.  ``c_chunk``
    must divide C."""
    _check_block(x, w1q, s1, b1, w2q, s2, b2, k_rows, c_chunk)
    if x.device.type == "cpu":
        return block_int8_kchunked_plain(x, w1q, s1, b1, w2q, s2, b2,
                                         k_rows=k_rows, c_chunk=c_chunk,
                                         negative_slope=negative_slope)
    out = _launch_block(x, w1q, s1, b1, w2q, s2, b2, k_rows, c_chunk,
                        negative_slope, torch.float32)
    fused_block_int8_kchunked.launches += 1
    return out


@_build.on_device
def quantize_bands(x: torch.Tensor, *, k_rows: int,
                   c_chunk: int) -> torch.Tensor:
    """The band copy the int8 kernels' 3×3 reads (K3, K5, K7: the first two
    of their launches), as :func:`~.taps.quantize_bands_plain` lays it out;
    its plain version on a CPU tensor.  x [N,H,W,C] bf16/f32, C % c_chunk
    == 0, c_chunk % 16 == 0, H % k_rows == 0."""
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, C], got {tuple(x.shape)}")
    n, h, w, c = x.shape
    if (k_rows < 1 or h % k_rows or c_chunk < 16 or c_chunk % 16
            or c % c_chunk):
        raise ValueError(f"bad operands: x {tuple(x.shape)}, k_rows={k_rows}, "
                         f"c_chunk={c_chunk}")
    if x.device.type == "cpu":
        return quantize_bands_plain(x, k_rows=k_rows, c_chunk=c_chunk)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel takes bfloat16 or float32, got {x.dtype}")
    x = _build.aligned(x)
    rowmax = torch.empty(n * h * (c // c_chunk), dtype=torch.float32,
                         device=x.device)
    xq = torch.empty(band_copy_shape(n, h, w, c, k_rows, c_chunk),
                     dtype=torch.int8, device=x.device)
    _build.check_extent(x)
    _build.call("pcss_quant_bands", x.data_ptr(), rowmax.data_ptr(),
                xq.data_ptr(), n, h, w, c, c_chunk, k_rows,
                int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    return xq


fused_block_int8_nhwc.launches = 0
fused_block_int8_kchunked.launches = 0
