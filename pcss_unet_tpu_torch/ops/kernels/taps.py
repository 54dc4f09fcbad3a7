"""The shared 3×3 tap contraction of the NHWC row-band kernels (port of
``pcss_unet_tpu/ops/pallas/taps.py::conv3x3_band_taps``).

A band of ``k_rows`` rows plus one halo row above and below is
``ext [k_rows+2, W, C]``; each of the 9 taps is a dy row slice combined
with a dx column shift (zero column at the W edge), contracted against that
tap's ``[C, Co]`` weight matrix.  Tap order is ``dy*3 + dx + 1`` with dy
indexing ext rows 0..2 and dx ∈ {-1, 0, 1}.

This is the plain version.  The CUDA kernels share one device function with
the same tap order, ``csrc/taps.cuh``, so the tap maths lives in one place on
each side.

The int8 kernels' 3×3 reads its input as a band copy: each band's rows
quantized once by the band's scales, laid out as the tile's stages read
them.  :func:`quantize_bands_plain` is its plain version.
"""

from __future__ import annotations

import torch

from pcss_unet_tpu_torch.ops.int8 import div_ieee

# the int8 3×3's pixel tile and its stage depth in 16-byte words
# (``csrc/taps.cuh``, ``i8wg::TM`` and ``i8wg::KW``)
TM, KW = 126, 2


def conv3x3_band_taps(ext: torch.Tensor, w_taps: torch.Tensor,
                      k_rows: int) -> torch.Tensor:
    """Nine-tap 3×3 SAME conv over row bands.

    ext    [B, k_rows+2, W, Cin]  B bands, each with one halo row above and
                                  below
    w_taps [9, Cin, Co]           tap order ``dy*3 + dx + 1``
    Returns ``[B, k_rows·W, Co]`` in the operands' common dtype.  Integer
    sums need a dtype that holds them exactly: the int8 callers pass
    float64 operands (``torch.mm`` on int8 tensors returns int8 and wraps).
    """
    b, _, w, cin = ext.shape
    acc = None
    zcol = torch.zeros_like(ext[:, :k_rows, :1])
    for dy in range(3):
        rows = ext[:, dy: dy + k_rows]
        for dx in (-1, 0, 1):
            if dx == 0:
                tap = rows
            elif dx == 1:
                tap = torch.cat([rows[:, :, 1:], zcol], dim=2)
            else:
                tap = torch.cat([zcol, rows[:, :, :-1]], dim=2)
            term = tap.reshape(b, k_rows * w, cin) @ w_taps[dy * 3 + dx + 1]
            acc = term if acc is None else acc + term
    return acc


def band_rows(x: torch.Tensor, k_rows: int) -> torch.Tensor:
    """x [N, H, W, C] → ``ext [N·H/k_rows, k_rows+2, W, C]`` in float32:
    each band of ``k_rows`` rows with one halo row above and below, zero
    outside the frame."""
    n, h, w, c = x.shape
    nb = h // k_rows
    xp = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 1, 1))
    rows = (torch.arange(nb, device=x.device)[:, None] * k_rows
            + torch.arange(k_rows + 2, device=x.device)[None, :])
    return xp[:, rows].reshape(n * nb, k_rows + 2, w, c)


def band_scale(e: torch.Tensor) -> torch.Tensor:
    """The int8 activation scale of each band of ``e [B, ...]``: max |e|
    over the band / 127 + 1e-12, float32 [B]."""
    return div_ieee(e.abs().flatten(1).amax(dim=1), 127.0) + 1e-12


def quant_i8(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(v / scale), -127, 127), half to even, as float."""
    return torch.clamp(torch.round(v / scale), -127, 127)


def band_copy_shape(n: int, h: int, w: int, c: int, k_rows: int,
                    c_chunk: int) -> tuple[int, ...]:
    """The band copy of an [N, H, W, C] input: ``[N, H/k_rows, k_rows+2,
    words, Wp, 16]`` int8, ``words`` each chunk's C_chunk/16 rounded up to
    whole stages of KW, ``Wp`` whole pixel tiles and the two SAME columns."""
    words = c // c_chunk * (-(-c_chunk // 16 // KW) * KW)
    return (n, h // k_rows, k_rows + 2, words, -(-w // TM) * TM + 2, 16)


def quantize_bands_plain(x: torch.Tensor, *, k_rows: int,
                         c_chunk: int) -> torch.Tensor:
    """Plain version of the band copy: per band and chunk j of ``c_chunk``
    channels, ``quant(ext_j, a_j)`` with ``a_j`` :func:`band_scale` of the
    band's rows and halo rows (so a row on a band edge is in two bands'
    copies, each with its band's scale), channels 16·k .. 16·k + 15 of
    chunk j at word ``j · words/chunks + k``, input column col at column col
    + 1.  Column 0, the columns past W, words past a chunk and halo rows
    outside the frame are 0.  Returns :func:`band_copy_shape` int8."""
    n, h, w, c = x.shape
    shape = band_copy_shape(n, h, w, c, k_rows, c_chunk)
    cpw = shape[3] // (c // c_chunk)
    out = torch.zeros((n * shape[1], k_rows + 2, c // c_chunk, cpw, shape[4], 16),
                      dtype=torch.int8, device=x.device)
    ext = band_rows(x, k_rows)
    for j, c0 in enumerate(range(0, c, c_chunk)):
        e = ext[..., c0:c0 + c_chunk]
        q = quant_i8(e, band_scale(e)[:, None, None, None]).to(torch.int8)
        out[:, :, j, :c_chunk // 16, 1:w + 1] = (
            q.reshape(*q.shape[:3], c_chunk // 16, 16).permute(0, 1, 3, 2, 4))
    return out.reshape(shape)
