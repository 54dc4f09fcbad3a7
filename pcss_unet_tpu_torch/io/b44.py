"""B44 / B44A EXR compression — pure-numpy implementation.

The reference reads EXRs through the OpenEXR bindings (setdata.py:42),
which accept B44-compressed files transparently; B44 is the format's
fixed-rate lossy mode (used where random access / constant decode cost
matters, e.g. texture streaming).  Implemented from the OpenEXR
file-format specification with the same discipline as io/piz.py and
io/dwa.py — no upstream code consulted:

- 32 scanlines per chunk; channels stored planar in chlist order;
- HALF channels are coded as 4x4 pixel blocks, each packed to 14 bytes:
  a 16-bit base value (pixel 0, stored exactly) followed by sixteen
  6-bit fields packed MSB-first — a shift amount, then fifteen biased
  quantized deltas, each predicting a pixel from an already-decoded
  neighbor (down the first column, then along each row);
- half values are first mapped through an order-preserving integer
  transform (negative halves bit-inverted, positive ones offset by
  0x8000) so deltas are meaningful across the sign boundary; Inf/NaN
  collapse to +0 (B44 is lossy by contract);
- B44A additionally packs a flat block (all 16 transformed values
  identical) into 3 bytes, marked by an all-ones shift field (third
  byte 0xfc); the decoder accepts 3-byte blocks in both modes;
- partial edge blocks are padded by edge replication on encode and
  cropped on decode;
- FLOAT/UINT channels are stored verbatim (planar), as the format
  requires — only HALF data is B44-coded.

Deltas are quantized against the *reconstructed* predecessor (the same
chain the decoder follows), so quantization error does not accumulate
along the prediction chains; the encoder picks the smallest shift whose
deltas all fit in 6 bits with bounded reconstruction error.  Correctness
is pinned by roundtrip, error-bound, and container-level tests
(tests/test_exr.py) — this image has no libopenexr oracle, so upstream
bit-compatibility is asserted at the format level only.
"""

from __future__ import annotations

import numpy as np

# delta stream order: (target, predecessor) within the 4x4 block
# (row-major indices 0..15).  First down column 0, then along each row —
# every predecessor is decoded before it is used.
_ORDER = (
    (4, 0), (8, 4), (12, 8),
    (1, 0), (5, 4), (9, 8), (13, 12),
    (2, 1), (6, 5), (10, 9), (14, 13),
    (3, 2), (7, 6), (11, 10), (15, 14),
)
_FLAT_MARKER = 0xFC  # third byte of a 3-byte flat block (shift field ~0)
_MAX_SHIFT = 16


def _forward_transform(h_bits: np.ndarray) -> np.ndarray:
    """half bit pattern (uint16) -> order-preserving uint16 code."""
    a = h_bits.astype(np.int64)
    neg = (a & 0x8000) != 0
    t = np.where(neg, ~a & 0xFFFF, a | 0x8000)
    return np.where((a & 0x7C00) == 0x7C00, 0x8000, t)  # Inf/NaN -> +0


def _inverse_transform(t: np.ndarray) -> np.ndarray:
    """uint16 code -> half bit pattern (uint16)."""
    return np.where(t & 0x8000, t & 0x7FFF, ~t & 0xFFFF).astype(np.uint16)


def _to_blocks(plane: np.ndarray, width: int, n_lines: int) -> np.ndarray:
    """[n_lines, width] -> [nB, 16] row-major 4x4 blocks (edge-padded)."""
    ph = (-n_lines) % 4
    pw = (-width) % 4
    if ph or pw:
        plane = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    hb, wb = plane.shape[0] // 4, plane.shape[1] // 4
    return (plane.reshape(hb, 4, wb, 4).transpose(0, 2, 1, 3)
            .reshape(hb * wb, 16))


def _from_blocks(blocks: np.ndarray, width: int, n_lines: int) -> np.ndarray:
    """[nB, 16] -> [n_lines, width] (inverse of _to_blocks, cropped)."""
    hb = (n_lines + 3) // 4
    wb = (width + 3) // 4
    full = (blocks.reshape(hb, wb, 4, 4).transpose(0, 2, 1, 3)
            .reshape(hb * 4, wb * 4))
    return full[:n_lines, :width]


def _pack_fields(fields: np.ndarray) -> np.ndarray:
    """[nB, 16] 6-bit fields -> [nB, 12] bytes (MSB-first)."""
    f = fields.reshape(-1, 4, 4)
    b0 = (f[..., 0] << 2) | (f[..., 1] >> 4)
    b1 = ((f[..., 1] & 0xF) << 4) | (f[..., 2] >> 2)
    b2 = ((f[..., 2] & 0x3) << 6) | f[..., 3]
    return (np.stack([b0, b1, b2], axis=-1)
            .reshape(fields.shape[0], 12).astype(np.uint8))


def _unpack_fields(b: np.ndarray) -> np.ndarray:
    """[nB, 12] bytes -> [nB, 16] 6-bit fields."""
    g = b.reshape(-1, 4, 3).astype(np.int64)
    f0 = g[..., 0] >> 2
    f1 = ((g[..., 0] & 0x3) << 4) | (g[..., 1] >> 4)
    f2 = ((g[..., 1] & 0xF) << 2) | (g[..., 2] >> 6)
    f3 = g[..., 2] & 0x3F
    return np.stack([f0, f1, f2, f3], axis=-1).reshape(b.shape[0], 16)


def _encode_blocks(t: np.ndarray) -> np.ndarray:
    """Quantize transformed blocks t [nB, 16] -> 6-bit fields [nB, 16]
    (shift then 15 deltas), choosing per block the smallest shift whose
    chained deltas fit in 6 bits with bounded reconstruction error."""
    n_blocks = t.shape[0]
    out = np.zeros((n_blocks, 16), np.int64)
    settled = np.zeros(n_blocks, bool)
    for shift in range(_MAX_SHIFT + 1):
        bias = 0x20 << shift
        half = (1 << shift) >> 1
        recon = t.copy()
        fields = np.empty((n_blocks, 16), np.int64)
        fields[:, 0] = shift
        ok = np.ones(n_blocks, bool)
        for k, (tgt, pred) in enumerate(_ORDER):
            diff = t[:, tgt] - recon[:, pred] + bias
            d = (diff + half) >> shift
            ok &= (d >= 0) & (d <= 0x3F)
            d = np.clip(d, 0, 0x3F)
            recon[:, tgt] = (recon[:, pred] + (d << shift) - bias) & 0xFFFF
            fields[:, k + 1] = d
        ok &= np.abs(recon - t).max(axis=1) <= max(half, 0)
        take = ok & ~settled
        if shift == _MAX_SHIFT:          # safety net: accept clipped encode
            take = ~settled
        if take.any():
            out[take] = fields[take]
            settled |= take
        if settled.all():
            break
    return out


def _encode_half_plane(h_bits: np.ndarray, width: int, n_lines: int,
                       flat_ok: bool) -> bytes:
    t = _forward_transform(_to_blocks(h_bits, width, n_lines))
    n_blocks = t.shape[0]
    base = t[:, 0]
    flat = (np.zeros(n_blocks, bool) if not flat_ok
            else (t == base[:, None]).all(axis=1))
    fields = np.zeros((n_blocks, 16), np.int64)
    if (~flat).any():
        fields[~flat] = _encode_blocks(t[~flat])
    packed = _pack_fields(fields)
    sizes = np.where(flat, 3, 14)
    offs = np.zeros(n_blocks, np.int64)
    np.cumsum(sizes[:-1], out=offs[1:])
    buf = np.empty(int(sizes.sum()), np.uint8)
    buf[offs] = (base >> 8).astype(np.uint8)
    buf[offs + 1] = (base & 0xFF).astype(np.uint8)
    buf[offs + 2] = np.where(flat, _FLAT_MARKER, packed[:, 0]).astype(np.uint8)
    nf = ~flat
    nf_offs = offs[nf]
    for j in range(3, 14):
        buf[nf_offs + j] = packed[nf, j - 2]
    return buf.tobytes()


def _decode_half_plane(buf: memoryview, pos: int, width: int,
                       n_lines: int) -> tuple[np.ndarray, int]:
    """Decode one channel's blocks from ``buf`` starting at ``pos``.
    -> (float32 [n_lines, width], new pos)."""
    n_blocks = ((n_lines + 3) // 4) * ((width + 3) // 4)
    offs = np.empty(n_blocks, np.int64)
    p = pos
    end = len(buf)
    for i in range(n_blocks):
        if p + 3 > end:
            raise ValueError("truncated B44 chunk")
        offs[i] = p
        p += 3 if buf[p + 2] == _FLAT_MARKER else 14
    if p > end:
        raise ValueError("truncated B44 chunk")
    b = np.frombuffer(buf, np.uint8)
    base = (b[offs].astype(np.int64) << 8) | b[offs + 1]
    flat = b[offs + 2] == _FLAT_MARKER
    t = np.repeat(base[:, None], 16, axis=1)
    nf = ~flat
    if nf.any():
        rows = b[offs[nf, None] + np.arange(2, 14)]      # [nNF, 12]
        fields = _unpack_fields(rows)
        shift = fields[:, 0]
        bias = 0x20 << shift
        s = t[nf]
        for k, (tgt, pred) in enumerate(_ORDER):
            s[:, tgt] = ((s[:, pred] + (fields[:, k + 1] << shift) - bias)
                         & 0xFFFF)
        t[nf] = s
    halves = _inverse_transform(t).view(np.float16)
    plane = _from_blocks(halves, width, n_lines)
    return plane.astype(np.float32), p


def b44_compress(arrs: dict[str, np.ndarray], channels, width: int,
                 n_lines: int, flat_ok: bool) -> bytes:
    """Compress one chunk (or tile).  ``arrs`` maps channel name to its
    [n_lines, width] array in the channel's storage dtype; ``channels``
    is the chlist-ordered channel list.  ``flat_ok`` enables the 3-byte
    flat-block form (B44A)."""
    out = bytearray()
    pt_half = np.dtype("<f2")
    for ch in channels:
        a = np.ascontiguousarray(arrs[ch.name])
        if a.dtype == pt_half:
            out += _encode_half_plane(a.view(np.uint16), width, n_lines,
                                      flat_ok)
        else:                      # FLOAT/UINT: stored verbatim, planar
            out += a.tobytes()
    return bytes(out)


def b44_decompress(payload: bytes, channels, width: int,
                   n_lines: int) -> dict[str, np.ndarray]:
    """Inverse of b44_compress -> {name: float32 [n_lines, width]}."""
    from pcss_unet_tpu_torch.io.exr_py import PT_HALF, _DTYPES

    buf = memoryview(payload)
    out: dict[str, np.ndarray] = {}
    pos = 0
    for ch in channels:
        if ch.pixel_type == PT_HALF:
            out[ch.name], pos = _decode_half_plane(buf, pos, width, n_lines)
        else:
            dt = _DTYPES[ch.pixel_type]
            count = width * n_lines
            raw = np.frombuffer(buf, dt, count=count, offset=pos)
            pos += count * dt.itemsize
            out[ch.name] = raw.reshape(n_lines, width).astype(np.float32)
    return out
