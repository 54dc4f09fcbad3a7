"""DWA (DWAA/DWAB) EXR compression — pure-numpy implementation.

The reference reads EXRs through the OpenEXR bindings (setdata.py:42),
which accept DWA-compressed files transparently; DWAA is a common modern
renderer default.  This module implements the DWA scheme for the
pure-Python codec (io/exr_py.py); every format decision below is pinned
against real libOpenEXR 3.1 output byte-for-byte by
tests/test_exr_interop.py (via tests/oracle/exr_oracle):

- chunk layout: an 11×uint64 header (version, per-segment compressed /
  uncompressed sizes, AC/DC counts, AC-compression selector), for
  version ≥ 2 a serialized channel-rules block, then the UNKNOWN / AC /
  DC / RLE segments;
- channel rules: each rule is a null-terminated suffix string plus a
  value byte ``(cscPos+1)<<4 | scheme<<2 | caseInsensitive`` and a
  pixel-type byte.  A channel takes the FIRST rule whose suffix (after
  the last '.') and pixel type both match; no match → UNKNOWN.  The
  default table (applied to version-1 chunks, and what we serialize on
  write) classifies R/G/B/Y/BY/RY in HALF and FLOAT as LOSSY_DCT (R,G,B
  carrying CSC positions 0,1,2) and A in UINT/HALF/FLOAT as RLE;
- unit order: complete R,G,B CSC sets (same prefix, positions {0,1,2})
  are processed FIRST, in chlist first-appearance order, then the
  remaining LOSSY_DCT channels solo in chlist order;
- LOSSY_DCT: plane → perceptual nonlinearity (x^(1/2.2) through a
  half-bit LUT) → for CSC sets a Rec.709 Y'CbCr rotation → 8×8
  orthonormal DCT → error-budgeted quantization to sparse halfs →
  zig-zag.  DC coefficients go to their own segment
  (reorder+delta+deflate — the ZIP transform) laid out plane-sequential
  per unit (a CSC unit contributes its Y, Cb, Cr planes back to back);
  AC coefficients are zero-run-length coded (0xff00|run for 1..255
  zeros, bare 0xff00 = end-of-block: remaining coefficients are zero)
  and entropy-coded with the PIZ Huffman coder.  Within a CSC unit the
  AC stream is BLOCK-interleaved: per block position, the Y, Cb, Cr
  blocks in turn (unlike the plane-sequential DC stream).  FLOAT
  channels classified LOSSY_DCT are converted through half first
  (lossy, exactly as upstream);
- RLE scheme: per channel a planar byte split (least-significant byte
  plane first — 2 planes for HALF, 4 for UINT/FLOAT), EXR RLE, deflate;
- UNKNOWN: raw plane bytes, chlist order, deflate.

Fidelity against upstream is asserted by tests/test_exr_interop.py
(decode-what-libOpenEXR-writes and libOpenEXR-reads-what-we-write);
self-roundtrips stay covered by tests/test_exr.py.

Version-1 chunks (no rules block) decode with the default table — the
same behavior libOpenEXR applies to them.  Note this intentionally
breaks DWA files written by this repo BEFORE the upstream-semantics fix
(they used a half-only classification and a different AC layout); no
such files were ever shipped or committed as fixtures.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np

# AC compression selectors (header word 10)
AC_STATIC_HUFFMAN = 0
AC_DEFLATE = 1

# classification schemes
_UNKNOWN, _LOSSY_DCT, _RLE = 0, 1, 2

_ZIGZAG = np.array([
    0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# orthonormal 8-point DCT-II basis
_DCT_C = np.empty((8, 8), np.float32)
for _k in range(8):
    _s = np.sqrt(1.0 / 8.0) if _k == 0 else np.sqrt(2.0 / 8.0)
    _DCT_C[_k] = _s * np.cos(np.pi * (2 * np.arange(8) + 1) * _k / 16.0)

# Per-zigzag-index quantization error budgets, as multipliers of
# base_err = dwaCompressionLevel / 100000 — extracted empirically from
# libOpenEXR (zeroing-threshold probes through tests/oracle/exr_oracle at
# level 4000, 1/16-base resolution; see docs/BENCHMARKS.md "DWA size
# parity").  Index 0 is the DC budget.  Upstream uses SEPARATE tables for
# luma/solo planes (Y) and the chroma planes of a CSC set (CbCr — note
# the saturation at ~5.79 above zig-zag index 10, mirroring JPEG chroma
# tables).  Encoder-side freedom: any half is legal in the stream, but
# matching upstream's budgets puts our files at upstream's size/loss
# point for a given level.
_QUANT_W_Y = np.array([
    1.5625,
    1.1, 1.162, 1.35, 1.162, 0.975, 1.6, 1.412, 1.288, 1.35, 1.788,
    1.662, 1.538, 1.85, 2.35, 3.975, 2.538, 2.35, 2.162, 2.162, 2.35,
    4.85, 3.475, 3.662, 2.85, 3.975, 5.788, 5.1, 6.1, 5.975, 5.662,
    5.038, 5.538, 5.475, 6.35, 7.162, 9.162, 7.788, 6.35, 6.725, 8.662,
    6.85, 5.475, 5.538, 7.975, 10.85, 8.1, 8.662, 9.475, 9.788, 10.288,
    10.35, 10.288, 6.162, 7.662, 11.288, 12.038, 11.162, 9.975, 11.975,
    9.162, 10.038, 10.288, 9.85], np.float32)
_QUANT_W_CBCR = np.array([
    1.5625,
    1.038, 1.038, 1.412, 1.225, 1.412, 2.725, 1.475, 1.475, 2.725,
    5.788, 3.85, 3.288, 3.85] + [5.788] * 50, np.float32)


def _lut_nonlinear() -> tuple[np.ndarray, np.ndarray]:
    """(to_nonlinear, to_linear) LUTs over all 65536 half bit patterns.

    libOpenEXR bakes these tables into the library (dwaLookups); the
    curve is piecewise — x^(1/2.2) for |x| ≤ 1, 1 + ln(x)/2.2 above,
    sign-preserving, NaN/Inf pass — but the shipped tables carry their
    own rounding (~half the entries sit one half-ulp off a straight
    half-rounded formula, tiny values flush to zero).  Bit-exact interop
    therefore uses dwa_luts.npz, extracted from the real library by
    scripts/extract_dwa_luts.py; the analytic curve below is only the
    fallback when the artifact is missing (self-roundtrips stay correct,
    third-party DWA files then decode with one-ulp noise)."""
    try:
        import os

        data = np.load(os.path.join(os.path.dirname(__file__),
                                    "dwa_luts.npz"))
        return (data["to_nonlinear"].astype(np.uint16),
                data["to_linear"].astype(np.uint16))
    except (OSError, KeyError):
        pass
    bits = np.arange(65536, dtype=np.uint16)
    f = bits.view(np.float16).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        a = np.abs(f)
        nl = np.sign(f) * np.where(a <= 1.0, a ** (1.0 / 2.2),
                                   1.0 + np.log(a) / 2.2)
        lin = np.sign(f) * np.where(a <= 1.0, a ** 2.2,
                                    np.exp(2.2 * (a - 1.0)))
        keep = ~np.isfinite(f)
        nl[keep] = f[keep]
        lin[keep] = f[keep]
        return (nl.astype(np.float16).view(np.uint16),
                lin.astype(np.float16).view(np.uint16))


_TO_NONLINEAR, _TO_LINEAR = _lut_nonlinear()


class Rule(NamedTuple):
    suffix: str
    scheme: int        # _UNKNOWN/_LOSSY_DCT/_RLE
    pixel_type: int    # EXR PT: 0 uint, 1 half, 2 float
    csc_pos: int       # 0/1/2 position in an R,G,B set; -1 none
    case_insensitive: bool  # value-byte bit0; the DEFAULTS are sensitive

    def matches(self, name: str, pixel_type: int) -> bool:
        if pixel_type != self.pixel_type:
            return False
        sfx = name.rsplit(".", 1)[-1]
        if self.case_insensitive:
            return sfx.lower() == self.suffix.lower()
        return sfx == self.suffix


# libOpenEXR's default channel rules, confirmed from serialized rule
# blocks AND behavior (a lowercase 'r:half' channel classifies UNKNOWN
# upstream — the defaults match case-SENSITIVELY; the serialized value
# byte's bit0 is a case-INSENSITIVE flag and the defaults leave it 0):
# R/G/B/Y/BY/RY in HALF and FLOAT → LOSSY_DCT (R,G,B csc 0,1,2);
# A in UINT/HALF/FLOAT → RLE.
DEFAULT_RULES: tuple[Rule, ...] = tuple(
    [Rule(s, _LOSSY_DCT, t, p, False)
     for s, p in (("R", 0), ("G", 1), ("B", 2))
     for t in (1, 2)] +
    [Rule(s, _LOSSY_DCT, t, -1, False)
     for s in ("Y", "BY", "RY") for t in (1, 2)] +
    [Rule("A", _RLE, t, -1, False) for t in (0, 1, 2)]
)


def parse_rules(blob: bytes) -> list[Rule]:
    """Parse a serialized channel-rules block (without the leading uint16
    size, which the caller consumed)."""
    rules = []
    pos = 0
    while pos < len(blob):
        end = blob.index(b"\0", pos)
        suffix = blob[pos:end].decode("latin-1")
        pos = end + 1
        if pos + 2 > len(blob):
            raise ValueError("corrupt DWA channel rule (truncated)")
        value = blob[pos]
        ptype = blob[pos + 1]
        pos += 2
        scheme = (value >> 2) & 3
        if scheme > _RLE:
            raise ValueError(f"corrupt DWA channel rule (scheme {scheme})")
        if ptype > 2:
            raise ValueError(f"corrupt DWA channel rule (type {ptype})")
        rules.append(Rule(suffix, scheme, ptype,
                          ((value >> 4) & 15) - 1, bool(value & 1)))
    return rules


def serialize_rules(rules: list[Rule]) -> bytes:
    out = bytearray()
    for r in rules:
        out += r.suffix.encode("latin-1") + b"\0"
        out.append(((r.csc_pos + 1) & 15) << 4 | (r.scheme & 3) << 2
                   | (1 if r.case_insensitive else 0))
        out.append(r.pixel_type)
    return struct.pack("<H", len(out) + 2) + bytes(out)


def classify(channels, rules=DEFAULT_RULES):
    """→ (scheme per channel, DCT unit list).  A unit is
    ('csc', [iR, iG, iB]) — a complete same-prefix R,G,B set — or
    ('solo', [i]).  Complete CSC sets come first (chlist first-appearance
    order), then solo LOSSY_DCT channels in chlist order, matching
    libOpenEXR's processing order."""
    schemes = []
    csc_pos = []
    for ch in channels:
        rule = next((r for r in rules
                     if r.matches(ch.name, ch.pixel_type)), None)
        schemes.append(rule.scheme if rule else _UNKNOWN)
        csc_pos.append(rule.csc_pos
                       if rule and rule.scheme == _LOSSY_DCT else -1)
    by_prefix: dict[str, dict[int, int]] = {}
    for i, ch in enumerate(channels):
        if csc_pos[i] < 0:
            continue
        prefix = ch.name.rsplit(".", 1)[0] if "." in ch.name else ""
        by_prefix.setdefault(prefix, {}).setdefault(csc_pos[i], i)
    units: list[tuple[str, list[int]]] = []
    in_set: set[int] = set()
    for g in by_prefix.values():           # insertion = chlist order
        if set(g) >= {0, 1, 2}:
            idxs = [g[0], g[1], g[2]]
            units.append(("csc", idxs))
            in_set.update(idxs)
    for i in range(len(channels)):
        if schemes[i] == _LOSSY_DCT and i not in in_set:
            units.append(("solo", [i]))
    return schemes, units


def _csc709_forward(r, g, b):
    y = 0.2126 * r + 0.7152 * g + 0.0722 * b
    cb = (b - y) / 1.8556
    cr = (r - y) / 1.5748
    return y, cb, cr


def _csc709_inverse(y, cb, cr):
    r = y + 1.5748 * cr
    b = y + 1.8556 * cb
    g = (y - 0.2126 * r - 0.0722 * b) / 0.7152
    return r, g, b


def _blocks_of(plane: np.ndarray) -> np.ndarray:
    """[H,W] → [nby*nbx, 8, 8] with edge-replicated padding."""
    h, w = plane.shape
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    p = np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")
    return (p.reshape(ph // 8, 8, pw // 8, 8)
            .transpose(0, 2, 1, 3).reshape(-1, 8, 8))


def _unblocks(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    p = (blocks.reshape(ph // 8, pw // 8, 8, 8)
         .transpose(0, 2, 1, 3).reshape(ph, pw))
    return p[:h, :w]


def _quantize_to_sparse_half(coefs: np.ndarray, errs: np.ndarray
                             ) -> np.ndarray:
    """Round each f32 coefficient to the half with the fewest mantissa
    bits whose error stays within its budget (zeroing when |c| ≤ err).
    → uint16 half bit patterns, shape of coefs."""
    full = coefs.astype(np.float16)
    bits = full.view(np.uint16)
    out = bits.copy()
    # try coarse mantissas first (10 → 0 kept bits chooses the coarsest
    # that fits because later, finer candidates overwrite earlier ones
    # only where the coarser failed)
    chosen = np.zeros(coefs.shape, bool)
    for keep in range(0, 11):
        if keep == 10:
            cand = bits
        else:
            drop = 10 - keep
            mask = (~((1 << drop) - 1)) & 0xFFFFFFFF
            cand = ((bits.astype(np.uint32) + (1 << (drop - 1)))
                    & mask).astype(np.uint16)
        ok = (np.abs(cand.view(np.float16).astype(np.float32) - coefs)
              <= errs) & ~chosen
        out[ok] = cand[ok]
        chosen |= ok
    out[~chosen] = bits[~chosen]
    out[np.abs(coefs) <= errs] = 0
    return out


def _rle_ac(block_q: np.ndarray, out: list) -> None:
    """63 zig-zag AC halfs (uint16) → tokens appended to ``out``:
    nonzero halfs verbatim, zero runs as 0xff00|run, trailing zeros as a
    single bare 0xff00 end-of-block marker (libOpenEXR convention)."""
    nz = np.flatnonzero(block_q)
    prev = 0
    for idx in nz:
        run = int(idx) - prev
        while run > 0:
            r = min(run, 255)
            out.append(0xFF00 | r)
            run -= r
        out.append(int(block_q[idx]))
        prev = int(idx) + 1
    if prev < 63:
        out.append(0xFF00)          # end of block
    return


def _unrle_ac(tokens: np.ndarray, pos: int) -> tuple[np.ndarray, int]:
    """Inverse of _rle_ac: consume tokens from ``pos`` until 63 AC
    coefficients are filled or an end-of-block marker (bare 0xff00) is
    read.  → (uint16[63], new pos)."""
    ac = np.zeros(63, np.uint16)
    filled = 0
    while filled < 63:
        t = int(tokens[pos])
        pos += 1
        if (t & 0xFF00) == 0xFF00:
            run = t & 0xFF
            if run == 0:            # end of block: rest is zero
                return ac, pos
            filled += run
        else:
            ac[filled] = t
            filled += 1
    if filled != 63:
        raise ValueError("corrupt DWA AC stream (zero run overruns block)")
    return ac, pos


def _dct_forward(plane_nl: np.ndarray) -> np.ndarray:
    """Nonlinearized f32 plane → zig-zag f32 coefficients [nblocks, 64]."""
    blocks = _blocks_of(plane_nl)
    coefs = np.einsum("ky,byx,lx->bkl", _DCT_C, blocks, _DCT_C,
                      optimize=True)
    return coefs.reshape(-1, 64)[:, _ZIGZAG]


def _dct_inverse(zz: np.ndarray, h: int, w: int) -> np.ndarray:
    """Zig-zag uint16 half coefficients [nblocks, 64] → f32 plane (still
    in the nonlinear domain)."""
    coefs = np.zeros(zz.shape, np.float32)
    coefs[:, _ZIGZAG] = zz.view(np.float16).astype(np.float32)
    coefs = coefs.reshape(-1, 8, 8)
    blocks = np.einsum("ky,bkl,lx->byx", _DCT_C, coefs, _DCT_C,
                       optimize=True)
    return _unblocks(blocks, h, w)


def dwa_compress(arrs: dict[str, np.ndarray], channels, width: int,
                 n_lines: int, level: float = 45.0) -> bytes:
    """Compress one chunk.  arrs: {name: [n_lines, width] in the channel's
    dtype}; channels: chlist-ordered _Channel sequence."""
    from pcss_unet_tpu_torch.io.exr_py import _DTYPES, _rle_compress, \
        _zip_do_transform

    rules = [r for r in DEFAULT_RULES
             if any(r.matches(c.name, c.pixel_type) for c in channels)]
    schemes, units = classify(channels, rules)
    base_err = float(level) / 100000.0

    dc_parts: list[np.ndarray] = []
    ac_tokens: list[int] = []
    rle_bytes = bytearray()
    unknown = bytearray()

    def nonlinearize(name):
        h16 = np.ascontiguousarray(arrs[name].astype(np.float16))
        nl = _TO_NONLINEAR[h16.view(np.uint16)]
        return nl.view(np.float16).astype(np.float32)

    for kind, idxs in units:
        planes = [nonlinearize(channels[i].name) for i in idxs]
        if kind == "csc":
            planes = list(_csc709_forward(*planes))
        qs = []
        for pi, p in enumerate(planes):
            w = _QUANT_W_CBCR if (kind == "csc" and pi > 0) else _QUANT_W_Y
            zz = _dct_forward(p)
            q = _quantize_to_sparse_half(zz, base_err * w)
            dc_parts.append(q[:, 0].copy())   # DC: plane-sequential
            qs.append(q)
        # AC: block-interleaved across the unit's planes
        for b in range(qs[0].shape[0]):
            for q in qs:
                _rle_ac(q[b, 1:], ac_tokens)
    def as_dtype(a, dt):
        # float -> uint32 of negatives/overflow is undefined; clamp so
        # both codecs produce identical bytes.  4294967040 is the largest
        # float32 below 2^32 (2^32-1 itself rounds UP to 2^32 in f32).
        if dt == np.dtype(np.uint32):
            a = np.clip(a, 0.0, 4294967040.0)
        return np.ascontiguousarray(a.astype(dt))

    for i, ch in enumerate(channels):
        if schemes[i] == _RLE:
            dt = _DTYPES[ch.pixel_type]
            raw = as_dtype(arrs[ch.name], dt)
            b = raw.view(np.uint8).reshape(-1, dt.itemsize)
            for k in range(dt.itemsize):      # LSB byte plane first
                rle_bytes += b[:, k].tobytes()
        elif schemes[i] == _UNKNOWN:
            unknown += as_dtype(arrs[ch.name],
                                _DTYPES[ch.pixel_type]).tobytes()

    dc_all = (np.concatenate(dc_parts) if dc_parts
              else np.zeros(0, np.uint16))
    ac_all = np.asarray(ac_tokens, np.uint16)

    unknown_z = zlib.compress(bytes(unknown)) if unknown else b""
    if ac_all.size:
        from pcss_unet_tpu_torch.io.piz import huf_compress

        ac_z = huf_compress(ac_all)
    else:
        ac_z = b""
    dc_z = (zlib.compress(_zip_do_transform(dc_all.tobytes()))
            if dc_all.size else b"")
    if rle_bytes:
        rle_rle = _rle_compress(bytes(rle_bytes))
        rle_z = zlib.compress(rle_rle)
    else:
        rle_rle = b""
        rle_z = b""

    header = struct.pack(
        "<11Q", 2, len(unknown), len(unknown_z), len(ac_z), len(dc_z),
        len(rle_z), len(rle_rle), len(rle_bytes), ac_all.size, dc_all.size,
        AC_STATIC_HUFFMAN)
    return header + serialize_rules(rules) + unknown_z + ac_z + dc_z + rle_z


def dwa_decompress(payload: bytes, channels, width: int, n_lines: int
                   ) -> dict[str, np.ndarray]:
    """Decompress one chunk → {name: [n_lines, width] float32}."""
    from pcss_unet_tpu_torch.io.exr_py import _DTYPES, _rle_decompress, \
        _zip_undo_transform

    if len(payload) < 88:
        raise ValueError("truncated DWA chunk")
    (version, unk_usize, unk_csize, ac_csize, dc_csize, rle_csize,
     rle_usize, rle_raw, ac_count, dc_count, ac_comp) = struct.unpack_from(
        "<11Q", payload, 0)
    pos = 88
    rules: list[Rule] | tuple[Rule, ...] = DEFAULT_RULES
    if version >= 2:
        (rule_size,) = struct.unpack_from("<H", payload, pos)
        if rule_size < 2 or pos + rule_size > len(payload):
            raise ValueError("corrupt DWA channel-rules block")
        rules = parse_rules(payload[pos + 2: pos + rule_size])
        pos += rule_size
    unknown = zlib.decompress(payload[pos:pos + unk_csize]) \
        if unk_csize else b""
    pos += unk_csize
    ac_blob = payload[pos:pos + ac_csize]
    pos += ac_csize
    dc_blob = payload[pos:pos + dc_csize]
    pos += dc_csize
    rle_blob = payload[pos:pos + rle_csize]

    if ac_count:
        if ac_comp == AC_STATIC_HUFFMAN:
            from pcss_unet_tpu_torch.io.piz import huf_decompress

            ac_tokens = huf_decompress(ac_blob, int(ac_count))
        elif ac_comp == AC_DEFLATE:
            ac_tokens = np.frombuffer(zlib.decompress(ac_blob), np.uint16)
        else:
            raise ValueError(f"unknown DWA AC compression {ac_comp}")
    else:
        ac_tokens = np.zeros(0, np.uint16)
    dc_all = (np.frombuffer(
        _zip_undo_transform(bytearray(zlib.decompress(dc_blob))),
        np.uint16) if dc_count else np.zeros(0, np.uint16))
    rle_raw_bytes = (_rle_decompress(zlib.decompress(rle_blob),
                                     int(rle_raw)) if rle_csize else b"")

    schemes, units = classify(channels, rules)
    out: dict[str, np.ndarray] = {}
    blocks_per_plane = (-(-n_lines // 8)) * (-(-width // 8))
    dc_pos = 0
    ac_pos = 0
    for kind, idxs in units:
        zzs = []
        for _ in idxs:                         # DC: plane-sequential
            zz = np.zeros((blocks_per_plane, 64), np.uint16)
            zz[:, 0] = dc_all[dc_pos: dc_pos + blocks_per_plane]
            dc_pos += blocks_per_plane
            zzs.append(zz)
        for b in range(blocks_per_plane):      # AC: block-interleaved
            for zz in zzs:
                zz[b, 1:], ac_pos = _unrle_ac(ac_tokens, ac_pos)
        planes = [_dct_inverse(zz, n_lines, width) for zz in zzs]
        if kind == "csc":
            planes = list(_csc709_inverse(*planes))
        for i, plane in zip(idxs, planes):
            lin = _TO_LINEAR[plane.astype(np.float16).view(np.uint16)]
            out[channels[i].name] = \
                lin.view(np.float16).astype(np.float32)

    rpos = 0
    npix = n_lines * width
    for i, ch in enumerate(channels):
        if schemes[i] != _RLE:
            continue
        dt = _DTYPES[ch.pixel_type]
        nb = dt.itemsize
        planes8 = [np.frombuffer(rle_raw_bytes, np.uint8, npix,
                                 rpos + k * npix) for k in range(nb)]
        rpos += nb * npix
        vals = np.zeros(npix, np.uint32)
        for k in range(nb):                    # LSB byte plane first
            vals |= planes8[k].astype(np.uint32) << (8 * k)
        if nb == 2:
            arr = vals.astype(np.uint16).view(np.float16).astype(np.float32)
        elif ch.pixel_type == 0:               # UINT
            arr = vals.astype(np.float32)
        else:                                  # FLOAT via RLE (A:float)
            arr = vals.view(np.float32).copy()
        out[ch.name] = arr.reshape(n_lines, width)

    upos = 0
    for i, ch in enumerate(channels):
        if schemes[i] != _UNKNOWN:
            continue
        dt = _DTYPES[ch.pixel_type]
        nb = npix * dt.itemsize
        vals = np.frombuffer(unknown, dt, npix, upos)
        upos += nb
        out[ch.name] = vals.astype(np.float32).reshape(n_lines, width)
    return out
