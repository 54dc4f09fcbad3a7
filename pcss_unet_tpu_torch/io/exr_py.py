"""Pure-Python OpenEXR 2.0 scanline codec (numpy + zlib); the port's copy of
``pcss_unet_tpu/io/exr_py.py``, held to it by ``tests/test_torch_io.py``.

The reference reads G-buffer stacks through the third-party ``OpenEXR``/
``Imath`` C++ bindings (setdata.py:42-58); the repo does not depend on
them, so it ships its own codec: this portable implementation
plus a faster native C++ twin (``native/exr/exr_codec.cpp``, wrapped by
``pcss_unet_tpu_torch.io.exr``).  Both implement the subset the pipeline needs:

- single-part scanline files, version 2
- single-part TILED files, all three level modes: ONE_LEVEL, and
  MIPMAP_LEVELS / RIPMAP_LEVELS (both rounding modes) where the full-
  resolution level (0,0) is decoded and the low-res pyramid levels are
  skipped — exactly the plane the reference's OpenEXR bindings expose when
  reading such files as images (setdata.py:42); the writer can also emit
  mip/rip pyramids (point-sampled levels) via ``level_mode=``
- MULTI-PART files (version flag 0x1000, pixel parts only — deep parts
  rejected loudly): readers default to part 0, matching what the
  reference's ``OpenEXR.InputFile`` exposes on a multi-part file, with
  index/name selection via ``part=``; ``write_exr_multipart_py`` writes
  them (name/type/chunkCount attrs, part-number chunk prefixes,
  back-to-back offset tables)
- compression: NONE, RLE, ZIPS, ZIP (16 lines/chunk), PIZ (32 lines/chunk,
  wavelet + Huffman — io/piz.py), PXR24 (lossy 24-bit floats, lossless
  HALF/UINT), B44/B44A (32 lines/chunk, fixed-rate lossy 4×4 half blocks
  — io/b44.py), DWAA/DWAB (32/256 lines/chunk, lossy 8×8 DCT — io/dwa.py);
  B44/DWA decode also lives in the native codec (encode is Python-only;
  the dispatcher falls back transparently); for tiled files every scheme
  compresses whole tiles
- pixel types: HALF, FLOAT, UINT
- INCREASING_Y line order

ZIP chunks use OpenEXR's reorder+delta byte transform before deflate
(see OpenEXR ImfZip.cpp semantics, re-derived here from the file format
spec, not copied).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

MAGIC = 20000630
PT_UINT, PT_HALF, PT_FLOAT = 0, 1, 2
_DTYPES = {PT_UINT: np.dtype("<u4"), PT_HALF: np.dtype("<f2"),
           PT_FLOAT: np.dtype("<f4")}
COMP_NONE, COMP_RLE, COMP_ZIPS, COMP_ZIP, COMP_PIZ, COMP_PXR24 = 0, 1, 2, 3, 4, 5
COMP_B44, COMP_B44A, COMP_DWAA, COMP_DWAB = 6, 7, 8, 9
_LINES_PER_CHUNK = {COMP_NONE: 1, COMP_RLE: 1, COMP_ZIPS: 1, COMP_ZIP: 16,
                    COMP_PIZ: 32, COMP_PXR24: 16, COMP_B44: 32, COMP_B44A: 32,
                    COMP_DWAA: 32, COMP_DWAB: 256}


def _float_to_f24(bits: np.ndarray) -> np.ndarray:
    """float32 bit pattern → rounded 24-bit representation (drop the low
    mantissa byte with round-to-nearest; NaNs keep a non-zero mantissa)."""
    sign_exp_mant = bits.astype(np.uint32)
    exp = (sign_exp_mant >> 23) & 0xFF
    rounded = ((sign_exp_mant >> 8) & 0xFFFFFF) + ((sign_exp_mant >> 7) & 1)
    # rounding may carry into the exponent — that matches OpenEXR behavior
    # except for NaN/Inf, which must stay NaN/Inf
    special = exp == 255
    truncated = (sign_exp_mant >> 8) & 0xFFFFFF
    nan_fix = np.where((sign_exp_mant & 0x7FFFFF) != 0,
                       truncated | 1, truncated)
    return np.where(special, nan_fix, np.minimum(rounded, 0xFFFFFF)
                    ).astype(np.uint32)


def _pxr24_encode_rows(arrs, pixel_type, y0, n_lines, width) -> bytes:
    """Per-scanline, per-channel byte planes of running-differenced pixels
    (PXR24 layout: FLOAT → 3 planes of 24-bit diffs; HALF → 2 planes)."""
    out = bytearray()
    for line in range(n_lines):
        for arr in arrs:
            if pixel_type == PT_FLOAT:
                bits = arr[y0 + line].view(np.uint32)
                p24 = _float_to_f24(bits)
                diffs = np.diff(p24, prepend=np.uint32(0)).astype(np.uint32)
                out += (diffs >> 16).astype(np.uint8).tobytes()
                out += (diffs >> 8).astype(np.uint8).tobytes()
                out += diffs.astype(np.uint8).tobytes()
            else:  # HALF
                bits = arr[y0 + line].view(np.uint16).astype(np.uint32)
                diffs = np.diff(bits, prepend=np.uint32(0)).astype(np.uint32)
                out += (diffs >> 8).astype(np.uint8).tobytes()
                out += diffs.astype(np.uint8).tobytes()
    return bytes(out)


def _pxr24_decode_rows(raw: bytes, channels, width, n_lines):
    """Inverse of _pxr24_encode_rows → {channel: [n_lines, width] float32}."""
    out = {ch.name: np.empty((n_lines, width), np.float32)
           for ch in channels}
    pos = 0
    for line in range(n_lines):
        for ch in channels:
            if ch.pixel_type == PT_FLOAT:
                b0 = np.frombuffer(raw, np.uint8, width, pos)
                b1 = np.frombuffer(raw, np.uint8, width, pos + width)
                b2 = np.frombuffer(raw, np.uint8, width, pos + 2 * width)
                pos += 3 * width
                diffs = ((b0.astype(np.uint32) << 16)
                         | (b1.astype(np.uint32) << 8) | b2)
                p24 = np.cumsum(diffs.astype(np.uint64)).astype(np.uint32) \
                    & 0xFFFFFF
                bits = (p24 << 8).astype(np.uint32)
                out[ch.name][line] = bits.view(np.float32)
            elif ch.pixel_type == PT_HALF:
                b0 = np.frombuffer(raw, np.uint8, width, pos)
                b1 = np.frombuffer(raw, np.uint8, width, pos + width)
                pos += 2 * width
                diffs = (b0.astype(np.uint32) << 8) | b1
                bits = (np.cumsum(diffs.astype(np.uint64)).astype(np.uint32)
                        & 0xFFFF).astype(np.uint16)
                out[ch.name][line] = bits.view(np.float16).astype(np.float32)
            else:  # UINT: 4 planes
                planes = [np.frombuffer(raw, np.uint8, width,
                                        pos + k * width).astype(np.uint64)
                          for k in range(4)]
                pos += 4 * width
                diffs = ((planes[0] << 24) | (planes[1] << 16)
                         | (planes[2] << 8) | planes[3])
                vals = np.cumsum(diffs).astype(np.uint32)
                out[ch.name][line] = vals.astype(np.float32)
    return out


def _rle_decompress(data: bytes, expected: int) -> bytes:
    """EXR RLE: signed count byte; n<0 → −n literal bytes follow, n≥0 →
    repeat the next byte n+1 times.  Applied to the reorder+delta stream
    (same byte transform as ZIP)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        count = data[i]
        i += 1
        if count > 127:          # signed negative: literal run
            run = 256 - count
            out += data[i:i + run]
            i += run
        else:                    # repeat run
            out += data[i:i + 1] * (count + 1)
            i += 1
    return bytes(out)


def _rle_compress(data: bytes) -> bytes:
    """Greedy EXR RLE encoder (repeat runs ≥3, literal otherwise)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        run = 1
        while i + run < n and data[i + run] == data[i] and run < 127:
            run += 1
        if run >= 3:
            out.append(run - 1)
            out.append(data[i])
            i += run
        else:
            start = i
            while (i < n and i - start < 127
                   and not (i + 2 < n and data[i] == data[i + 1] == data[i + 2])):
                i += 1
            length = i - start
            out.append(256 - length)
            out += data[start:i]
    return bytes(out)


def _round_log2(x: int, rounding: int) -> int:
    """floor(log2(x)) under ROUND_DOWN (0) or ceil(log2(x)) under ROUND_UP
    (1) — the tiledesc rounding mode's definition of the level count."""
    return (x - 1).bit_length() if rounding else x.bit_length() - 1


def _level_size(size: int, level: int, rounding: int) -> int:
    """Pixel extent of pyramid level ``level`` along one axis."""
    d = 1 << level
    s = -(-size // d) if rounding else size // d
    return max(1, s)


def _tile_levels(w: int, h: int, level_mode: int,
                 rounding: int) -> list[tuple[int, int]]:
    """All (levelX, levelY) pairs a tiled file stores, in canonical order
    (level 0,0 — the full-resolution plane — first)."""
    if level_mode == 0:                       # ONE_LEVEL
        return [(0, 0)]
    if level_mode == 1:                       # MIPMAP_LEVELS: lx == ly
        n = _round_log2(max(w, h), rounding) + 1
        return [(l, l) for l in range(n)]
    nx = _round_log2(w, rounding) + 1         # RIPMAP_LEVELS: full grid
    ny = _round_log2(h, rounding) + 1
    return [(lx, ly) for ly in range(ny) for lx in range(nx)]


def _tiled_chunk_count(w: int, h: int, tw: int, th: int, level_mode: int,
                       rounding: int) -> int:
    """Total tile chunks across every level — the offset-table length."""
    return sum((-(-_level_size(w, lx, rounding) // tw))
               * (-(-_level_size(h, ly, rounding) // th))
               for lx, ly in _tile_levels(w, h, level_mode, rounding))


@dataclass
class _Channel:
    name: str
    pixel_type: int
    x_sampling: int = 1
    y_sampling: int = 1


def _read_cstr(buf: bytes, pos: int) -> tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_chlist(data: bytes) -> list[_Channel]:
    chans = []
    pos = 0
    while pos < len(data) and data[pos] != 0:
        name, pos = _read_cstr(data, pos)
        ptype, xs, ys = struct.unpack_from("<i4xii", data, pos)
        pos += 16
        chans.append(_Channel(name, ptype, xs, ys))
    return chans


def _zip_undo_transform(raw: bytearray) -> bytes:
    """Invert OpenEXR's reorder+delta: delta-decode, then interleave the
    two halves."""
    arr = np.frombuffer(bytes(raw), np.uint8).astype(np.int32)
    # delta decode: t[i] = t[i-1] + t[i] - 128 (mod 256)
    deltas = (arr - 128) % 256
    deltas[0] = arr[0]
    decoded = np.cumsum(deltas).astype(np.uint8)
    # de-interleave: first half = even output positions
    n = decoded.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = decoded[:half]
    out[1::2] = decoded[half:]
    return out.tobytes()


def _zip_do_transform(data: bytes) -> bytes:
    """Forward reorder+delta used before deflate when writing ZIP/ZIPS."""
    arr = np.frombuffer(data, np.uint8)
    n = arr.size
    half = (n + 1) // 2
    split = np.empty(n, np.uint8)
    split[:half] = arr[0::2]
    split[half:] = arr[1::2]
    s32 = split.astype(np.int32)
    deltas = np.empty(n, np.int32)
    deltas[0] = s32[0]
    deltas[1:] = (s32[1:] - s32[:-1] + 128) % 256
    return deltas.astype(np.uint8).tobytes()


def _read_attrs(data: bytes, pos: int) -> tuple[dict[str, tuple[str, bytes]], int]:
    """Read one header (attribute list up to its null terminator)."""
    attrs: dict[str, tuple[str, bytes]] = {}
    while True:
        name, pos = _read_cstr(data, pos)
        if not name:
            break
        atype, pos = _read_cstr(data, pos)
        size = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        attrs[name] = (atype, data[pos:pos + size])
        pos += size
    return attrs, pos


class ExrFile:
    """Parsed single- or multi-part EXR (pixel parts; deep rejected).

    For multi-part files ``part`` selects which part to expose — an index
    or a part name — defaulting to part 0, which is what the reference's
    ``OpenEXR.InputFile`` bindings read from a multi-part file
    (setdata.py:42)."""

    def __init__(self, data: bytes, part: int | str = 0):
        if len(data) < 8:
            raise ValueError("not an EXR file (truncated header)")
        if struct.unpack_from("<i", data, 0)[0] != MAGIC:
            raise ValueError("not an EXR file (bad magic)")
        version = struct.unpack_from("<i", data, 4)[0]
        # version-field flags: 0x200 tiled, 0x400 long names (harmless),
        # 0x800 deep data, 0x1000 multi-part
        self.tiled = bool(version & 0x200)
        self.multipart = bool(version & 0x1000)
        if version & 0x800:
            raise ValueError("deep-data EXR not supported")
        pos = 8
        if self.multipart:
            headers: list[dict] = []
            while data[pos] != 0:
                attrs, pos = _read_attrs(data, pos)
                headers.append(attrs)
            pos += 1  # empty header terminating the list
            names = [h.get("name", ("", b""))[1].decode("latin-1")
                     for h in headers]
            if isinstance(part, str):
                if part not in names:
                    raise ValueError(f"no part named {part!r} "
                                     f"(parts: {names})")
                part = names.index(part)
            if not 0 <= part < len(headers):
                raise ValueError(f"part {part} out of range "
                                 f"({len(headers)} parts)")
            self.part_names = names
            self.attrs = headers[part]
            ptype = self.attrs.get("type", ("", b""))[1].rstrip(b"\x00")
            if ptype in (b"deepscanline", b"deeptile"):
                raise ValueError("deep-data EXR part not supported")
            self.tiled = ptype == b"tiledimage"
            counts = [struct.unpack("<i", h["chunkCount"][1])[0]
                      for h in headers]
            # offset tables are stored back-to-back in part order
            pos += 8 * sum(counts[:part])
            self._n_chunks_forced = counts[part]
            self._chunk_prefix = 4  # every chunk leads with its part number
        else:
            self.attrs, pos = _read_attrs(data, pos)
            self.part_names = [
                self.attrs.get("name", ("", b""))[1].decode("latin-1")]
            # part selection on a single-part file must not silently hand
            # back part 0 (the multi-part path raises for bad selections)
            if part != 0 and part != self.part_names[0]:
                raise ValueError(
                    f"part {part!r} selected on a single-part file")
            self._n_chunks_forced = None
            self._chunk_prefix = 0
        self.channels = _parse_chlist(self.attrs["channels"][1])
        for c in self.channels:
            # subsampled (Y'CbCr-style) channels would silently decode
            # garbage through the dense scanline math — reject loudly
            if c.x_sampling != 1 or c.y_sampling != 1:
                raise ValueError(
                    f"subsampled channel {c.name!r} (sampling "
                    f"{c.x_sampling}x{c.y_sampling}) not supported")
        self.compression = self.attrs["compression"][1][0]
        if self.compression not in _LINES_PER_CHUNK:
            raise ValueError(f"unsupported EXR compression {self.compression} "
                             "(supported: NONE, RLE, ZIPS, ZIP, PIZ, PXR24, "
                             "B44, B44A, DWAA, DWAB)")
        xmin, ymin, xmax, ymax = struct.unpack("<4i", self.attrs["dataWindow"][1])
        self.width = xmax - xmin + 1
        self.height = ymax - ymin + 1
        self.y_min = ymin
        if self.tiled:
            if "tiles" not in self.attrs:
                raise ValueError("tiled EXR missing 'tiles' attribute")
            tw, th, mode = struct.unpack_from("<IIB", self.attrs["tiles"][1])
            self.level_mode = mode & 0xF
            self.level_rounding = (mode >> 4) & 0xF
            if self.level_mode > 2:
                raise ValueError(
                    f"bad tiledesc level mode {self.level_mode} "
                    "(0=ONE_LEVEL, 1=MIPMAP, 2=RIPMAP)")
            self.tile_w, self.tile_h = int(tw), int(th)
            n_chunks = _tiled_chunk_count(self.width, self.height,
                                          self.tile_w, self.tile_h,
                                          self.level_mode,
                                          self.level_rounding)
            lpc = self.tile_h
        else:
            lpc = _LINES_PER_CHUNK[self.compression]
            n_chunks = (self.height + lpc - 1) // lpc
        if self._n_chunks_forced is not None:
            n_chunks = self._n_chunks_forced
        self._chunk_offsets = struct.unpack_from(f"<{n_chunks}q", data, pos)
        self._data = data
        self._lpc = lpc

    def header(self) -> dict:
        h = {
            "dataWindow": struct.unpack("<4i", self.attrs["dataWindow"][1]),
            "channels": {c.name: c.pixel_type for c in self.channels},
            "compression": self.compression,
            "size": (self.height, self.width),
        }
        if self.tiled:
            h["tiles"] = (self.tile_w, self.tile_h)
        return h

    def _decode_block(self, payload: bytes, width: int, n_lines: int,
                      wanted: set) -> dict[str, np.ndarray]:
        """Decode one compressed block — a scanline chunk or a tile —
        covering ``n_lines`` rows of ``width`` pixels.
        → {name: [n_lines, width] float32} for channels in ``wanted``."""
        if self.compression == COMP_PXR24:
            raw = zlib.decompress(payload)
            decoded = _pxr24_decode_rows(raw, self.channels, width, n_lines)
            return {k: v for k, v in decoded.items() if k in wanted}
        row_nbytes = [width * _DTYPES[ch.pixel_type].itemsize
                      for ch in self.channels]
        raw_size = sum(row_nbytes) * n_lines
        if self.compression == COMP_NONE or len(payload) >= raw_size:
            if len(payload) < raw_size:
                # matches the native codec's rejection (exr_codec.cpp
                # decode_block) so the differential contract holds on
                # crafted undersized COMP_NONE chunks
                raise IOError(
                    f"uncompressed chunk shorter than its line block "
                    f"({len(payload)} < {raw_size} bytes)")
            raw = payload   # stored raw (incompressible block)
        elif self.compression in (COMP_DWAA, COMP_DWAB):
            from pcss_unet_tpu_torch.io.dwa import dwa_decompress

            decoded = dwa_decompress(payload, self.channels, width, n_lines)
            return {k: v for k, v in decoded.items() if k in wanted}
        elif self.compression in (COMP_B44, COMP_B44A):
            from pcss_unet_tpu_torch.io.b44 import b44_decompress

            decoded = b44_decompress(payload, self.channels, width, n_lines)
            return {k: v for k, v in decoded.items() if k in wanted}
        elif self.compression == COMP_PIZ:
            from pcss_unet_tpu_torch.io.piz import piz_decompress

            raw = piz_decompress(payload, self.channels, width, n_lines)
        elif self.compression == COMP_RLE:
            raw = _zip_undo_transform(
                bytearray(_rle_decompress(payload, raw_size)))
        else:
            raw = _zip_undo_transform(bytearray(zlib.decompress(payload)))
        out = {n: np.empty((n_lines, width), np.float32) for n in wanted}
        pos = 0
        for line in range(n_lines):
            for ch, nb in zip(self.channels, row_nbytes):
                if ch.name in out:
                    row = np.frombuffer(raw, _DTYPES[ch.pixel_type],
                                        count=width, offset=pos)
                    out[ch.name][line] = row.astype(np.float32)
                pos += nb
        return out

    def read_channels(self, names: list[str]) -> dict[str, np.ndarray | None]:
        """Decode the requested channels to float32 [H, W]; missing channels
        map to None (caller decides defaults, mirroring setdata.py:64-67)."""
        have = {c.name: c for c in self.channels}
        out = {n: (np.empty((self.height, self.width), np.float32)
                   if n in have else None) for n in names}
        wanted = {n for n in names if n in have}
        data = self._data
        pre = self._chunk_prefix  # multi-part chunks lead with a part number
        # Reject out-of-range / unaligned / duplicate blocks (matching the
        # native codec): a corrupt y or tile index would otherwise scatter
        # into the wrong rows (negative y0 wraps via negative indexing).
        seen_blocks: set = set()
        if self.tiled:
            ntx = (self.width + self.tile_w - 1) // self.tile_w
            nty = (self.height + self.tile_h - 1) // self.tile_h
            for off in self._chunk_offsets:
                off += pre
                # tile chunk: dx, dy, levelX, levelY, dataSize, payload
                dx, dy, lx, ly, size = struct.unpack_from("<5i", data, off)
                if lx or ly:
                    if self.level_mode == 0:
                        raise ValueError(f"unexpected tile level ({lx},{ly}) "
                                         "in ONE_LEVEL file")
                    continue  # full-res plane only; pyramid levels skipped
                if not (0 <= dx < ntx and 0 <= dy < nty):
                    raise ValueError(f"bad tile index ({dx},{dy})")
                if (dx, dy) in seen_blocks:
                    raise ValueError(f"duplicate tile ({dx},{dy})")
                seen_blocks.add((dx, dy))
                payload = data[off + 20: off + 20 + size]
                x0, y0 = dx * self.tile_w, dy * self.tile_h
                tw = min(self.tile_w, self.width - x0)
                th = min(self.tile_h, self.height - y0)
                for name, rows in self._decode_block(payload, tw, th,
                                                     wanted).items():
                    out[name][y0:y0 + th, x0:x0 + tw] = rows
            return out
        # channels are stored per scanline in chlist (alphabetical) order
        for off in self._chunk_offsets:
            off += pre
            y, size = struct.unpack_from("<ii", data, off)
            payload = data[off + 8: off + 8 + size]
            y0 = y - self.y_min
            if not 0 <= y0 < self.height:
                raise ValueError(f"chunk y {y} out of range")
            if y0 % self._lpc != 0:
                raise ValueError(
                    f"chunk y {y} not aligned to a line-block boundary")
            if y0 in seen_blocks:
                raise ValueError(f"duplicate chunk y {y}")
            seen_blocks.add(y0)
            n_lines = min(self._lpc, self.height - y0)
            for name, rows in self._decode_block(payload, self.width,
                                                 n_lines, wanted).items():
                out[name][y0:y0 + n_lines] = rows
        return out


def read_exr_channels_py(path: str, names: list[str],
                         part: int | str = 0) -> dict[str, np.ndarray | None]:
    with open(path, "rb") as f:
        return ExrFile(f.read(), part=part).read_channels(names)


def _compress_block(rows: bytes, arrs, names, compression: int,
                    pixel_type: int, width: int) -> bytes:
    """Compress one block (scanline chunk or tile).  ``rows`` is the
    row-interleaved raw bytes; ``arrs`` the per-channel [n_lines, width]
    arrays of the block (used by the planar PXR24 layout)."""
    if compression == COMP_NONE:
        return rows
    if compression == COMP_RLE:
        comp = _rle_compress(_zip_do_transform(rows))
    elif compression == COMP_PXR24:
        n_lines = arrs[0].shape[0]
        planes = _pxr24_encode_rows(arrs, pixel_type, 0, n_lines, width)
        return zlib.compress(planes)
    elif compression == COMP_PIZ:
        from pcss_unet_tpu_torch.io.piz import piz_compress

        chans = [_Channel(n, pixel_type) for n in names]
        comp = piz_compress(rows, chans, width, arrs[0].shape[0])
    elif compression in (COMP_DWAA, COMP_DWAB):
        from pcss_unet_tpu_torch.io.dwa import dwa_compress

        chans = [_Channel(n, pixel_type) for n in names]
        comp = dwa_compress({n: a for n, a in zip(names, arrs)}, chans,
                            width, arrs[0].shape[0])
    elif compression in (COMP_B44, COMP_B44A):
        from pcss_unet_tpu_torch.io.b44 import b44_compress

        chans = [_Channel(n, pixel_type) for n in names]
        comp = b44_compress({n: a for n, a in zip(names, arrs)}, chans,
                            width, arrs[0].shape[0],
                            flat_ok=compression == COMP_B44A)
    else:
        comp = zlib.compress(_zip_do_transform(rows))
    return comp if len(comp) < len(rows) else rows


def _attr(name: str, atype: str, payload: bytes) -> bytes:
    return (name.encode() + b"\x00" + atype.encode() + b"\x00"
            + struct.pack("<i", len(payload)) + payload)


def _prep_part(channels: dict[str, np.ndarray], compression: int,
               pixel_type: int, tile_size: tuple[int, int] | None,
               level_mode: int = 0, rounding: int = 0):
    """Validate + cast one part's channels, build its header attribute
    block (sans the part-specific name/type/chunkCount attrs and the
    terminating null) and its chunk list.
    -> (header_attrs: bytes, chunks: list[(chunk_hdr, payload)])."""
    names = sorted(channels)  # chlist must be alphabetical
    arrs = [np.asarray(channels[n]) for n in names]
    h, w = arrs[0].shape
    for a in arrs:
        if a.shape != (h, w):
            raise ValueError("all channels must share one shape")
    dt = _DTYPES[pixel_type]
    arrs = [np.ascontiguousarray(a.astype(dt)) for a in arrs]

    chlist = b""
    for n in names:
        chlist += n.encode() + b"\x00" + struct.pack("<i4xii", pixel_type, 1, 1)
    chlist += b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (
        _attr("channels", "chlist", chlist)
        + _attr("compression", "compression", bytes([compression]))
        + _attr("dataWindow", "box2i", box)
        + _attr("displayWindow", "box2i", box)
        + _attr("lineOrder", "lineOrder", b"\x00")
        + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
        + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    )
    chunks: list[tuple[bytes, bytes]] = []   # (chunk header, payload)
    if tile_size is not None:
        tw, th = int(tile_size[0]), int(tile_size[1])
        if tw <= 0 or th <= 0:
            raise ValueError(f"bad tile size {tile_size}")
        if not 0 <= level_mode <= 2:
            raise ValueError(f"bad level mode {level_mode}")
        header += _attr("tiles", "tiledesc",
                        struct.pack("<IIB", tw, th,
                                    level_mode | ((rounding & 1) << 4)))
        for lx, ly in _tile_levels(w, h, level_mode, rounding):
            lw = _level_size(w, lx, rounding)
            lh = _level_size(h, ly, rounding)
            # pyramid levels are point-sampled (the format stores whatever
            # the writing application provides; decoders here use level 0)
            lvl = [np.ascontiguousarray(a[::1 << ly, ::1 << lx][:lh, :lw])
                   for a in arrs]
            for dy in range(-(-lh // th)):
                for dx in range(-(-lw // tw)):
                    x0, y0 = dx * tw, dy * th
                    bw, bh = min(tw, lw - x0), min(th, lh - y0)
                    sub = [np.ascontiguousarray(a[y0:y0 + bh, x0:x0 + bw])
                           for a in lvl]
                    rows = b"".join(sub[k][line].tobytes()
                                    for line in range(bh)
                                    for k in range(len(sub)))
                    payload = _compress_block(rows, sub, names, compression,
                                              pixel_type, bw)
                    chunks.append((struct.pack("<5i", dx, dy, lx, ly,
                                               len(payload)), payload))
    else:
        lpc = _LINES_PER_CHUNK[compression]
        for ci in range((h + lpc - 1) // lpc):
            y0 = ci * lpc
            n_lines = min(lpc, h - y0)
            sub = [a[y0:y0 + n_lines] for a in arrs]
            rows = b"".join(sub[k][line].tobytes()
                            for line in range(n_lines)
                            for k in range(len(sub)))
            payload = _compress_block(rows, sub, names, compression,
                                      pixel_type, w)
            chunks.append((struct.pack("<ii", y0, len(payload)), payload))
    return header, chunks


def write_exr_py(path: str, channels: dict[str, np.ndarray],
                 compression: int = COMP_ZIP, pixel_type: int = PT_FLOAT,
                 tile_size: tuple[int, int] | None = None,
                 level_mode: int = 0, rounding: int = 0) -> None:
    """Write a single-part EXR — scanline by default, or tiled when
    ``tile_size=(tile_w, tile_h)`` is given (version flag 0x200 + 'tiles'
    tiledesc attribute; whole-tile compression).  ``level_mode`` selects
    ONE_LEVEL (0, default), MIPMAP_LEVELS (1) or RIPMAP_LEVELS (2) with
    ``rounding`` 0=down/1=up; pyramid levels are point-sampled."""
    header, chunks = _prep_part(channels, compression, pixel_type, tile_size,
                                level_mode=level_mode, rounding=rounding)
    header += b"\x00"
    version = 2 | (0x200 if tile_size is not None else 0)
    n_chunks = len(chunks)
    offsets = []
    pos = 8 + len(header) + 8 * n_chunks
    for chdr, payload in chunks:
        offsets.append(pos)
        pos += len(chdr) + len(payload)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC, version))
        f.write(header)
        f.write(struct.pack(f"<{n_chunks}q", *offsets))
        for chdr, payload in chunks:
            f.write(chdr)
            f.write(payload)


def write_exr_multipart_py(
        path: str, parts: list[tuple[str, dict[str, np.ndarray]]],
        compression: int = COMP_ZIP, pixel_type: int = PT_FLOAT,
        tile_size: tuple[int, int] | None = None) -> None:
    """Write a multi-part EXR (version flag 0x1000): ``parts`` is an
    ordered list of (part_name, channels) pairs.  Every part carries the
    mandated name/type/chunkCount attributes; each chunk leads with its
    part number; the per-part chunk-offset tables are stored back to back
    in part order.  Part names must be unique (format requirement)."""
    if len({n for n, _ in parts}) != len(parts):
        raise ValueError("multi-part EXR part names must be unique")
    ptype = b"tiledimage" if tile_size is not None else b"scanlineimage"
    headers: list[bytes] = []
    part_chunks: list[list[tuple[bytes, bytes]]] = []
    for part_name, channels in parts:
        hdr, chunks = _prep_part(channels, compression, pixel_type, tile_size)
        hdr += (_attr("name", "string", part_name.encode())
                + _attr("type", "string", ptype)
                + _attr("chunkCount", "int", struct.pack("<i", len(chunks))))
        headers.append(hdr + b"\x00")
        part_chunks.append(chunks)
    header_block = b"".join(headers) + b"\x00"  # empty header ends the list
    n_total = sum(len(c) for c in part_chunks)
    pos = 8 + len(header_block) + 8 * n_total
    offset_tables: list[list[int]] = []
    for pi, chunks in enumerate(part_chunks):
        offsets = []
        for chdr, payload in chunks:
            offsets.append(pos)
            pos += 4 + len(chdr) + len(payload)  # 4: part-number prefix
        offset_tables.append(offsets)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", MAGIC, 2 | 0x1000))
        f.write(header_block)
        for offsets in offset_tables:
            f.write(struct.pack(f"<{len(offsets)}q", *offsets))
        for pi, chunks in enumerate(part_chunks):
            for chdr, payload in chunks:
                f.write(struct.pack("<i", pi))
                f.write(chdr)
                f.write(payload)
