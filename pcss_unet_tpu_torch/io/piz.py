"""PIZ compression for the EXR codecs (encode + decode, pure numpy).

PIZ is OpenEXR's wavelet+Huffman codec and the most common renderer default;
the reference reads EXRs through the OpenEXR bindings which accept it
transparently (setdata.py:42).  Implemented here from the OpenEXR file
format specification (bitmap/LUT indexing, the 2-D integer wavelet, the
canonical Huffman coding with the run-length pseudo-symbol) — NOT a copy of
ImfPizCompressor; everything is vectorized numpy where the format allows.

A PIZ-compressed chunk (32 scanlines) is:

    u16 minNonZero, u16 maxNonZero          (used range of the bitmap)
    bitmap[minNonZero..maxNonZero]          (bit per occurring u16 value;
                                             value 0 is implicit)
    i32 length                              (byte length of Huffman data)
    Huffman data:
        u32 im, u32 iM, u32 tableLength, u32 nBits, u32 reserved(0)
        packed code-length table for symbols im..iM (6-bit lengths,
        zero-run escapes 59..63)
        nBits of canonical-Huffman-coded data, MSB-first; symbol iM is the
        run-length marker (next 8 bits = extra repeats of previous symbol)

Before Huffman coding, the block's channel data is arranged planar per
channel (ny rows × nx·size u16s, size = bytes/2 per sample), LUT-indexed
through the bitmap, and each u16-component column is wavelet-transformed
in 2-D (the 14-bit integer lifting pair, or the mod-2^16 pair when more
than 2^14 distinct values occur).

Correctness is pinned by roundtrip + cross-backend differential tests
(tests/test_exr.py); there is no OpenEXR oracle on this image.
"""

from __future__ import annotations

import struct

import numpy as np

USHORT_RANGE = 1 << 16
BITMAP_SIZE = USHORT_RANGE >> 3
HUF_ENCSIZE = USHORT_RANGE + 1          # data symbols + run-length marker

# packed code-length table escapes
_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN   # 6
_LONGEST_LONG_RUN = 255 + _SHORTEST_LONG_RUN


# ---------------------------------------------------------------------------
# bitmap / LUT
# ---------------------------------------------------------------------------

def bitmap_from_data(data: np.ndarray) -> tuple[np.ndarray, int, int]:
    """→ (bitmap u8[8192], minNonZero, maxNonZero).  Bit per occurring u16
    value; the bit for value 0 is never stored (implicitly present)."""
    present = np.zeros(USHORT_RANGE, np.bool_)
    present[data] = True
    present[0] = False                      # zero is implicit
    bitmap = np.packbits(present.reshape(-1, 8)[:, ::-1], axis=1,
                         bitorder="big").reshape(-1)
    nz = np.flatnonzero(bitmap)
    if nz.size == 0:
        return bitmap, BITMAP_SIZE - 1, 0   # min > max → empty range
    return bitmap, int(nz[0]), int(nz[-1])


def forward_lut_from_bitmap(bitmap: np.ndarray) -> tuple[np.ndarray, int]:
    """→ (lut u16[65536] mapping value→index, maxValue)."""
    present = np.unpackbits(bitmap.reshape(-1, 1), axis=1,
                            bitorder="little").reshape(-1).astype(bool)
    present[0] = True
    lut = np.zeros(USHORT_RANGE, np.uint16)
    k = np.cumsum(present) - 1
    lut[present] = k[present].astype(np.uint16)
    return lut, int(k[-1])


def reverse_lut_from_bitmap(bitmap: np.ndarray) -> tuple[np.ndarray, int]:
    """→ (lut u16[65536] mapping index→value, maxValue)."""
    present = np.unpackbits(bitmap.reshape(-1, 1), axis=1,
                            bitorder="little").reshape(-1).astype(bool)
    present[0] = True
    values = np.flatnonzero(present).astype(np.uint16)
    lut = np.zeros(USHORT_RANGE, np.uint16)
    lut[: values.size] = values
    return lut, int(values.size - 1)


# ---------------------------------------------------------------------------
# 2-D integer wavelet (14-bit lifting pair / mod-2^16 pair)
# ---------------------------------------------------------------------------

def _wenc14(a, b):
    a_s = a.astype(np.int16).astype(np.int32)
    b_s = b.astype(np.int16).astype(np.int32)
    m = (a_s + b_s) >> 1
    d = a_s - b_s
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec14(l, h):
    l_s = l.astype(np.int16).astype(np.int32)
    h_s = h.astype(np.int16).astype(np.int32)
    a = l_s + (h_s & 1) + (h_s >> 1)
    b = a - h_s
    return a.astype(np.uint16), b.astype(np.uint16)


_A_OFFSET = 1 << 15
_MOD_MASK = (1 << 16) - 1


def _wenc16(a, b):
    ao = (a.astype(np.int32) + _A_OFFSET) & _MOD_MASK
    b32 = b.astype(np.int32)
    m = (ao + b32) >> 1
    d = ao - b32
    m = np.where(d < 0, (m + _A_OFFSET) & _MOD_MASK, m)
    return m.astype(np.uint16), (d & _MOD_MASK).astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    b = (m - (d >> 1)) & _MOD_MASK
    a = (d + b - _A_OFFSET) & _MOD_MASK
    return a.astype(np.uint16), b.astype(np.uint16)


def wav2_encode(a: np.ndarray, max_value: int) -> None:
    """In-place 2-D wavelet transform of a u16 [ny, nx] plane."""
    enc = _wenc14 if max_value < (1 << 14) else _wenc16
    ny, nx = a.shape
    n = min(nx, ny)
    p, p2 = 1, 2
    while p2 <= n:
        rows = np.arange(0, ny - p2 + 1, p2)
        cols = np.arange(0, nx - p2 + 1, p2)
        if rows.size and cols.size:
            r, c = np.ix_(rows, cols)
            v00, v01 = a[r, c], a[r, c + p]
            v10, v11 = a[r + p, c], a[r + p, c + p]
            i00, i01 = enc(v00, v01)              # horizontal
            i10, i11 = enc(v10, v11)
            a[r, c], a[r + p, c] = enc(i00, i10)  # vertical
            a[r, c + p], a[r + p, c + p] = enc(i01, i11)
        if (nx & p) and rows.size:
            c_odd = (nx // p2) * p2
            m, d = enc(a[rows, c_odd], a[rows + p, c_odd])
            a[rows, c_odd], a[rows + p, c_odd] = m, d
        if (ny & p) and cols.size:
            r_odd = (ny // p2) * p2
            m, d = enc(a[r_odd, cols], a[r_odd, cols + p])
            a[r_odd, cols], a[r_odd, cols + p] = m, d
        p, p2 = p2, p2 << 1


def wav2_decode(a: np.ndarray, max_value: int) -> None:
    """In-place inverse of :func:`wav2_encode`."""
    dec = _wdec14 if max_value < (1 << 14) else _wdec16
    ny, nx = a.shape
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2, p = p, p >> 1
    while p >= 1:
        rows = np.arange(0, ny - p2 + 1, p2)
        cols = np.arange(0, nx - p2 + 1, p2)
        if rows.size and cols.size:
            r, c = np.ix_(rows, cols)
            v00, v01 = a[r, c], a[r, c + p]
            v10, v11 = a[r + p, c], a[r + p, c + p]
            i00, i10 = dec(v00, v10)              # vertical
            i01, i11 = dec(v01, v11)
            a[r, c], a[r, c + p] = dec(i00, i01)  # horizontal
            a[r + p, c], a[r + p, c + p] = dec(i10, i11)
        if (nx & p) and rows.size:
            c_odd = (nx // p2) * p2
            aa, bb = dec(a[rows, c_odd], a[rows + p, c_odd])
            a[rows, c_odd], a[rows + p, c_odd] = aa, bb
        if (ny & p) and cols.size:
            r_odd = (ny // p2) * p2
            aa, bb = dec(a[r_odd, cols], a[r_odd, cols + p])
            a[r_odd, cols], a[r_odd, cols + p] = aa, bb
        p2, p = p, p >> 1


# ---------------------------------------------------------------------------
# canonical Huffman with run-length pseudo-symbol
# ---------------------------------------------------------------------------

def _build_code_lengths(freq: dict[int, int]) -> dict[int, int]:
    """Optimal prefix-code lengths (heap Huffman); flattened if any length
    would exceed the format's 58-bit ceiling."""
    import heapq

    while True:
        if len(freq) == 1:
            (sym,) = freq
            return {sym: 1}
        heap = [(f, sym, None, None) for sym, f in freq.items()]
        heapq.heapify(heap)
        counter = 0
        while len(heap) > 1:
            f1 = heapq.heappop(heap)
            f2 = heapq.heappop(heap)
            counter += 1
            heapq.heappush(heap, (f1[0] + f2[0], USHORT_RANGE + counter,
                                  f1, f2))
        lengths: dict[int, int] = {}
        stack = [(heap[0], 0)]
        while stack:
            (f, sym, left, right), depth = stack.pop()
            if left is None:
                lengths[sym] = max(depth, 1)
            else:
                stack.append((left, depth + 1))
                stack.append((right, depth + 1))
        if max(lengths.values()) <= 58:
            return lengths
        freq = {s: (f + 1) >> 1 for s, f in freq.items()}   # flatten


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """OpenEXR canonical code assignment from code lengths.
    lengths: i64[HUF_ENCSIZE] (0 = unused) → codes i64 (code << 6 | len)."""
    count = np.bincount(lengths, minlength=59)
    c = 0
    first = np.zeros(59, np.int64)
    for i in range(58, 0, -1):
        first[i] = c
        c = (c + count[i]) >> 1
    codes = np.zeros(lengths.size, np.int64)
    next_code = first.copy()
    used = np.flatnonzero(lengths)
    # canonical order: ascending symbol within each length
    for sym in used:
        ln = lengths[sym]
        codes[sym] = (next_code[ln] << 6) | ln
        next_code[ln] += 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.c = 0
        self.lc = 0

    def write(self, nbits: int, value: int) -> None:
        self.c = (self.c << nbits) | value
        self.lc += nbits
        while self.lc >= 8:
            self.lc -= 8
            self.out.append((self.c >> self.lc) & 0xFF)

    def flush(self) -> None:
        if self.lc:
            self.out.append((self.c << (8 - self.lc)) & 0xFF)
            self.lc = 0


class _BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.c = 0
        self.lc = 0

    def read(self, nbits: int) -> int:
        while self.lc < nbits:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= nbits
        return (self.c >> self.lc) & ((1 << nbits) - 1)


def _pack_enc_table(lengths: np.ndarray, im: int, i_m: int) -> bytes:
    w = _BitWriter()
    i = im
    while i <= i_m:
        ln = int(lengths[i])
        if ln == 0:
            zerun = 1
            while i + zerun <= i_m and zerun < _LONGEST_LONG_RUN \
                    and lengths[i + zerun] == 0:
                zerun += 1
            if zerun >= _SHORTEST_LONG_RUN:
                w.write(6, _LONG_ZEROCODE_RUN)
                w.write(8, zerun - _SHORTEST_LONG_RUN)
                i += zerun
                continue
            if zerun >= 2:
                w.write(6, _SHORT_ZEROCODE_RUN + zerun - 2)
                i += zerun
                continue
        w.write(6, ln)
        i += 1
    w.flush()
    return bytes(w.out)


def _unpack_enc_table(data: bytes, pos: int, im: int, i_m: int
                      ) -> tuple[np.ndarray, int]:
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    r = _BitReader(data, pos)
    i = im
    while i <= i_m:
        ln = r.read(6)
        if ln == _LONG_ZEROCODE_RUN:
            zerun = r.read(8) + _SHORTEST_LONG_RUN
            i += zerun
        elif ln >= _SHORT_ZEROCODE_RUN:
            i += ln - _SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = ln
            i += 1
    if i > i_m + 1:
        raise ValueError("corrupt PIZ Huffman table (zero-run overflow)")
    return lengths, r.pos


def huf_compress(data: np.ndarray) -> bytes:
    """u16 array → Huffman blob (20-byte header + table + bitstream)."""
    data = np.ascontiguousarray(data, np.uint16)
    n = data.size
    if n == 0:
        return b""
    counts = np.bincount(data, minlength=USHORT_RANGE)
    i_m = int(np.flatnonzero(counts)[-1]) + 1          # run-length marker
    freq = {int(s): int(counts[s]) for s in np.flatnonzero(counts)}
    freq[i_m] = 1
    im = min(freq)
    length_map = _build_code_lengths(freq)
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    for s, ln in length_map.items():
        lengths[s] = ln
    codes = _canonical_codes(lengths)
    table = _pack_enc_table(lengths, im, i_m)

    w = _BitWriter()

    def put(sym: int) -> None:
        c = codes[sym]
        w.write(int(c & 63), int(c >> 6))

    # run-length encode: marker = i_m, its 8-bit operand = ADDITIONAL
    # repeats of the symbol just emitted (≤255 per marker)
    flat = data.reshape(-1)
    boundaries = np.flatnonzero(np.diff(flat)) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [n]))
    rl_cost = int(codes[i_m] & 63) + 8
    for s, e in zip(starts, ends):
        sym = int(flat[s])
        total_run = int(e - s)
        sym_len = int(codes[sym] & 63)
        while total_run > 0:
            chunk = min(total_run, 256)       # occurrences in this chunk
            cs = chunk - 1                    # additional repeats
            if cs > 0 and sym_len + rl_cost < sym_len * chunk:
                put(sym)
                put(i_m)
                w.write(8, cs)
            else:
                for _ in range(chunk):
                    put(sym)
            total_run -= chunk
    n_bits = len(w.out) * 8 + w.lc
    w.flush()
    header = struct.pack("<5I", im, i_m, len(table), n_bits, 0)
    return header + table + bytes(w.out)


def huf_decompress(blob: bytes, n_out: int) -> np.ndarray:
    """Inverse of :func:`huf_compress` → u16[n_out]."""
    if n_out == 0:
        return np.zeros(0, np.uint16)
    if len(blob) < 20:
        raise ValueError("corrupt PIZ chunk (huffman header truncated)")
    im, i_m, table_len, n_bits, _ = struct.unpack_from("<5I", blob, 0)
    if not (0 <= im < HUF_ENCSIZE and 0 <= i_m < HUF_ENCSIZE):
        raise ValueError("corrupt PIZ chunk (bad symbol range)")
    lengths, data_pos = _unpack_enc_table(blob, 20, im, i_m)
    if n_bits > 8 * (len(blob) - data_pos):
        raise ValueError("corrupt PIZ chunk (bitstream truncated)")

    # canonical decode tables: per length, (first_code, symbols ascending)
    used = np.flatnonzero(lengths)
    codes = _canonical_codes(lengths)
    first_code = {}
    first_index = {}
    symbols_by_len: dict[int, np.ndarray] = {}
    for ln in np.unique(lengths[used]):
        syms = used[lengths[used] == ln]            # ascending symbols
        symbols_by_len[int(ln)] = syms
        first_code[int(ln)] = int(codes[syms[0]] >> 6)

    out = np.empty(n_out, np.uint16)
    pos = 0
    r = _BitReader(blob, data_pos)
    bits_left = n_bits
    code = 0
    ln = 0
    while pos < n_out:
        if bits_left <= 0:
            raise ValueError("corrupt PIZ chunk (bitstream exhausted)")
        code = (code << 1) | r.read(1)
        bits_left -= 1
        ln += 1
        if ln > 58:
            raise ValueError("corrupt PIZ chunk (no code match)")
        syms = symbols_by_len.get(ln)
        if syms is None:
            continue
        idx = code - first_code[ln]
        if 0 <= idx < syms.size:
            sym = int(syms[idx])
            if sym == i_m:                           # run-length marker
                if pos == 0:
                    raise ValueError("corrupt PIZ chunk (leading RLE)")
                cnt = r.read(8)
                bits_left -= 8
                out[pos: pos + cnt] = out[pos - 1]
                pos += cnt
            else:
                out[pos] = sym
                pos += 1
            code = 0
            ln = 0
    return out


# ---------------------------------------------------------------------------
# chunk-level PIZ
# ---------------------------------------------------------------------------

def _u16_size(ch) -> int:
    # pixel size in u16 units: HALF = 1, FLOAT/UINT = 2
    return 1 if ch.pixel_type == 1 else 2


def piz_compress(raw: bytes, channels, width: int, n_lines: int) -> bytes:
    """Compress one chunk of interleaved scanline data (the codec's
    uncompressed wire layout: per line, per channel, width×itemsize)."""
    data = np.frombuffer(raw, "<u2").copy()
    total = data.size
    # rearrange interleaved lines → per-channel planes
    planes = []
    sizes = [_u16_size(ch) for ch in channels]
    row_u16 = [width * s for s in sizes]
    line_stride = sum(row_u16)
    offs = np.cumsum([0] + row_u16[:-1])
    for k, ch in enumerate(channels):
        plane = np.empty((n_lines, row_u16[k]), np.uint16)
        for line in range(n_lines):
            base = line * line_stride + offs[k]
            plane[line] = data[base: base + row_u16[k]]
        planes.append(plane)

    all_vals = np.concatenate([p.reshape(-1) for p in planes])
    bitmap, min_nz, max_nz = bitmap_from_data(all_vals)
    lut, max_value = forward_lut_from_bitmap(bitmap)

    out = bytearray()
    out += struct.pack("<HH", min_nz, max_nz)
    if min_nz <= max_nz:
        out += bitmap[min_nz: max_nz + 1].tobytes()

    buf = np.empty(total, np.uint16)
    pos = 0
    for k, plane in enumerate(planes):
        idx = lut[plane]
        # one wavelet per u16 component (FLOAT/UINT have 2 components)
        for j in range(sizes[k]):
            view = idx[:, j::sizes[k]]
            wav2_encode(view, max_value)
        buf[pos: pos + idx.size] = idx.reshape(-1)
        pos += idx.size

    huf = huf_compress(buf)
    out += struct.pack("<i", len(huf))
    out += huf
    return bytes(out)


def piz_decompress(payload: bytes, channels, width: int, n_lines: int) -> bytes:
    """Inverse of :func:`piz_compress` → interleaved scanline bytes."""
    if len(payload) < 4:
        raise ValueError("corrupt PIZ chunk (truncated)")
    min_nz, max_nz = struct.unpack_from("<HH", payload, 0)
    pos = 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        count = max_nz - min_nz + 1
        bitmap[min_nz: max_nz + 1] = np.frombuffer(payload, np.uint8, count,
                                                   pos)
        pos += count
    lut, max_value = reverse_lut_from_bitmap(bitmap)
    (huf_len,) = struct.unpack_from("<i", payload, pos)
    pos += 4

    sizes = [_u16_size(ch) for ch in channels]
    row_u16 = [width * s for s in sizes]
    total = sum(row_u16) * n_lines
    buf = huf_decompress(payload[pos: pos + huf_len], total)

    out = np.empty(total, np.uint16)
    line_stride = sum(row_u16)
    offs = np.cumsum([0] + row_u16[:-1])
    ppos = 0
    for k, ch in enumerate(channels):
        plane = buf[ppos: ppos + row_u16[k] * n_lines].reshape(
            n_lines, row_u16[k]).copy()
        ppos += plane.size
        for j in range(sizes[k]):
            view = plane[:, j::sizes[k]]
            wav2_decode(view, max_value)
        plane = lut[plane]
        for line in range(n_lines):
            base = line * line_stride + offs[k]
            out[base: base + row_u16[k]] = plane[line]
    return out.astype("<u2").tobytes()
