"""PNG label/mask IO with the reference's conventions (port of
``pcss_unet_tpu/io/png.py``).

Labels: grayscale decode (PIL ``convert('L')``), NEAREST resize to the input
resolution when sizes mismatch, scale to [0,1] by /255
(setdata.py:164-168, prepare_dataset.py:46-52).

Masks: model output in [0,1] → ×255 truncated to uint8 → PNG
(infer.py:79-80); multi-format save L/RGB/RGBA mirrors inference.py:111-128.

The port does not depend on Pillow: it encodes 8-bit PNG itself (filter 0
on every row, one IDAT) with ``zlib``, and decodes the non-interlaced 8-bit
files a label set holds (grayscale, grayscale+alpha, RGB, RGBA, palette),
converting to luma as PIL's ``convert('L')`` does.  Anything else raises.
``tests/test_torch_io.py`` holds both directions against PIL and the JAX
package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}     # color type → samples
_COLOR_TYPE = {"L": 0, "RGB": 2, "RGBA": 6}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(u8: np.ndarray, mode: str) -> bytes:
    """[H, W] (mode 'L') or [H, W, 3|4] (mode 'RGB'|'RGBA') uint8 → PNG
    bytes."""
    if mode not in _COLOR_TYPE:
        raise ValueError(f"unsupported mode: {mode}")
    u8 = np.ascontiguousarray(u8, np.uint8)
    h, w = u8.shape[:2]
    rows = u8.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[mode], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (0 none, 1 sub, 2 up, 3 average,
    4 Paeth) → [h, stride] uint8."""
    buf = np.frombuffer(data, np.uint8)
    if buf.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    buf = buf.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype, line = buf[y, 0], buf[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:        # a running sum in each of the bpp lanes
            cur = np.zeros(stride, np.int64)
            for lane in range(bpp):
                cur[lane::bpp] = np.cumsum(line[lane::bpp]) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):   # sequential along the row
            lv, pv, cv = line.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                a = cv[x - bpp] if x >= bpp else 0
                b = pv[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = pv[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cv[x] = (lv[x] + pred) & 0xFF
            cur = np.asarray(cv, np.int64)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's RGB → L: (R·19595 + G·38470 + B·7471 + 0x8000) >> 16."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _decode_png(data: bytes) -> tuple[np.ndarray, int, np.ndarray | None]:
    """PNG bytes → ([H, W, samples] uint8, color type, palette or None)
    for 8-bit non-interlaced files."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type "
                         f"{ctype}, interlace {interlace} (8-bit, "
                         "non-interlaced files only)")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    bpp = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    return px.reshape(h, w, bpp), ctype, palette


def decode_png_rgb(data: bytes) -> np.ndarray:
    """PNG bytes → [H, W, 3] uint8, as PIL's ``convert('RGB')`` gives it for
    8-bit non-interlaced files (gray replicated, alpha dropped, palette
    looked up)."""
    px, ctype, palette = _decode_png(data)
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    if ctype == 3:
        return palette[px[..., 0]]
    return px[..., :3].copy()


def decode_png_l(data: bytes) -> np.ndarray:
    """PNG bytes → [H, W] uint8 luma, as PIL's ``convert('L')`` gives it
    for 8-bit non-interlaced files."""
    px, ctype, palette = _decode_png(data)
    if ctype in (0, 4):
        return px[..., 0].copy()
    if ctype == 3:
        return _luma(palette)[px[..., 0]]
    return _luma(px)


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """PIL's NEAREST source index per output pixel: the pixel centre
    mapped back, (i + 0.5)·n_in/n_out, accumulated in float64."""
    scale = n_in / n_out
    steps = np.full(n_out, scale)
    steps[0] = scale * 0.5
    return np.minimum(np.cumsum(steps).astype(np.int64), n_in - 1)


def read_label_png(path: str, target_hw: tuple[int, int] | None = None) -> np.ndarray:
    """→ float32 [H, W] in [0, 1]."""
    with open(path, "rb") as f:
        img = decode_png_l(f.read())
    if target_hw is not None and img.shape != tuple(target_hw):
        ys = _nearest_index(img.shape[0], target_hw[0])
        xs = _nearest_index(img.shape[1], target_hw[1])
        img = img[ys][:, xs]
    return img.astype(np.float32) / 255.0


def write_mask_png(path: str, mask: np.ndarray, mode: str = "L") -> None:
    """Write a [H, W] or [H, W, 1] float mask in [0,1] as PNG.

    mode: 'L' (grayscale, infer.py:79-80), 'RGB', or 'RGBA'
    (inference.py:111-128).  Codes are truncated, ``(x·255).astype(uint8)``,
    as the reference writes them (not rounded)."""
    if mode not in _COLOR_TYPE:
        raise ValueError(f"unsupported mode: {mode}")
    arr = np.asarray(mask, np.float32)
    if arr.ndim == 3:
        arr = arr[..., 0]
    arr = np.clip(np.nan_to_num(arr, nan=0.0, posinf=1.0, neginf=0.0), 0.0, 1.0)
    u8 = (arr * 255.0).astype(np.uint8)
    if mode == "RGB":
        u8 = np.stack([u8] * 3, -1)
    elif mode == "RGBA":
        u8 = np.stack([u8, u8, u8, np.full_like(u8, 255)], -1)
    with open(path, "wb") as f:
        f.write(encode_png(u8, mode))
