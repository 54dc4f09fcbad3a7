"""EXR reading/writing — public API of the IO layer (port of
``pcss_unet_tpu/io/exr.py``).

``read_exr`` reproduces the reference's channel contract exactly
(setdata.py:34-110): returns the four float32 [H, W] planes R, G, B, A; a
missing A channel is synthesized as all-ones (setdata.py:64-67); non-finite
values are scrubbed nan→0, +inf→1, −inf→0 (setdata.py:81-83).

Backend selection: the native C++ codec (``native/exr/exr_codec.cpp``) when
it builds, else the pure-Python codec (``io/exr_py.py``), as in the JAX
package; ``PCSS_EXR_BACKEND=python|native`` forces one.  The library is
built at first use with ``g++`` into ``build/exr/`` at the root of the
checkout (never into ``native/exr/``, which the JAX package builds into),
under a name that carries a hash of the sources and flags, written to a
temporary name and moved into place so that concurrent processes never load
a half-written file.  A failed build falls back to the Python codec with a
logged warning (the JAX package's contract); ``native_error()`` keeps the
reason and ``last_backend()`` says which codec decoded the last read, so a
caller can show both.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from pcss_unet_tpu_torch.io import exr_py

_REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = _REPO_ROOT / "native" / "exr"
BUILD_DIR = _REPO_ROOT / "build" / "exr"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
_lib_lock = threading.Lock()
_native_error: str | None = None
_last_backend: str | None = None

COMP_NONE = exr_py.COMP_NONE
COMP_RLE = exr_py.COMP_RLE
COMP_ZIPS = exr_py.COMP_ZIPS
COMP_ZIP = exr_py.COMP_ZIP
COMP_PXR24 = exr_py.COMP_PXR24
PT_HALF = exr_py.PT_HALF
PT_FLOAT = exr_py.PT_FLOAT

_P, _I = ctypes.c_void_p, ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)
_S = ctypes.c_char_p
_IP = ctypes.POINTER(ctypes.c_int)
# C entry points of exr_codec.cpp: (return type, argument types)
_SIGNATURES = {
    "pcss_exr_open_file": (_P, (_S,)),
    "pcss_exr_open_file_part": (_P, (_S, _I)),
    "pcss_exr_open_file_named": (_P, (_S, _S)),
    "pcss_exr_num_parts": (_I, (_P,)),
    "pcss_exr_part_name": (_I, (_P, _I, _S, _I)),
    "pcss_exr_dims": (_I, (_P, _IP, _IP)),
    "pcss_exr_num_channels": (_I, (_P,)),
    "pcss_exr_channel_name": (_I, (_P, _I, _S, _I)),
    "pcss_exr_read_channels": (_I, (_P, ctypes.POINTER(_S),
                                    ctypes.POINTER(_FP), _I, _IP)),
    "pcss_exr_error": (_S, (_P,)),
    "pcss_exr_close": (None, (_P,)),
    "pcss_exr_set_threads": (None, (_I,)),
    "pcss_exr_write": (_I, (_S, ctypes.POINTER(_S), ctypes.POINTER(_FP),
                            _I, _I, _I, _I, _I)),
    "pcss_exr_write_tiled": (_I, (_S, ctypes.POINTER(_S),
                                  ctypes.POINTER(_FP), _I, _I, _I, _I, _I,
                                  _I, _I)),
    "pcss_exr_write_multipart": (_I, (_S, ctypes.POINTER(_S), _I, _IP,
                                      ctypes.POINTER(_S), ctypes.POINTER(_FP),
                                      _IP, _IP, _I, _I, _I, _I)),
}


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in sorted(NATIVE_SRC.glob("*")):
        if p.suffix in (".cpp", ".h") and p.name != "tsan_harness.cpp":
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_DIR / f"libpcss_exr-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp,
                        str(NATIVE_SRC / "exr_codec.cpp"), "-lz"],
                       check=True, capture_output=True, text=True, timeout=300)
        os.replace(tmp, target)     # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_native():
    """Load (building if necessary) the native codec; None on any failure,
    with the reason in ``native_error()``."""
    global _lib, _native_error
    if os.environ.get("PCSS_EXR_BACKEND") == "python":
        return None
    with _lib_lock:
        if _lib is not None or _native_error is not None:
            return _lib
        try:
            target = _target()
            if not target.exists():
                _build(target)
                logging.info("built native EXR codec at %s", target)
            lib = ctypes.CDLL(str(target))
        except Exception as e:  # noqa: BLE001 - fall back to python codec
            detail = getattr(e, "stderr", None) or ""
            _native_error = f"{e} {detail}".strip()
            logging.warning("native EXR codec unavailable (%s); using "
                            "pure-Python codec", _native_error)
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def native_error() -> str | None:
    """Why the native codec could not be built or loaded (None if it was,
    or was never tried)."""
    return _native_error


def last_backend() -> str | None:
    """The codec that decoded the last ``read_exr_channels`` call in this
    process: ``"native"`` or ``"python"`` (None before the first)."""
    return _last_backend


def set_decode_threads(n: int) -> bool:
    """Set the native codec's within-file chunk-parallel decode width.

    ``n > 1``: decode each file's chunks on ``n`` threads; ``n == 0``: use
    the hardware thread count; ``n == 1``: serial (the default).  The
    effective width is capped at 16 threads per file (and at the file's
    chunk count).  Chunks write to disjoint plane regions so results are
    identical at any width.  Meant for single-file latency (the inference
    CLI); also settable before first use via the PCSS_EXR_THREADS env var.
    Returns False when the native codec is unavailable."""
    lib = _load_native()
    if lib is None:
        return False
    lib.pcss_exr_set_threads(int(n))
    return True


def _read_channels_native(path: str, names: Sequence[str],
                          part: int | str = 0):
    lib = _load_native()
    if lib is None:
        return None
    if isinstance(part, str):
        # by-NAME selection resolves inside ONE native open/read
        handle = lib.pcss_exr_open_file_named(path.encode(), part.encode())
    elif part:
        handle = lib.pcss_exr_open_file_part(path.encode(), part)
    else:
        handle = lib.pcss_exr_open_file(path.encode())
    try:
        w = ctypes.c_int()
        h = ctypes.c_int()
        if lib.pcss_exr_dims(handle, ctypes.byref(w), ctypes.byref(h)) != 0:
            raise IOError(f"EXR parse error in {path}: "
                          f"{lib.pcss_exr_error(handle).decode()}")
        bufs = [np.empty((h.value, w.value), np.float32) for _ in names]
        # one pass over the chunks for ALL channels: decompression
        # (inflate/Huffman/DCT) runs once, not once per channel
        n = len(names)
        name_arr = (_S * n)(*[s.encode() for s in names])
        ptr_arr = (_FP * n)(*[b.ctypes.data_as(_FP) for b in bufs])
        present = (ctypes.c_int * n)()
        if lib.pcss_exr_read_channels(handle, name_arr, ptr_arr, n,
                                      present) != 0:
            raise IOError(f"EXR decode error in {path}: "
                          f"{lib.pcss_exr_error(handle).decode()}")
        return {name: bufs[i] if present[i] else None
                for i, name in enumerate(names)}
    finally:
        lib.pcss_exr_close(handle)


def write_exr_multipart(path: str,
                        parts: list[tuple[str, dict[str, np.ndarray]]],
                        compression: int = COMP_ZIP,
                        pixel_type: int = PT_FLOAT,
                        tile_size: tuple[int, int] | None = None) -> None:
    """Write a multi-part EXR (``parts``: ordered (name, channels) pairs).
    Native codec when available, Python twin as fallback and oracle."""
    lib = _load_native()
    if lib is not None:
        part_names = [n for n, _ in parts]
        chan_names: list[str] = []
        arrs: list[np.ndarray] = []
        n_chans = []
        widths, heights = [], []
        for _, channels in parts:
            names = sorted(channels)
            n_chans.append(len(names))
            h, w = np.asarray(channels[names[0]]).shape
            heights.append(h)
            widths.append(w)
            for cn in names:
                chan_names.append(cn)
                arrs.append(np.ascontiguousarray(
                    np.asarray(channels[cn], np.float32)))
        pn_arr = (_S * len(parts))(*[s.encode() for s in part_names])
        nc_arr = (ctypes.c_int * len(parts))(*n_chans)
        w_arr = (ctypes.c_int * len(parts))(*widths)
        h_arr = (ctypes.c_int * len(parts))(*heights)
        cn_arr = (_S * len(chan_names))(*[s.encode() for s in chan_names])
        ptr_arr = (_FP * len(arrs))(*[a.ctypes.data_as(_FP) for a in arrs])
        tw, th = (0, 0) if tile_size is None else (int(tile_size[0]),
                                                   int(tile_size[1]))
        rc = lib.pcss_exr_write_multipart(
            path.encode(), pn_arr, len(parts), nc_arr, cn_arr, ptr_arr,
            w_arr, h_arr, compression, pixel_type, tw, th)
        if rc == 0:
            return
        logging.warning("native multi-part EXR write failed (rc=%d); "
                        "using python codec", rc)
    exr_py.write_exr_multipart_py(path, parts, compression=compression,
                                  pixel_type=pixel_type,
                                  tile_size=tile_size)


def list_exr_channels(path: str, part: int | str = 0) -> list[str]:
    """Channel names in file (chlist) order, from the Python parser for
    both backends (the header only; no pixel decode)."""
    if not os.path.exists(path):
        raise IOError(f"EXR file does not exist: {path}")
    with open(path, "rb") as f:
        return [c.name for c in exr_py.ExrFile(f.read(), part=part).channels]


def read_exr_channels(path: str, names: Sequence[str],
                      part: int | str = 0) -> dict:
    """Raw channel access: {name: float32 [H,W] or None if absent}.

    ``part`` selects a part of a multi-part file by index or name (default
    0, which is also what the reference's ``OpenEXR.InputFile`` exposes —
    setdata.py:42)."""
    global _last_backend
    if not os.path.exists(path):
        raise IOError(f"EXR file does not exist: {path}")
    try:
        result = _read_channels_native(path, names, part=part)
    except IOError as e:
        # fall back for files the native codec rejects (the pure-Python
        # twin may still support them, or give a clearer error)
        logging.debug("native EXR decode failed (%s); trying python", e)
        result = None
    if result is not None:
        _last_backend = "native"
        return result
    result = exr_py.read_exr_channels_py(path, list(names), part=part)
    _last_backend = "python"
    return result


def read_exr(path: str) -> list[np.ndarray]:
    """Reference-contract reader (setdata.py:34-110): R, G, B, A float32
    planes; missing A → ones; non-finite → nan_to_num(0, 1, 0)."""
    chans = read_exr_channels(path, ["R", "G", "B", "A"])
    shape = next((chans[n].shape for n in "RGBA" if chans[n] is not None),
                 None)
    if shape is None:
        raise ValueError(f"no R/G/B/A channels in {path}")
    out = []
    for name in "RGBA":
        arr = chans[name]
        if arr is None:
            if name == "A":
                arr = np.ones(shape, np.float32)  # setdata.py:64-67
            else:
                raise ValueError(f"channel {name} missing in {path}")
        if not np.isfinite(arr).all():
            arr = np.nan_to_num(arr, nan=0.0, posinf=1.0, neginf=0.0)
        out.append(arr)
    return out


def read_exr_stack(path: str) -> np.ndarray:
    """Convenience: [H, W, 4] float32 stack (NHWC-friendly)."""
    return np.stack(read_exr(path), axis=-1)


def write_exr(path: str, channels: dict[str, np.ndarray],
              compression: int | str = COMP_ZIP, pixel_type: int = PT_FLOAT,
              tile_size: tuple[int, int] | None = None) -> None:
    """Write a single-part EXR — scanline by default, ONE_LEVEL tiled when
    ``tile_size=(tile_w, tile_h)``.  Channel dict keys are sorted (EXR
    requires an alphabetical chlist).  ``compression`` accepts the COMP_*
    code or the scheme name ("ZIP", "DWAA", "piz", ...)."""
    if isinstance(compression, str):
        try:
            compression = getattr(exr_py, f"COMP_{compression.upper()}")
        except AttributeError:
            raise ValueError(f"unknown compression {compression!r}") from None
    lib = _load_native()
    names = sorted(channels)
    if lib is not None:
        arrs = [np.ascontiguousarray(np.asarray(channels[n], np.float32))
                for n in names]
        h, w = arrs[0].shape
        name_arr = (_S * len(names))(*[n.encode() for n in names])
        ptr_arr = (_FP * len(names))(*[a.ctypes.data_as(_FP) for a in arrs])
        if tile_size is None:
            rc = lib.pcss_exr_write(path.encode(), name_arr, ptr_arr,
                                    len(names), w, h, compression, pixel_type)
        else:
            rc = lib.pcss_exr_write_tiled(
                path.encode(), name_arr, ptr_arr, len(names), w, h,
                compression, pixel_type, int(tile_size[0]), int(tile_size[1]))
        if rc == 0:
            return
        logging.warning("native EXR write failed (rc=%d); using python codec", rc)
    exr_py.write_exr_py(path, channels, compression=compression,
                        pixel_type=pixel_type, tile_size=tile_size)
