"""Build the port's CUDA kernels and bind them with ctypes.

At first use the sources in ``pcss_unet_tpu_torch/csrc/`` are compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of the checkout:
one object per ``.cu`` file, all compiled at once, then linked into one
shared library with a plain C interface.  The library's name carries a hash
of the sources and flags, so an edited source is rebuilt and a finished
build is reused.  The compiler's report (``-Xptxas -v``: registers, shared
memory and spills of each kernel) is kept beside the library as
``<name>.log``.  ``--use_fast_math`` is deliberately absent: the int8 block
kernel's ``v / scale`` and half-even rounding must be IEEE.

Nothing here runs at import: the CPU tests import every module on a machine
with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points and their argument types; every one returns a cudaError_t
_SIGNATURES = {
    "pcss_scrub_standardize": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _LL, _LL, _LL, _LL, _LL, _LL, _I, _I, _P),
    "pcss_mask_to_u8": (_P, _P, _LL, _I, _P),
    "pcss_convblock_chw": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _F, _I, _P),
    "pcss_block_int8_nhwc": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                             _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    "pcss_block128_nhwc": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                           _I, _P),
    "pcss_conv3x3_int8_nhwc": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _F, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the CUDA "
                       "kernels cannot be built on this machine")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
                 str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], False
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            failed = failed or proc.returncode != 0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        lib_tmp = Path(tmp) / target.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                               "-o", str(lib_tmp)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        target.with_suffix(".log").write_text("\n".join(logs))
        os.replace(lib_tmp, target)   # atomic: concurrent builders agree


def _target() -> Path:
    return BUILD_DIR / f"libpcss_kernels-{_digest()}.so"


def build_log() -> str:
    """The compiler's report for the current sources (after :func:`library`)."""
    return _target().with_suffix(".log").read_text()


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            target = _target()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.pcss_int8_smem_bytes.argtypes = (ctypes.c_int, ctypes.c_int)
            lib.pcss_int8_smem_bytes.restype = ctypes.c_size_t
            lib.pcss_block128_smem_bytes.argtypes = (ctypes.c_int, ctypes.c_int)
            lib.pcss_block128_smem_bytes.restype = ctypes.c_size_t
            lib.pcss_error_string.argtypes = (ctypes.c_int,)
            lib.pcss_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def aligned(t):
    """Contiguous with a 16-byte aligned start, as the kernels' 16-byte
    loads read (a contiguous view may start anywhere)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_device(x, *operands) -> None:
    """Raise unless every operand given (None skipped) lies on x's device:
    a kernel handed a host pointer would fault."""
    for t in operands:
        if t is not None and t.device != x.device:
            raise ValueError(f"operand on {t.device}, expected {x.device}")


MAX_ELEMENTS = 2 ** 31 - 1


def check_extent(*tensors) -> None:
    """Raise unless every tensor given (None skipped) has fewer than 2^31
    elements: the kernels take their shapes as 32-bit ints, and a batch of
    frames multiplies every extent.  The w64 serving batch of four peaks at
    enc_0's [4, 64, 544, 960], 133.7 M elements."""
    for t in tensors:
        if t is not None and t.numel() > MAX_ELEMENTS:
            raise ValueError(f"tensor of {t.numel()} elements {tuple(t.shape)}: "
                             "the kernels index at most 2^31 - 1")


def on_device(wrapper):
    """Decorate a kernel wrapper ``wrapper(x, ...)``: for a CUDA ``x`` it
    runs with x's card as the current device, so that the launch, the
    stream it is given and the C side's per-device state (the shared-memory
    opt-in and the SM count, read through ``cudaGetDevice``) all refer to
    the card x lies on, whatever device is current in the caller."""
    @functools.wraps(wrapper)
    def guarded(x, *args, **kw):
        if x.device.type != "cuda":
            return wrapper(x, *args, **kw)
        import torch

        with torch.cuda.device(x.device):
            return wrapper(x, *args, **kw)
    return guarded


def call(name: str, *args) -> None:
    """Launch the C entry point ``name`` and raise if it reports a CUDA
    error (a refused launch, or an invalid shape)."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err:
        msg = lib.pcss_error_string(err).decode()
        raise RuntimeError(f"{name} failed: CUDA error {err} ({msg})")
