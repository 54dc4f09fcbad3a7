"""Latency-measurement harness shared by the port's benchmarks (port of
``pcss_unet_tpu/utils/benchlib.py``).

The method is the JAX package's, kept so that the two packages' numbers
mean the same thing:

- a stream of ``scan_len`` forwards in which each forward's input is
  ``x + carry·1e-12``, ``carry`` being the float32 mean of the previous
  forward's output, so that every forward depends on the one before it;
- each stream length is timed by its fastest of ``reps`` dispatches, and
  the time per frame is the two-point difference ``(T_hi − T_lo) / (hi −
  lo) / batch``, which removes the fixed cost that every dispatch pays
  once (its launch and its final synchronisation).

In eager PyTorch nothing hoists work out of the chain, as XLA's
loop-invariant code motion did out of a ``lax.scan``; the chain stays
because it is the method: it makes the forwards a dependent sequence, as a
renderer's frames are, and it keeps the fixed per-dispatch cost out of
the estimate exactly as the JAX harness does.  Nothing in a stream reads
the device from the host (no ``.item()``), so a stream is one dispatch
that ends in one synchronisation.  On a card each dispatch is timed with
CUDA events on the current stream; on the CPU with ``time.perf_counter``.

The H100's peak rates are kept here as the one copy the port's benchmarks
and ``chip_smoke.py`` use: NVIDIA's data sheet, SXM part, dense, at the
700 W power limit.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

# hi − lo = 32 chained forwards contribute to the differenced estimate;
# lo is long enough that per-dispatch jitter is small against T_lo.
CANON_SCAN_LO = 8
CANON_SCAN_HI = 40
CANON_REPS = 4

PEAK_BF16_FLOPS = 989e12        # tensor cores, bf16 / fp16
PEAK_INT8_OPS = 1979e12         # tensor cores, int8
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12      # HBM3


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (the limit sets the
    clocks under load, so it stands beside every time).  Raises where
    ``nvidia-smi`` fails."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_stream(apply_fn, params, batch_stats, scan_len):
    """``stream(x) -> 0-d float32 tensor`` running ``scan_len``
    input-chained forwards of ``apply_fn(variables, x)`` (one forward,
    returning the output tensor; ``variables`` is ``{"params": params,
    "batch_stats": batch_stats}``).  The result stays on the device."""
    variables = {"params": params, "batch_stats": batch_stats}

    @torch.inference_mode()
    def stream(x):
        carry = torch.zeros((), dtype=torch.float32, device=x.device)
        for _ in range(scan_len):
            out = apply_fn(variables, x + carry.to(x.dtype) * 1e-12)
            carry = out.float().mean()
        return carry

    return stream


def _dispatch_s(stream, x) -> float:
    """One dispatch of ``stream`` on ``x``, waited for: CUDA events on the
    current stream for a card tensor, the host clock on the CPU."""
    if x.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        stream(x)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    float(stream(x))
    return time.perf_counter() - t0


def _best_dispatch_s(stream, x, reps):
    """Fastest observed dispatch time after one warm dispatch.  Min (not
    median) because the estimate is a *difference* of two dispatch times:
    the least-interference observation of each keeps the difference stable
    when per-dispatch jitter is comparable to the per-forward work."""
    _dispatch_s(stream, x)
    return float(np.min([_dispatch_s(stream, x) for _ in range(reps)]))


def measure_ms_per_frame(apply_fn, params, batch_stats, x,
                         scan_len=None, reps=CANON_REPS):
    """Sustained ms per frame via two-point stream differencing.

    ``scan_len`` (when given) is the DIFFERENCE hi−lo, the number of
    chained forwards that contribute to the estimate; lo is then
    ``max(2, scan_len // 4)``.  Without it, lo and hi are the canonical
    8 and 40."""
    lo, hi = scan_lengths(scan_len)
    t_lo = _best_dispatch_s(make_stream(apply_fn, params, batch_stats, lo),
                            x, reps)
    t_hi = _best_dispatch_s(make_stream(apply_fn, params, batch_stats, hi),
                            x, reps)
    batch = int(x.shape[0])
    diff = t_hi - t_lo
    if diff <= 0.05 * t_hi:
        # difference below dispatch noise (tiny shapes): fall back to the
        # single-dispatch estimate, which overstates by fixed/hi but is
        # finite and sane
        return t_hi / hi / batch * 1000.0
    return diff / (hi - lo) / batch * 1000.0


def scan_lengths(scan_len=None) -> tuple[int, int]:
    """(lo, hi) that ``measure_ms_per_frame`` times for ``scan_len``."""
    if scan_len is None:
        return CANON_SCAN_LO, CANON_SCAN_HI
    lo = max(2, scan_len // 4)
    return lo, lo + max(1, scan_len)


def forward_flops(apply_fn, params, batch_stats, x):
    """Floating-point operations of ONE forward as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (convolutions
    and matrix products, 2 per multiply-add; bias adds and pointwise work
    are not counted).  It runs the forward once.  None where it counts
    nothing, as for a forward that runs the port's own kernels (ctypes
    calls, which it cannot see)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        apply_fn({"params": params, "batch_stats": batch_stats}, x)
    total = counter.get_total_flops()
    return float(total) if total > 0 else None
