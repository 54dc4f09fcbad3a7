"""Tracing and per-layer latency analysis (port of
``pcss_unet_tpu/utils/profiling.py``).

The reference has no profiling code; the paper reports a per-layer timing
analysis (paper.md:139-147) with no shipped implementation (SURVEY.md §5).

- ``span(name)``: the program's named range ``pcss.<name>`` at a layer
  boundary (the engine's stages, each UNet block and resize, the weight
  preparation, the train step's phases, the batch gather).  Off by
  default, it is one shared no-op; ``spans()`` turns it on, and a span is
  then a ``torch.profiler.record_function``: on the profiler's clock, tied
  by correlation id to the device work launched inside it, and an NVTX
  range under ``torch.autograd.profiler.emit_nvtx()``.
- ``trace(logdir)``: a ``torch.profiler`` context over the host and the
  card, with the spans on, that writes a Chrome trace into ``logdir`` (open
  it in Perfetto or ``chrome://tracing``).
- ``layer_latency_report(model, variables, shape)``: each encoder and
  decoder ConvBlock timed standalone at the size it sees in the network,
  then the full model, with its FLOP count.
- ``compiled_flops(fn, *args)``: FlopCounterMode's count of one call.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any

import numpy as np
import torch


_SPANS_ON = False
_OFF = contextlib.nullcontext()


def span(name: str):
    """The context of the program's range ``pcss.<name>``: while spans are
    off (the default), the one shared no-op; while on, a
    ``torch.profiler.record_function``."""
    if not _SPANS_ON:
        return _OFF
    return torch.profiler.record_function(f"pcss.{name}")


@contextlib.contextmanager
def spans():
    """Turn the program's spans on while inside; the previous state comes
    back on exit."""
    global _SPANS_ON
    prev, _SPANS_ON = _SPANS_ON, True
    try:
        yield
    finally:
        _SPANS_ON = prev


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the host and (where present) the card while inside, with
    the program's spans on; the Chrome trace is written to
    ``logdir/trace.json`` on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof, spans():
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _timed(fn, *args, iters: int = 3) -> float:
    """Median seconds of ``fn(*args)`` over ``iters`` calls after one warm
    call: CUDA events around each call on a card, the host clock on the
    CPU."""
    fn(*args)
    on_card = any(torch.is_tensor(a) and a.is_cuda for a in args)
    times = []
    for _ in range(iters):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def compiled_flops(fn, *args) -> float | None:
    """Floating-point operations of one ``fn(*args)`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (convolutions
    and matrix products); None where it counts none."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    total = counter.get_total_flops()
    return float(total) if total > 0 else None


@torch.inference_mode()
def layer_latency_report(model, variables: dict | None = None,
                         input_shape=(1, 1088, 1920, 4),
                         dtype: torch.dtype = torch.float32) -> list[dict[str, Any]]:
    """Per-block latency breakdown (the paper.md:139-147 analysis): each
    encoder/decoder ConvBlock of the ``UNet`` ``model`` timed standalone
    at the spatial size it sees inside the network (fresh weights in
    ``dtype``, a zero input), then the full model with ``variables`` (a
    state dict; the model's own weights where None) on a zero float32
    frame.  Rows: ``stage``, ``seconds``, ``shape`` (the block's input,
    N, H, W, C), ``out_ch``; the ``full_model`` row has ``flops`` and
    ``tf32``: whether float32 convolutions and matrix products ran on the
    TF32 tensor cores (cuDNN's default for convolutions)."""
    from pcss_unet_tpu_torch.models.unet import ConvBlock

    device = next(model.parameters()).device
    n, h, w, _ = input_shape
    h2, w2 = h // 2, w // 2
    widths = list(model.encoder_widths)
    report: list[dict[str, Any]] = []

    def time_block(name, in_ch, out_ch, hh, ww):
        block = ConvBlock(in_ch, out_ch, dropout_rate=0.0,
                          activation=model.activation,
                          normalization=model.normalization,
                          dtype=dtype).eval().to(device)
        xx = torch.zeros((n, in_ch, hh, ww), dtype=dtype, device=device)
        report.append({"stage": name, "seconds": _timed(block, xx),
                       "shape": (n, hh, ww, in_ch), "out_ch": out_ch})

    hh, ww = h2, w2
    in_ch = model.in_ch * 4
    for i, width in enumerate(widths):
        time_block(f"enc_{i}", in_ch, width, hh, ww)
        in_ch = width
        if i < len(widths) - 1:
            hh, ww = hh // 2, ww // 2
    for i, skip_w in enumerate(reversed(widths[:-1])):
        hh, ww = hh * 2, ww * 2
        time_block(f"dec_{i}", in_ch, skip_w, hh, ww)
        in_ch = skip_w
    time_block("dec_final", in_ch, model.in_ch * 4, h2, w2)

    def full(xx):
        if variables is None:
            return model(xx)
        return torch.func.functional_call(model, variables, (xx,))

    x = torch.zeros(input_shape, dtype=torch.float32, device=device)
    tf32 = (device.type == "cuda" and torch.float32 in (dtype, model.dtype)
            and torch.backends.cudnn.allow_tf32)
    report.append({"stage": "full_model", "seconds": _timed(full, x),
                   "flops": compiled_flops(full, x), "tf32": tf32})
    return report
