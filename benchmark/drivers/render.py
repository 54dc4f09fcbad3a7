"""A renderer's closed loop over ``InferenceEngine.render_u8``.

The traffic (``workloads/<cell>.json``): ``ring`` distinct device-resident
G-buffer batches of ``batch`` frames of ``frame_h`` x ``frame_w`` (reflect-
padded to ``pad_h`` rows where given, as the server pads them), submitted in
a seeded order, one batch at a time, with at most ``in_flight`` batches
queued on the card: after each submission the renderer waits for the
oldest batch once ``in_flight`` are queued.  The uint8 masks stay on the
card.  ``trace_frames`` batches make the traced segment, ``check_frames``
completed batches (a seeded reservoir sample of the window's) are held
against the reference.

End-to-end: ``frame_ms``, the window over the frames it completed;
``frame_p95_ms``, the 95th percentile of every completed frame's latency
from its submission to its completion (a batch's latency is each of its
frames'); ``setup_s``.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import flops, harness, inputs, peaks
from benchmark import trace as tracing
from benchmark.reference import unet as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _ring(wl: dict, gen, device):
    """The ring of batches [ring, batch, H, W, 4] and the stats."""
    n, b = wl["ring"], wl["batch"]
    h, w = wl["frame_h"], wl["frame_w"]
    frames, _ = inputs.gbuffer_frames(n * b, h, w, gen, device)
    means, stds = inputs.channel_stats(frames)
    ph = wl.get("pad_h", h)
    if ph != h:
        frames = F.pad(frames.permute(0, 3, 1, 2), (0, 0, 0, ph - h),
                       mode="reflect").permute(0, 2, 3, 1).contiguous()
    return frames.reshape(n, b, ph, w, 4), means, stds


def closed_loop(render, ring, order, in_flight: int, *, seconds=None,
                count=None, device, keep=None, rng=None):
    """Submit batches from ``ring`` in ``order`` (cycled) with at most
    ``in_flight`` queued, until ``seconds`` have passed or ``count``
    batches were submitted; then wait for the rest.  → (completed batches,
    elapsed seconds, latencies, host enqueue seconds).  ``keep``: a list
    that becomes a reservoir sample (``rng``) of (slot, mask) pairs of
    completed batches, of its initial length."""
    pending: deque = deque()
    lat, enq = [], []
    k = 0 if keep is None else len(keep)
    done = 0

    def finish():
        nonlocal done
        ts, slot, out, marker = pending.popleft()
        with tracing.span("wait"):
            marker.wait()
        lat.append(harness.clock() - ts)
        if keep is not None:
            if done < k:
                keep[done] = (slot, out)
            else:
                j = int(rng.integers(0, done + 1))
                if j < k:
                    keep[j] = (slot, out)
        done += 1

    t0 = harness.clock()
    i = 0
    while True:
        if count is not None and i >= count:
            break
        if seconds is not None and harness.clock() - t0 >= seconds:
            break
        slot = int(order[i % len(order)])
        ts = harness.clock()
        with tracing.span("render_u8"):
            out = render(ring[slot])
        enq.append(harness.clock() - ts)
        pending.append((ts, slot, out, harness.Done(device)))
        if len(pending) >= in_flight:
            finish()
        i += 1
    while pending:
        finish()
    return done, harness.clock() - t0, lat, enq


def _compare(samples, ring, weights, means, stds, cfg, wl) -> dict:
    """Each sampled mask against the reference's mask of its batch, in
    uint8 codes over the frame's true rows.  Per frame: the mean absolute
    difference (``mad``), the share of codes off by more than 8 (``far``),
    and the same ``mad`` of the reference computed with float32 stored
    values instead of bfloat16 (``floor``: how far this seed's net moves
    under the working precision's rounding alone).  → the worst frame's
    ``mask_mad_codes``, ``mask_far_share``, ``floor_mad_codes`` and
    ``mask_mad_ratio`` (mad over max(floor, 0.01))."""
    h = wl["frame_h"]
    int8 = cfg["inference"]["quantize"] == "int8"
    refs = {}
    out = dict.fromkeys(("mask_mad_codes", "mask_far_share", "floor_mad_codes",
                         "mask_mad_ratio"), 0.0)

    def mad(a, b):
        d = (a.to(torch.int16) - b.to(torch.int16)).abs().float()
        return d.reshape(d.shape[0], -1)

    with harness.no_tf32():
        for slot, got in samples:
            if slot not in refs:
                r = ref.to_u8(ref.mask(weights, ring[slot], means, stds, int8=int8))[:, :h]
                f = ref.to_u8(ref.mask(weights, ring[slot], means, stds, int8=int8,
                                       precision="fp32"))[:, :h]
                refs[slot] = (r, mad(f, r).mean(1))
            r, floor = refs[slot]
            d = mad(got[:, :h], r)
            m = d.mean(1)
            out["mask_mad_codes"] = max(out["mask_mad_codes"], float(m.max()))
            out["mask_far_share"] = max(out["mask_far_share"], float((d > 8).float().mean(1).max()))
            out["floor_mad_codes"] = max(out["floor_mad_codes"], float(floor.max()))
            out["mask_mad_ratio"] = max(out["mask_mad_ratio"],
                                        float((m / torch.clamp(floor, min=0.01)).max()))
    return out


def run(wl: dict, cfg: dict, *, seed: int, seconds: float, trace: bool,
        device, t_start: float, render_fault=None) -> dict:
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    inf = cfg["inference"]
    widths = tuple(cfg["encoder_widths"])
    weights = inputs.unet_weights(widths, gen, dev, style="deploy")
    ring, means, stds = _ring(wl, gen, dev)
    phases = {"start_and_inputs": harness.clock() - t_start}
    from pcss_unet_tpu_torch.infer.frame import InferenceEngine
    engine = InferenceEngine(None, inputs.engine_variables(weights, widths),
                             means=means, stds=stds, dtype=DTYPES[inf["dtype"]],
                             fold_bn=inf["fold_bn"], quantize=inf["quantize"],
                             layout=inf["layout"], device=dev)
    phases["engine"] = harness.clock() - t_start - sum(phases.values())
    render_fn = engine.render_u8
    if render_fault is not None:        # the tests' and calibration's faults
        render_fn = render_fault(render_fn)
    order = np.random.default_rng(seed).permutation(len(ring))
    in_flight = wl["in_flight"]
    # warm-up: every batch of the ring once, in the window's loop
    closed_loop(render_fn, ring, order, in_flight, count=len(ring), device=dev)
    harness.synchronize(dev)
    setup_s = harness.clock() - t_start
    phases["warmup"] = setup_s - sum(phases.values())

    samples = [None] * wl["check_frames"]
    done, elapsed, lat, enq = closed_loop(
        render_fn, ring, order, in_flight, seconds=seconds, device=dev,
        keep=samples, rng=np.random.default_rng(seed + 1))
    b = wl["batch"]
    frame_ms = elapsed * 1e3 / (done * b)
    record = {"setup_s": setup_s, "setup_phases": phases, "frame_ms": frame_ms,
              "frame_p95_ms": harness.percentile(lat, 95) * 1e3,
              "host_enqueue_ms": float(np.mean(enq)) * 1e3 / b}
    flop = 2.0 * flops.unet_macs(widths, ring.shape[2], ring.shape[3])
    record["mfu"] = 100.0 * flop / (frame_ms * 1e-3) / peaks.BF16_FLOPS
    trace_rec = breakdown = None
    if trace:
        n = wl["trace_frames"]
        trace_rec = tracing.segment(
            lambda: closed_loop(render_fn, ring, order, in_flight, count=n, device=dev),
            n * b, harness.rooflines())
        record["trace"] = trace_rec
        breakdown = trace_rec["breakdown"]
    device_info = harness.device_info(dev, trace_rec)
    samples = [s for s in samples if s is not None]
    del engine, render_fn
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = harness.clock()
    readings = _compare(samples, ring, weights, means, stds, cfg, wl)
    readings["check_s"] = harness.clock() - t_check
    checks, correct = harness.judge(readings, wl["limits"])
    correct = correct and bool(samples)
    return {"record": record, "checks": checks, "readings": readings,
            "correct": correct, "attempted": done * b, "failed": 0,
            "device": device_info, "breakdown": breakdown}

