"""The traced segment of a ``--trace 1`` run: spans around the program's
kernel calls, a ``torch.profiler`` trace of the device, and its reduction
to what the per-layer readers read.

Spans come from the benchmark's side only: during the traced segment the
program's kernel wrappers are wrapped, where its modules look them up
(``roofline/<kernel>.py``'s ``WRAPPERS``), in a ``record_function`` named
after the kernel (K1 ... K6), which also notes
each call's argument shapes for ``roofline/<kernel>.py``.  A device
operation belongs to a span when the host call that launched it (the
profiler's runtime event with the same correlation id) lies inside it.
The benchmark's own loop opens ``bench.*`` spans, which name the device's
idle gaps.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os
import tempfile
from collections import defaultdict

import torch

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _spec(v):
    if isinstance(v, torch.dtype):
        return str(v)
    if torch.is_tensor(v):
        return {"shape": list(v.shape), "dtype": str(v.dtype).replace("torch.", "")}
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    return repr(type(v))


@contextlib.contextmanager
def kernel_spans(calls: list, roofline_mods: dict):
    """Wrap the program's kernel wrappers (each ``roofline/<kernel>.py``'s
    ``WRAPPERS``) in spans named after their kernel; each call appends
    ``(kernel, {"args": [...], "kwargs": {...}})`` to ``calls``.  Undone on
    exit."""
    saved = []
    pairs = [(m, a, k) for k, mod in roofline_mods.items() for m, a in mod.WRAPPERS]
    for modname, attr, kernel in pairs:
        mod = importlib.import_module(modname)
        fn = getattr(mod, attr)

        def wrap(fn=fn, kernel=kernel):
            @functools.wraps(fn)
            def inner(*args, **kwargs):
                calls.append((kernel, {"args": [_spec(a) for a in args],
                                       "kwargs": {k: _spec(v) for k, v in kwargs.items()}}))
                with torch.profiler.record_function(kernel):
                    return fn(*args, **kwargs)
            return inner
        saved.append((mod, attr, fn))
        setattr(mod, attr, wrap())
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def span(name: str):
    """A ``bench.<name>`` span on the host (inert outside a trace)."""
    return torch.profiler.record_function(f"bench.{name}")


@contextlib.contextmanager
def profiled(out: dict, host: bool):
    """Profile the block; on exit ``out["events"]`` holds the trace's events.
    ``host``: record the host's operations and spans too (the kernel spans'
    attribution needs them; recording them slows the host about twofold,
    so the device's busy share is read from a trace without them)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        yield
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["events"] = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _gpu(events):
    return [e for e in events if e.get("cat") in GPU_CATS and "dur" in e]


def device_view(events: list, units: int, window_s: float) -> dict:
    """From a trace of the device alone: ``busy_s`` (device operations'
    merged intervals), the traced ``window_s`` (host clock), operations
    per unit and device seconds per unit, and the operations that took
    most time."""
    gpu = _gpu(events)
    busy = sum(b - a for a, b in _merge([(e["ts"], e["ts"] + e["dur"]) for e in gpu])) * 1e-6
    by_name = defaultdict(float)
    for e in gpu:
        by_name[e["name"][:120]] += e["dur"] * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": window_s, "units": units,
            "launches_per_unit": len(gpu) / units,
            "device_s_per_unit": busy / units,
            "device_ops": [[n, s] for n, s in top]}


def span_view(events: list, calls: list, units: int, roofline_mods: dict) -> dict:
    """From a trace of host and device with the kernel spans: each
    kernel's device seconds (its own kernels launched inside its span), its
    roofline share (``roofline/<kernel>.py``'s bound over that time), the
    device seconds per unit outside the program's kernels (glue), and the
    device's idle gaps named by the ``bench.*`` span the host was in."""
    gpu = _gpu(events)
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    win = [e for e in notes if e.get("name") == "bench.window"]
    lo, hi = (win[0]["ts"], win[0]["ts"] + win[0]["dur"]) if win else (
        min((e["ts"] for e in gpu), default=0.0),
        max((e["ts"] + e["dur"] for e in gpu), default=0.0))
    gpu = [e for e in gpu if lo <= e["ts"] <= hi]
    by_corr = defaultdict(list)
    for e in gpu:
        c = e.get("args", {}).get("correlation")
        if c is not None:
            by_corr[c].append(e)
    spans_by_tid = defaultdict(list)
    for e in notes:
        if not e["name"].startswith("bench."):
            spans_by_tid[e.get("tid")].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    kernel_ops = defaultdict(list)
    for e in events:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        c = e.get("args", {}).get("correlation")
        if c not in by_corr:
            continue
        for a, b, name in spans_by_tid.get(e.get("tid"), ()):
            if a <= e["ts"] <= b:
                kernel_ops[name] += by_corr[c]
                break
    roofline, kernel_s = {}, {}
    for k, mod in roofline_mods.items():
        ops = [e for e in kernel_ops.get(k, ()) if any(p in e["name"] for p in mod.NAMES)]
        t = sum(e["dur"] for e in ops) * 1e-6
        if t <= 0:
            continue
        kernel_s[k] = t / units
        roofline[k] = 100.0 * sum(mod.bound_s(c) for kk, c in calls if kk == k) / t
    own = tuple(p for mod in roofline_mods.values() for p in mod.NAMES)
    merged = _merge([(e["ts"], e["ts"] + e["dur"]) for e in gpu])
    busy = sum(b - a for a, b in merged) * 1e-6
    own_s = sum(e["dur"] for e in gpu if any(p in e["name"] for p in own)) * 1e-6
    bench = sorted((e["ts"], e["ts"] + e["dur"], e["name"][6:]) for e in notes
                   if e["name"].startswith("bench.") and e["name"] != "bench.window")
    gaps = []
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            what = "host"
            for s0, s1, name in bench:
                if s0 <= a <= s1:
                    what = name
            gaps.append((b - a, what))
    gaps.sort(reverse=True)
    return {"kernel_s_per_unit": kernel_s, "roofline": roofline,
            "glue_s_per_unit": (busy - own_s) / units if gpu else None,
            "idle_gaps": [[w, d * 1e-6] for d, w in gaps[:10]]}


def segment(run, units: int, roofline_mods: dict) -> dict:
    """The traced segment: ``run()`` (which queues ``units`` units of the
    window's work) twice, first under a trace of the device alone (busy
    share, operations, the top operations), then with the host's
    operations and the kernel spans (each kernel's time and roofline
    share, the glue, the idle gaps by host span).  Both end once the
    device has finished."""
    from benchmark import harness

    out: dict = {}
    with profiled(out, host=False):
        t0 = harness.clock()
        run()
        torch.cuda.synchronize()
        window_s = harness.clock() - t0
    rec = device_view(out["events"], units, window_s)
    calls: list = []
    out = {}
    with kernel_spans(calls, roofline_mods), profiled(out, host=True):
        with span("window"):
            run()
            torch.cuda.synchronize()
    rec.update(span_view(out["events"], calls, units, roofline_mods))
    rec["breakdown"] = {"device_ops": rec.pop("device_ops"),
                        "idle_gaps": rec.pop("idle_gaps")}
    return rec
