"""The program's own spans in a trace of host and device.

``pcss_unet_tpu_torch/utils/profiling.py::span`` opens a
``record_function`` range named ``pcss.<layer>`` at each layer boundary of
the port (the engine's stages, each UNet block and resize, the weight
preparation, the train step's phases, the batch gather) while the
program's spans are on (``profiling.spans()``).  This module reduces a
trace recorded that way (``trace.profiled(out, host=True)``):

- ``program_view``: per span name and unit, the device time and operations
  launched inside it, its calls and its host time;
- ``named_gaps``: the device's idle gaps, named by the ``bench.*`` span the
  host was in and the innermost program span open on the root's thread;
- ``strip``: the trace without the program's spans, which is what
  ``trace.span_view`` reads, so that its kernel attribution (the first
  non-``bench.`` span around a launch) stays what it is without them.

A device operation belongs to the innermost program span open on its
launch's thread at the launch.  Where that thread has none open (the
autograd engine's thread during ``torch.autograd.grad``), it belongs to the
innermost span open then on the thread that holds the outermost spans.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

PREFIX = "pcss."
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _is_program(e) -> bool:
    return e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX)


def strip(events: list) -> list:
    """The events without the program's spans."""
    return [e for e in events if not _is_program(e)]


class _Tree:
    """One thread's program spans, outer before inner, with parents."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent, stack = [], []
        for i, (a, b, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] < b:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def innermost(self, ts: float):
        """The index of the innermost span open at ``ts``, or None."""
        i = bisect.bisect_right(self.starts, ts) - 1
        while i is not None and i >= 0:
            a, b, _ = self.spans[i]
            if a <= ts <= b:
                return i
            i = self.parent[i]
        return None

    def chain(self, i):
        """Span ``i`` and its ancestors' indices, inner first."""
        while i is not None:
            yield i
            i = self.parent[i]


def _trees(events):
    by_tid = defaultdict(list)
    for e in events:
        if _is_program(e):
            by_tid[e.get("tid")].append((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):]))
    trees = {tid: _Tree(s) for tid, s in by_tid.items()}
    # the root's thread: the one whose spans cover the most host time at
    # the outermost level
    def outer(t):
        return sum(b - a for (a, b, _), p in zip(t.spans, t.parent) if p is None)
    root = max(trees, key=lambda tid: outer(trees[tid]), default=None)
    return trees, root


def _window(events, gpu):
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == "bench.window"]
    if win:
        return win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    return (min((e["ts"] for e in gpu), default=0.0),
            max((e["ts"] + e["dur"] for e in gpu), default=0.0))


def _owner(trees, root, tid, ts):
    """(tree, index) of the span a launch at ``ts`` on ``tid`` belongs to."""
    for t in (tid, root):
        tree = trees.get(t)
        if tree is not None:
            i = tree.innermost(ts)
            if i is not None:
                return tree, i
    return None, None


def program_view(events: list, units: int) -> dict:
    """Per program span name (without the prefix), per unit: ``incl_s``,
    device seconds of the operations launched while it or any span inside
    it was open; ``self_s``, the same less its child spans; ``launches``,
    device operations, inclusive; ``calls``, times it opened; ``host_s``,
    host seconds inside it (a traced host runs about twice as slow)."""
    gpu = [e for e in events if e.get("cat") in GPU_CATS and "dur" in e]
    lo, hi = _window(events, gpu)
    by_corr = defaultdict(list)
    for e in gpu:
        c = e.get("args", {}).get("correlation")
        if c is not None and lo <= e["ts"] <= hi:
            by_corr[c].append(e)
    trees, root = _trees(events)
    incl, own, launches = Counter(), Counter(), Counter()
    for e in events:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        ops = by_corr.get(e.get("args", {}).get("correlation"))
        if not ops:
            continue
        tree, i = _owner(trees, root, e.get("tid"), e["ts"])
        if tree is None:
            continue
        dur = sum(o["dur"] for o in ops) * 1e-6
        own[tree.spans[i][2]] += dur
        for name in {tree.spans[j][2] for j in tree.chain(i)}:
            incl[name] += dur
            launches[name] += len(ops)
    calls, host = Counter(), Counter()
    for tree in trees.values():
        for i, (a, b, name) in enumerate(tree.spans):
            calls[name] += 1
            # host time once, where a span of the same name holds it
            if all(tree.spans[j][2] != name for j in tree.chain(tree.parent[i])):
                host[name] += (b - a) * 1e-6
    return {name: {"incl_s": incl[name] / units, "self_s": own[name] / units,
                   "launches": launches[name] / units, "calls": calls[name] / units,
                   "host_s": host[name] / units}
            for name in sorted(calls)}


def named_gaps(events: list, top: int = 10) -> list:
    """The ``top`` longest idle gaps of the device inside the traced window
    as ``[what, seconds]``: ``what`` is the ``bench.*`` span the host was in
    at the gap's start (``host`` outside any), followed by `` > pcss.<span>``
    where a program span was open then on the root's thread."""
    gpu = [e for e in events if e.get("cat") in GPU_CATS and "dur" in e]
    lo, hi = _window(events, gpu)
    gpu = [e for e in gpu if lo <= e["ts"] <= hi]
    merged = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in gpu):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    bench = sorted((e["ts"], e["ts"] + e["dur"], e["name"][6:]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("bench.")
                   and e["name"] != "bench.window")
    trees, root = _trees(events)
    gaps = []
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        what = "host"
        for s0, s1, name in bench:
            if s0 <= a <= s1:
                what = name
        tree = trees.get(root)
        i = None if tree is None else tree.innermost(a)
        if i is not None:
            what = f"{what} > {PREFIX}{tree.spans[i][2]}"
        gaps.append((b - a, what))
    gaps.sort(reverse=True)
    return [[w, d * 1e-6] for d, w in gaps[:top]]
