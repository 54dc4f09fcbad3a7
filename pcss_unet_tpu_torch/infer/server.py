"""Streaming inference pipeline, the serving runtime (port of
``pcss_unet_tpu/infer/server.py``).

Shadow-mask serving is a pipeline problem: decode EXR frames on the host,
keep the card fed without sync gaps, and drain uint8 masks back out.  Three
stages with bounded queues (backpressure instead of unbounded RAM):

    decode workers (threads; the native EXR codec is a ctypes library,
                    which releases the GIL)
      → batcher (pads to the engine's multiple, a fixed batch size)
        → device stage (``engine.render_u8``, launched from the calling
          thread only; it returns once its work is queued)
          → output drain (uint8 masks from K4, copied back into pinned
            buffers behind each batch and synced one batch at a time)

Used by ``cli.serve`` for directory-batch processing and importable as a
library (``ShadowServer.run``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable

import numpy as np
import torch

from pcss_unet_tpu_torch.infer.frame import InferenceEngine, pad_to_multiple
from pcss_unet_tpu_torch.infer.staging import PinnedRing

__all__ = ["ServerStats", "ShadowServer"]


@dataclass
class ServerStats:
    frames: int = 0
    decode_seconds: float = 0.0
    compute_seconds: float = 0.0     # host time to dispatch the batches
    wall_seconds: float = 0.0
    # per-frame latency, decode start → mask delivered to the sink: what a
    # renderer loop feels (the tail, not only the throughput)
    latencies: list = field(default_factory=list)

    @property
    def fps(self) -> float:
        return self.frames / self.wall_seconds if self.wall_seconds else 0.0

    def latency_ms(self, pct: float) -> float:
        """Percentile (0-100) of per-frame latency in milliseconds."""
        if not self.latencies:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies), pct) * 1e3)

    @property
    def p50_ms(self) -> float:
        return self.latency_ms(50)

    @property
    def p99_ms(self) -> float:
        return self.latency_ms(99)

    # host time blocked waiting on device results in drain(); wall − sync −
    # dispatch ≈ time the host spent feeding/decoding while the device
    # worked (the overlap the pipeline exists to create)
    sync_seconds: float = 0.0


class ShadowServer:
    """Bounded-queue streaming wrapper around an ``InferenceEngine``.

    ``run(paths, sink)``: decode every EXR in ``paths`` (thread pool),
    batch, infer, and call ``sink(path, mask_u8 [H,W,1])`` in completion
    order.  A file that does not decode is skipped with a warning and gets
    no mask.  All frames must share one resolution (the serving contract).
    At most two batches are in flight on the card."""

    def __init__(self, engine: InferenceEngine, batch_size: int = 1,
                 decode_workers: int = 4, queue_depth: int = 8):
        self.engine = engine
        self.batch_size = batch_size
        self.decode_workers = decode_workers
        self.queue_depth = queue_depth

    def run(self, paths: Iterable[str],
            sink: Callable[[str, np.ndarray], None]) -> ServerStats:
        from pcss_unet_tpu_torch.io.exr import read_exr_stack

        paths = list(paths)
        stats = ServerStats()
        stats_lock = threading.Lock()
        t_wall = time.perf_counter()
        decoded: queue.Queue = queue.Queue(maxsize=self.queue_depth)

        path_q: queue.Queue = queue.Queue()
        for i, p in enumerate(paths):
            path_q.put((i, p))

        def decoder():
            spent = 0.0   # accumulate locally; += on stats would race
            while True:
                try:
                    i, p = path_q.get_nowait()
                except queue.Empty:
                    with stats_lock:
                        stats.decode_seconds += spent
                    return
                try:
                    t0 = time.perf_counter()
                    frame = read_exr_stack(p)
                    spent += time.perf_counter() - t0
                    decoded.put((i, p, frame, t0))
                except Exception as e:  # noqa: BLE001 - skip policy
                    logging.warning("serve: skipping %s: %s", p, e)
                    decoded.put((i, p, None, 0.0))

        workers = [threading.Thread(target=decoder, daemon=True)
                   for _ in range(min(self.decode_workers, max(1, len(paths))))]
        for w in workers:
            w.start()

        masks_back = PinnedRing()
        pending: list[tuple[int, str, np.ndarray, float]] = []
        inflight: list[tuple[list, object, torch.Tensor, tuple]] = []

        def flush_batch():
            if not pending:
                return
            metas = [(i, p, t0) for i, p, _, t0 in pending]
            frames = np.stack([f for _, _, f, _ in pending])
            padded, orig_hw = pad_to_multiple(frames, self.engine.pad_multiple)
            t0 = time.perf_counter()
            out = self.engine.render_u8(padded)      # queued, not waited for
            slot = None
            if out.device.type == "cuda":
                # the masks' copy back, queued right behind this batch
                slot = masks_back.take(out.shape, out.dtype)
                slot.buf.copy_(out, non_blocking=True)
                slot.fence()
                out = slot.buf
            stats.compute_seconds += time.perf_counter() - t0
            inflight.append((metas, slot, out, orig_hw))
            pending.clear()

        def drain(block_all: bool = False):
            # keep ≤ 2 batches in flight; masks flush to the sink as each
            # batch syncs, so memory stays O(queue_depth + batches in
            # flight), never O(len(paths))
            while inflight and (block_all or len(inflight) > 2):
                metas, slot, out, (h, w) = inflight.pop(0)
                t0 = time.perf_counter()
                if slot is not None:
                    slot.wait()                      # this batch alone
                masks = out.numpy()[:, :h, :w, :]
                stats.sync_seconds += time.perf_counter() - t0
                for (i, p, t_dec), mask in zip(metas, masks):
                    # a copy: the pinned buffer is reused for a later batch
                    sink(p, np.array(mask) if slot is not None else mask)
                    stats.frames += 1
                    if t_dec:
                        stats.latencies.append(time.perf_counter() - t_dec)
                if slot is not None:
                    masks_back.release(slot)

        for _ in range(len(paths)):
            i, p, frame, t_dec = decoded.get()
            if frame is None:
                continue
            pending.append((i, p, frame, t_dec))
            if len(pending) >= self.batch_size:
                flush_batch()
            drain()
        flush_batch()
        drain(block_all=True)
        for w in workers:
            w.join(timeout=5)
        stats.wall_seconds = time.perf_counter() - t_wall
        logging.info("served %d frames in %.2fs (%.1f fps; decode %.2fs, "
                     "dispatch %.2fs, sync %.2fs, p50 %.1fms, p99 %.1fms)",
                     stats.frames, stats.wall_seconds, stats.fps,
                     stats.decode_seconds, stats.compute_seconds,
                     stats.sync_seconds, stats.p50_ms, stats.p99_ms)
        return stats
