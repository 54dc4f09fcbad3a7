"""Host input pipeline: the datasets and the shuffling / sharding /
cropping Loader (port of ``pcss_unet_tpu/data/pipeline.py``).

- ``discover_pairs`` — the sorted ``*_input.exr`` / ``*_gt.png`` pairs of a
  split directory (make_dataset role, setdata.py:112-136).
- ``PackedDataset`` — ``MmapLiverDataset`` (setdata.py:207-331): mmap'd
  ``.npy`` packs; the TRAIN split's stats standardize every split
  (setdata.py:262-263 — they ride along as ``.means``/``.stds`` and the
  train step standardizes on the device).  Accepts NHWC and NCHW
  (reference prepare_dataset.py:67-68) packs; batches always come out NHWC.
- ``PairDataset`` — ``LiverDataset`` (setdata.py:138-205): lazy EXR+PNG
  decode with the label ``convert('L')`` + NEAREST-resize + /255 contract
  (setdata.py:164-168), threaded (the native EXR codec releases the GIL).
- ``Loader`` — the ``DataLoader`` role (main.py:847-865): seeded shuffle
  (on by default; the reference trains with shuffle=False, main.py:850),
  per-host sharding and seeded random crops.  Its sampling plan is a copy
  of the JAX package's: the same (seed, epoch) gives the same batches and
  crops, bit for bit.
- ``prefetch_to_device`` — a background thread copies batches to the card
  ahead of the step, through pinned host buffers on a copy stream, so the
  host→device copies overlap compute and nothing waits on the host.

The Loader's sampling decisions live in ``epoch_indices``/``crop_offsets``,
so the device cache (``data/device_cache.py``) replays the same batch
stream on the card.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def discover_pairs(pair_dir: str) -> list[tuple[str, str]]:
    """Sorted ``(*_input.exr, *_gt.png)`` pairs (make_dataset role,
    setdata.py:112-136).  Inputs with no label are warned about and
    skipped."""
    pairs = []
    for fname in sorted(os.listdir(pair_dir)):
        if not fname.endswith("_input.exr"):
            continue
        stem = fname[: -len("_input.exr")]
        png = os.path.join(pair_dir, f"{stem}_gt.png")
        if not os.path.exists(png):
            logging.warning("input without label skipped: %s", fname)
            continue
        pairs.append((os.path.join(pair_dir, fname), png))
    return pairs


def _load_train_stats(dataset_path: str, n_ch: int):
    """Train stats standardize every split (setdata.py:262-263); identity
    (0, 1) when the artifact hasn't been computed yet."""
    path = os.path.join(dataset_path, "train_stats.npy")
    if os.path.exists(path):
        stats = np.load(path, allow_pickle=True).item()
        return (np.asarray(stats["means"], np.float32),
                np.asarray(stats["stds"], np.float32))
    logging.info("no train_stats.npy in %s — standardization is identity "
                 "until the stats pass runs", dataset_path)
    return np.zeros(n_ch, np.float32), np.ones(n_ch, np.float32)


class PackedDataset:
    """Mmap'd packed arrays with fancy-index gather.

    Attributes: ``layout`` ('nhwc'|'nchw'), ``sample_hw``, ``means``/``stds``
    (train stats, per the always-train rule), ``inputs``/``labels`` mmaps.
    """

    def __init__(self, dataset_path: str, split: str):
        in_path = os.path.join(dataset_path, f"{split}_inputs.npy")
        lb_path = os.path.join(dataset_path, f"{split}_labels.npy")
        if not os.path.exists(in_path):
            raise FileNotFoundError(f"{in_path} not found — run the prepare "
                                    "step")
        self.inputs = np.load(in_path, mmap_mode="r")
        self.labels = np.load(lb_path, mmap_mode="r")
        self.dataset_path = dataset_path
        self.split = split

        meta_path = os.path.join(dataset_path, f"{split}_meta.json")
        layout = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                layout = json.load(f).get("layout")
        if layout is None:
            # NCHW autodetect: channels are the small (≤8) axis.
            s = self.inputs.shape
            layout = "nchw" if s[1] <= 8 < s[3] else "nhwc"
        self.layout = layout
        if layout == "nchw":
            self.sample_hw = tuple(self.inputs.shape[2:4])
            n_ch = self.inputs.shape[1]
        else:
            self.sample_hw = tuple(self.inputs.shape[1:3])
            n_ch = self.inputs.shape[3]
        self.means, self.stds = _load_train_stats(dataset_path, n_ch)

    def __len__(self) -> int:
        return self.inputs.shape[0]

    def gather(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """→ (inputs [B,H,W,4] float32, labels [B,H,W,1] float32) — NHWC
        regardless of pack layout."""
        x = np.asarray(self.inputs[idx], np.float32)
        y = np.asarray(self.labels[idx], np.float32)
        if self.layout == "nchw":
            x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
            y = np.ascontiguousarray(y.transpose(0, 2, 3, 1))
        return x, y

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        x, y = self.gather(np.asarray([i]))
        return x[0], y[0]


class PairDataset:
    """Lazy on-the-fly EXR+PNG pairs (LiverDataset role, setdata.py:138-205).

    Decode happens at gather time, threaded; the label is NEAREST-resized to
    the input resolution (setdata.py:164-168)."""

    def __init__(self, pair_dir: str, num_workers: int = 8):
        self.pairs = discover_pairs(pair_dir)
        if not self.pairs:
            raise FileNotFoundError(f"no pairs in {pair_dir}")
        self._pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
        x, _ = self[0]
        self.sample_hw = tuple(x.shape[:2])
        self.means, self.stds = _load_train_stats(pair_dir, x.shape[-1])
        self.layout = "nhwc"

    def __len__(self) -> int:
        return len(self.pairs)

    def _decode(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        from pcss_unet_tpu_torch.io.exr import read_exr_stack
        from pcss_unet_tpu_torch.io.png import read_label_png

        exr, png = self.pairs[i]
        x = read_exr_stack(exr)
        y = read_label_png(png, target_hw=x.shape[:2])[..., None]
        return x, y

    def __getitem__(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        return self._decode(int(i))

    def gather(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        items = list(self._pool.map(self._decode, [int(i) for i in idx]))
        return (np.stack([x for x, _ in items]),
                np.stack([y for _, y in items]))


class Loader:
    """Batched epoch iterator: seeded shuffle, per-host sharding, seeded
    random crops, drop-remainder batching.

    All randomness is a pure function of (seed, epoch), so epochs are
    reproducible, shards are disjoint, and a resumed run replays the same
    stream (``epoch_indices`` + ``crop_offsets`` are the single source of
    truth)."""

    def __init__(self, ds, batch_size: int, shuffle: bool = False,
                 seed: int = 0, crop_hw: tuple[int, int] | None = None,
                 shard_index: int = 0, shard_count: int = 1):
        if crop_hw is not None:
            ch, cw = crop_hw
            h, w = ds.sample_hw
            if ch > h or cw > w:
                raise ValueError(f"crop {crop_hw} exceeds sample size {(h, w)}")
        if not (0 <= shard_index < shard_count):
            raise ValueError(f"shard_index {shard_index} out of range "
                             f"[0, {shard_count})")
        self.ds = ds
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.crop_hw = tuple(crop_hw) if crop_hw else None
        self.shard_index = int(shard_index)
        self.shard_count = int(shard_count)

    def batches_per_epoch(self) -> int:
        mine = (len(self.ds) + self.shard_count - 1 - self.shard_index
                ) // self.shard_count
        return mine // self.batch_size

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """→ int array [num_batches, batch_size]: this shard's sample
        indices for ``epoch``, already batched (drop-remainder)."""
        n = len(self.ds)
        if self.shuffle:
            rng = np.random.default_rng((self.seed + 1) * 1_000_003 + epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        mine = order[self.shard_index::self.shard_count]
        nb = len(mine) // self.batch_size
        return mine[: nb * self.batch_size].reshape(nb, self.batch_size)

    def crop_offsets(self, epoch: int, num_batches: int) -> np.ndarray | None:
        """→ int array [num_batches, 2] of (oy, ox) crop origins, or None
        when cropping is off.  One window per batch, seeded per epoch."""
        if self.crop_hw is None:
            return None
        h, w = self.ds.sample_hw
        ch, cw = self.crop_hw
        rng = np.random.default_rng((self.seed + 1) * 7_919 + 31 * epoch)
        oy = rng.integers(0, h - ch + 1, size=num_batches)
        ox = rng.integers(0, w - cw + 1, size=num_batches)
        return np.stack([oy, ox], axis=1)

    def epoch(self, epoch: int, start_batch: int = 0):
        """Yield (inputs [B,h,w,4], labels [B,h,w,1]) host batches.

        ``start_batch`` skips the first N batches of the epoch's plan
        (mid-epoch resume: offsets are computed for the FULL epoch and then
        sliced, so the remaining stream is identical to an uninterrupted
        run's tail)."""
        batches = self.epoch_indices(epoch)
        offsets = self.crop_offsets(epoch, len(batches))
        for b, idx in enumerate(batches):
            if b < start_batch:
                continue
            x, y = self.ds.gather(idx)
            if offsets is not None:
                ch, cw = self.crop_hw
                oy, ox = offsets[b]
                x = x[:, oy:oy + ch, ox:ox + cw]
                y = y[:, oy:oy + ch, ox:ox + cw]
            yield x, y

    def __iter__(self):
        return self.epoch(0)


def _to_device(batch, device: torch.device, stream):
    """Host arrays → tensors on ``device``.  On a card: through pinned
    buffers on ``stream``, with an event the consumer's stream waits on."""
    if device.type != "cuda":
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in batch), None
    with torch.cuda.stream(stream):
        out = tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                    .to(device, non_blocking=True) for a in batch)
        ready = torch.cuda.Event()
        ready.record(stream)
    return out, ready


def prefetch_to_device(batch_iter, device: str | torch.device, size: int = 2):
    """Wrap a host batch iterator with a background thread that moves
    batches to ``device`` ``size`` steps ahead, so the host→device copies
    overlap compute (the reference's DataLoader has workers forced to 0,
    main.py:923-924).  On a card the copies run on their own stream from
    pinned buffers; the consumer's stream waits for each batch on the
    device (``wait_event``), and the host never does.  Errors in the
    worker are raised in the consumer."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=max(1, size))
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        """Queue ``item`` unless the consumer has gone; → still wanted."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in batch_iter:
                if not put(_to_device(batch, device, stream)):
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            tensors, ready = item
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                for t in tensors:
                    t.record_stream(current)
            yield tensors
    finally:
        stop.set()
