"""The ``--grain`` input pipeline: a loader with ``Loader``'s interface and
threaded read-ahead (port of ``pcss_unet_tpu/data/grain_pipeline.py``,
without Grain).

The JAX package builds its sampling graph (seeded shuffle → shard slice →
batch, drop-remainder) with Grain's ``MapDataset`` and reads ahead on
Grain's threads.  Grain's shuffle is its compiled ``index_shuffle``
(``libindex_shuffle.so``), which neither numpy nor Grain's own pure-Python
twin reproduces, and the port does not depend on Grain.  So it keeps
the graph and its seed — ``(seed + 1) * 1_000_003 + epoch``, shuffle before
the shard slice, batches with the remainder dropped — and orders the
samples with numpy's seeded permutation of that seed (``Loader``'s).
Unshuffled plans equal the JAX package's; shuffled ones are a different
permutation (ROADMAP Queue 3, "Differences by design").

``epoch_indices`` is the contract the device cache (``device_cache.py``)
replays, which is what lets ``fit()`` take either loader.  The reference's
loading is a ``DataLoader`` with workers hard-disabled (main.py:923-924);
``read_workers > 0`` gathers batches ahead on a thread pool, in order.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

from pcss_unet_tpu_torch.data.pipeline import Loader


class GrainLoader(Loader):
    """``Loader``'s plan without crops (the Grain path is full-frame; use
    ``Loader`` for BASELINE config 1), read ahead on ``read_workers``
    threads."""

    def __init__(self, ds, batch_size: int, shuffle: bool = False,
                 seed: int = 0, shard_index: int = 0, shard_count: int = 1,
                 read_workers: int = 0):
        super().__init__(ds, batch_size, shuffle=shuffle, seed=seed,
                         shard_index=shard_index, shard_count=shard_count)
        self.read_workers = int(read_workers)

    def epoch(self, epoch: int, start_batch: int = 0):
        """Yield (inputs, labels) host batches of ``epoch`` from batch
        ``start_batch`` on; with ``read_workers > 0`` up to
        ``max(2, 2·read_workers)`` batches are gathered ahead."""
        if self.read_workers <= 0:
            yield from super().epoch(epoch, start_batch)
            return
        plan = self.epoch_indices(epoch)[start_batch:]
        depth = max(2, 2 * self.read_workers)
        with ThreadPoolExecutor(max_workers=self.read_workers) as pool:
            pending = collections.deque()
            try:
                for idx in plan:
                    pending.append(pool.submit(self.ds.gather, idx))
                    if len(pending) >= depth:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()
