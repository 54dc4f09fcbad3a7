"""Pinned host buffers for copies between the host and the card that do not
make the host wait for the device.

A copy from pageable host memory to the card, or from the card into
pageable memory, returns only when every piece of work queued on the stream
before it has finished.  A server that keeps batches in flight therefore
copies through page-locked buffers with ``non_blocking=True``, and has to
reuse each buffer only once its copy is done: a buffer rewritten too early
gives a wrong mask without any error.
"""

from __future__ import annotations

import collections

import torch

__all__ = ["PinnedRing", "Slot"]


class Slot:
    """One pinned buffer and the event recorded behind its last copy."""

    def __init__(self, buf: torch.Tensor, key: tuple):
        self.buf, self.key = buf, key
        self.event: torch.cuda.Event | None = None

    def fence(self) -> None:
        """Record an event on the current stream behind the copy just
        enqueued from or into ``buf``."""
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self) -> None:
        """Block the host until the last fenced copy has finished."""
        if self.event is not None:
            self.event.synchronize()


class PinnedRing:
    """Pinned buffers of each (shape, dtype), reused in turn.

    ``take`` hands out a buffer that no copy in flight touches: a released
    one whose last copy has finished, a new one while fewer than ``DEPTH``
    of that shape exist, or else the oldest released one after waiting for
    its own copy alone.  The caller enqueues its copy, ``fence``s the slot,
    and ``release``s it once the host is done with the data: at once after
    an upload, after reading the data out after a download.  A slot that is
    not released is never handed out again.  Used from one thread."""

    DEPTH = 4    # two batches in flight, one being queued, one spare

    def __init__(self):
        self._free: dict = collections.defaultdict(collections.deque)
        self._made: collections.Counter = collections.Counter()

    def take(self, shape, dtype: torch.dtype) -> Slot:
        key = (tuple(shape), dtype)
        free = self._free[key]
        for slot in free:
            if slot.event is None or slot.event.query():
                free.remove(slot)
                return slot
        if not free or self._made[key] < self.DEPTH:
            self._made[key] += 1
            return Slot(torch.empty(key[0], dtype=dtype, pin_memory=True), key)
        slot = free.popleft()
        slot.wait()
        return slot

    def release(self, slot: Slot) -> None:
        self._free[slot.key].append(slot)
