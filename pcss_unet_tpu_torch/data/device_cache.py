"""Device-resident dataset cache (port of
``pcss_unet_tpu/data/device_cache.py``).

No reference equivalent: the reference re-streams every batch from host mmap
through ``DataLoader`` (setdata.py:243-245, main.py:847-865).  Shadow-mapping
packs are small (hundreds of frames), so the whole dataset fits device
memory — upload once, then gather + crop batches *on the card*
(``index_select`` and ``narrow``).  The hot loop does no host→device copy
of frames: each epoch's index plan goes up in one copy.

Correctness contract (``tests/test_torch_device_cache.py``): the cache is a
pure data-path optimization.  It consumes the same ``Loader.epoch_indices``
and ``Loader.crop_offsets`` as the host path, so batch streams are
bit-identical and a training run produces the same trajectory either way.
Under data parallelism each rank holds the dataset on its own card and
takes its rows of every batch (``batches(..., rows=...)``), the port's
counterpart of the JAX cache's ``shard`` placement.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from pcss_unet_tpu_torch.utils.profiling import span


def dataset_nbytes(ds) -> int:
    """Total bytes a device cache of ``ds`` would occupy (float32)."""
    if hasattr(ds, "inputs"):
        return int(ds.inputs.nbytes + ds.labels.nbytes)
    h, w = ds.sample_hw
    return len(ds) * h * w * 5 * 4  # 4 input channels + 1 label channel


def cache_eligible(cfg, ds) -> bool:
    """Policy: ``device_data_cache`` = on (always) | off (never) | auto
    (cache when the dataset fits ``device_cache_budget_mb``)."""
    mode = getattr(cfg, "device_data_cache", "off")
    if mode == "off":
        return False
    if mode == "on":
        return True
    if mode != "auto":
        raise ValueError(f"device_data_cache must be on|off|auto, got {mode!r}")
    budget = cfg.device_cache_budget_mb * (1 << 20)
    return dataset_nbytes(ds) <= budget


class DeviceCache:
    """A copy of a dataset on ``device`` with on-device batch gather.

    ``upload_chunk``: samples per host→device copy during the one-time
    upload (through ``ds.gather``, so NCHW packs arrive NHWC) — bounds host
    RAM for packs that need a transpose on the way up.
    """

    def __init__(self, ds, *, crop_hw: tuple[int, int] | None = None,
                 upload_chunk: int = 64,
                 device: str | torch.device = "cuda"):
        self.crop_hw = tuple(crop_hw) if crop_hw else None
        self.device = torch.device(device)
        n = len(ds)
        self.x = self.y = None
        step = max(1, upload_chunk)
        for i in range(0, n, step):
            x, y = ds.gather(np.arange(i, min(i + step, n)))  # NHWC float32
            if self.x is None:
                self.x = torch.empty((n, *x.shape[1:]), dtype=torch.float32,
                                     device=self.device)
                self.y = torch.empty((n, *y.shape[1:]), dtype=torch.float32,
                                     device=self.device)
            self.x[i:i + len(x)].copy_(torch.from_numpy(x))
            self.y[i:i + len(y)].copy_(torch.from_numpy(y))
        self.nbytes = (self.x.numel() + self.y.numel()) * 4
        logging.info("device cache: %d samples, %.1f MiB on %s",
                     n, self.nbytes / (1 << 20), self.device)

    def batches(self, loader, epoch: int, start_batch: int = 0, rows=None):
        """Yield (inputs, labels) batches on the device for ``epoch``,
        identical in content and order to ``loader.epoch(epoch,
        start_batch)``; ``rows`` (indices into each batch): only those
        rows, a data-parallel rank's."""
        if self.crop_hw != loader.crop_hw:
            raise ValueError(f"cache crop {self.crop_hw} != loader crop "
                             f"{loader.crop_hw}")
        batches = loader.epoch_indices(epoch)
        offsets = loader.crop_offsets(epoch, len(batches))
        if rows is not None:
            batches = batches[:, rows]
        plan = torch.from_numpy(np.ascontiguousarray(batches, np.int64)
                                ).to(self.device)
        for b in range(start_batch, len(batches)):
            # closed before the yield: the consumer's work is not the gather's
            with span("data.batch"):
                xb = self.x.index_select(0, plan[b])
                yb = self.y.index_select(0, plan[b])
                if offsets is not None:
                    ch, cw = self.crop_hw
                    oy, ox = (int(v) for v in offsets[b])
                    xb = xb.narrow(1, oy, ch).narrow(2, ox, cw).contiguous()
                    yb = yb.narrow(1, oy, ch).narrow(2, ox, cw).contiguous()
            yield xb, yb
