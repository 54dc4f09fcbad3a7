"""Per-channel dataset statistics (port of ``load_channel_stats`` from
``pcss_unet_tpu/data/stats.py``; the statistics pass itself waits for the
data CLIs, ROADMAP Queue 1 item 15)."""

from __future__ import annotations

import os

import numpy as np


def load_channel_stats(dataset_path: str,
                       split: str = "train") -> tuple[np.ndarray, np.ndarray]:
    """Load the pickled-dict stats artifact (reference ``train_stats.npy``,
    read at setdata.py:262-284 — the TRAIN stats are used for every split).
    → (means[C] float32, stds[C] float32)."""
    path = os.path.join(dataset_path, f"{split}_stats.npy")
    stats = np.load(path, allow_pickle=True).item()
    return (np.asarray(stats["means"], np.float32),
            np.asarray(stats["stds"], np.float32))
