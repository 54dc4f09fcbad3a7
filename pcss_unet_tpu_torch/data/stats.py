"""Per-channel dataset statistics — two-pass, float64, streaming (port of
``pcss_unet_tpu/data/stats.py``: the statistics pass behind
``python -m pcss_unet_tpu_torch stats`` and the loader of its artifact).

Reference: calculate_dataset_stats.py:23-108 — pass 1 accumulates per-channel
sums over the mmap'd train inputs, pass 2 accumulates squared deviations,
both in float64 (calculate_dataset_stats.py:53-79); results are saved as a
pickled dict in ``train_stats.npy`` plus a JSON twin
(calculate_dataset_stats.py:87-96).  Both artifact formats are preserved
byte-compatibly so reference tooling (and the JAX package) can consume ours
and vice versa.

The std is the population std (ddof=0), matching ``np.std`` and the
reference's ``sqrt(sq_sum / count)``.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np


def _resolve_layout(dataset_path: str, split: str, arr: np.ndarray,
                    layout: str | None) -> str:
    if layout:
        return layout
    meta_path = os.path.join(dataset_path, f"{split}_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            stored = json.load(f).get("layout")
        if stored:
            return stored
    # Autodetect: channels are the small axis (≤8); reference packs are
    # NCHW [N,4,H,W] (prepare_dataset.py:67-68), ours default NHWC.
    return "nchw" if arr.shape[1] <= 8 < arr.shape[3] else "nhwc"


def compute_channel_stats(dataset_path: str, split: str = "train",
                          chunk: int = 64, layout: str | None = None) -> dict:
    """Two-pass streaming mean/std over ``{split}_inputs.npy``.

    Writes ``{split}_stats.npy`` (pickled dict — the reference's
    ``train_stats.npy`` format) and ``{split}_stats.json``.  Returns
    ``{"means": [C], "stds": [C]}`` as float64 arrays.
    """
    path = os.path.join(dataset_path, f"{split}_inputs.npy")
    x = np.load(path, mmap_mode="r")
    layout = _resolve_layout(dataset_path, split, x, layout)
    axes = (0, 2, 3) if layout == "nchw" else (0, 1, 2)
    n_ch = x.shape[1] if layout == "nchw" else x.shape[3]

    # pass 1: Σx per channel (calculate_dataset_stats.py:59-67)
    total = np.zeros(n_ch, np.float64)
    count = 0
    per_sample = x[0].size // n_ch
    for i in range(0, x.shape[0], chunk):
        blk = np.asarray(x[i:i + chunk], np.float64)
        total += blk.sum(axis=axes)
        count += blk.shape[0] * per_sample
    means = total / count

    # pass 2: Σ(x−μ)² per channel (calculate_dataset_stats.py:71-79)
    mean_shaped = (means[None, :, None, None] if layout == "nchw"
                   else means[None, None, None, :])
    sq = np.zeros(n_ch, np.float64)
    for i in range(0, x.shape[0], chunk):
        blk = np.asarray(x[i:i + chunk], np.float64)
        sq += ((blk - mean_shaped) ** 2).sum(axis=axes)
    stds = np.sqrt(sq / count)

    for c in np.flatnonzero(stds < 1e-8):
        logging.warning("channel %d has ~zero std (%.3e): standardization "
                        "will rely on the +1e-8 guard (setdata.py:311-315)",
                        c, stds[c])

    stats = {"means": means, "stds": stds}
    np.save(os.path.join(dataset_path, f"{split}_stats.npy"),
            stats, allow_pickle=True)
    with open(os.path.join(dataset_path, f"{split}_stats.json"), "w") as f:
        json.dump({"means": means.tolist(), "stds": stds.tolist(),
                   "count_per_channel": int(count), "layout": layout}, f,
                  indent=2)
    logging.info("%s stats: means=%s stds=%s", split,
                 np.round(means, 5).tolist(), np.round(stds, 5).tolist())
    return stats


def load_channel_stats(dataset_path: str,
                       split: str = "train") -> tuple[np.ndarray, np.ndarray]:
    """Load the pickled-dict stats artifact (reference ``train_stats.npy``,
    read at setdata.py:262-284 — the TRAIN stats are used for every split).
    → (means[C] float32, stds[C] float32)."""
    path = os.path.join(dataset_path, f"{split}_stats.npy")
    stats = np.load(path, allow_pickle=True).item()
    return (np.asarray(stats["means"], np.float32),
            np.asarray(stats["stds"], np.float32))
