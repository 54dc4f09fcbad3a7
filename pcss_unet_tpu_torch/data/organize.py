"""Scene split: raw renders → train/val pair directories (port of
``pcss_unet_tpu/data/organize.py``; the split is the same file for file,
``np.random.default_rng(seed).permutation`` on both sides).

Reference: organize_data.py:5-71 (``organize_dataset`` — shuffle the
EXR↔PNG pairs, copy a train fraction into ``data/train`` and the rest into
``data/val`` with the ``_input.exr`` / ``_gt.png`` suffix convention) and
organize_data.py:73-105 (``replace_exr_files`` — swap the ``*_input.exr``
files of an existing split dir for fresh renders by stem).
"""

from __future__ import annotations

import logging
import os
import shutil

import numpy as np


def _stem_map(directory: str, ext: str) -> dict[str, str]:
    out = {}
    for fname in sorted(os.listdir(directory)):
        if fname.lower().endswith(ext):
            out[fname[: -len(ext)]] = os.path.join(directory, fname)
    return out


def organize_dataset(scene_dir: str, out_dir: str,
                     train_fraction: float = 0.8, seed: int = 42,
                     exr_subdir: str = "conditioning_images",
                     png_subdir: str = "images") -> dict[str, int]:
    """Split matched EXR/PNG pairs into ``out_dir/{train,val}``.

    Pairs are matched by filename stem; unmatched files are warned about and
    skipped (organize_data.py:24-38 behavior).  Returns per-split counts.
    """
    exrs = _stem_map(os.path.join(scene_dir, exr_subdir), ".exr")
    pngs = _stem_map(os.path.join(scene_dir, png_subdir), ".png")
    stems = sorted(set(exrs) & set(pngs))
    for missing in sorted(set(exrs) ^ set(pngs)):
        logging.warning("unpaired file stem skipped: %s", missing)
    if not stems:
        raise FileNotFoundError(
            f"no matched EXR/PNG pairs under {scene_dir} "
            f"({exr_subdir}/*.exr ↔ {png_subdir}/*.png)")

    rng = np.random.default_rng(seed)
    order = list(rng.permutation(len(stems)))
    n_train = int(len(stems) * train_fraction)
    splits = {"train": order[:n_train], "val": order[n_train:]}
    counts = {}
    for split, idxs in splits.items():
        dest = os.path.join(out_dir, split)
        os.makedirs(dest, exist_ok=True)
        for i in idxs:
            stem = stems[i]
            shutil.copy2(exrs[stem], os.path.join(dest, f"{stem}_input.exr"))
            shutil.copy2(pngs[stem], os.path.join(dest, f"{stem}_gt.png"))
        counts[split] = len(idxs)
        logging.info("%s: %d pairs → %s", split, len(idxs), dest)
    return counts


def replace_exr_files(split_dir: str, source_dir: str) -> int:
    """Replace every ``*_input.exr`` in ``split_dir`` with the same-stem
    ``.exr`` from ``source_dir`` (organize_data.py:73-105: refresh inputs
    after re-rendering without redoing the split).  Returns the number
    replaced; stems missing from ``source_dir`` are left alone with a
    warning."""
    sources = _stem_map(source_dir, ".exr")
    n = 0
    for fname in sorted(os.listdir(split_dir)):
        if not fname.endswith("_input.exr"):
            continue
        stem = fname[: -len("_input.exr")]
        src = sources.get(stem)
        if src is None:
            logging.warning("no replacement for %s in %s", fname, source_dir)
            continue
        shutil.copy2(src, os.path.join(split_dir, fname))
        n += 1
    return n
