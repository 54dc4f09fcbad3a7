"""Pack builder: EXR/PNG pair directories → mmap-able ``.npy`` arrays (port
of ``pcss_unet_tpu/data/records.py``; the packs equal the JAX package's
byte for byte, ``tests/test_torch_data.py``).

Reference: prepare_dataset.py:12-106.  Differences by design:

- **Streaming, constant RAM.**  The reference decodes the whole split, then
  ``np.stack``s it in memory (prepare_dataset.py:67-68).  We preallocate the
  destination ``.npy`` as a memmap and write each decoded pair into its slot;
  peak memory is one decode worker's frame per thread.
- **NHWC default** (the layout the trainer reads); ``layout="nchw"``
  writes packs bit-compatible with the reference's [N,4,H,W] artifacts.
- Decode runs on a thread pool: the native EXR codec releases the GIL.
- Error-skip policy preserved: a corrupt pair is logged and skipped, and the
  pack is shrunk to the number of good samples (prepare_dataset.py:59-61).

``export_per_file`` rebuilds the orphan per-file preprocessor capability
(preprocess.py:31-64) — one ``.npz`` per pair with optional per-channel
min-max normalization — without its (W,H)-transposed reshape bug
(preprocess.py:21,28; every other reference reader uses (H,W), setdata.py:47).
"""

from __future__ import annotations

import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pcss_unet_tpu_torch.data.pipeline import discover_pairs
from pcss_unet_tpu_torch.io.exr import read_exr_stack
from pcss_unet_tpu_torch.io.png import read_label_png


def _decode_pair(exr_path: str, png_path: str):
    """→ (input [H,W,4] float32 scrubbed, label [H,W,1] float32 in [0,1]).

    Label is NEAREST-resized to the input resolution on mismatch
    (prepare_dataset.py:49-52)."""
    x = read_exr_stack(exr_path)
    y = read_label_png(png_path, target_hw=x.shape[:2])[..., None]
    return x, y


def _shrink_pack(path: str, new_n: int, chunk: int = 64) -> None:
    """Rewrite a packed .npy with fewer leading rows (skip-policy fallout),
    copying in chunks to stay constant-RAM."""
    src = np.load(path, mmap_mode="r")
    tmp = path + ".tmp"
    dst = np.lib.format.open_memmap(tmp, mode="w+", dtype=src.dtype,
                                    shape=(new_n, *src.shape[1:]))
    for i in range(0, new_n, chunk):
        j = min(i + chunk, new_n)
        dst[i:j] = src[i:j]
    dst.flush()
    del src, dst
    os.replace(tmp, path)


def build_packs(pair_dir: str, out_dir: str, split: str,
                layout: str = "nhwc", num_workers: int = 8) -> dict:
    """Pack every pair under ``pair_dir`` into
    ``{out_dir}/{split}_inputs.npy`` + ``{split}_labels.npy`` (+ meta JSON).

    Returns the meta dict: ``{"count", "height", "width", "layout"}``.
    """
    if layout not in ("nhwc", "nchw"):
        raise ValueError(f"layout must be nhwc|nchw, got {layout!r}")
    pairs = discover_pairs(pair_dir)
    if not pairs:
        raise FileNotFoundError(f"no *_input.exr ↔ *_gt.png pairs in {pair_dir}")
    os.makedirs(out_dir, exist_ok=True)

    # Probe resolution from the first decodable pair.
    probe = None
    for exr, png in pairs:
        try:
            probe = _decode_pair(exr, png)
            break
        except Exception as e:  # noqa: BLE001 — skip policy
            logging.warning("skipping %s: %s", exr, e)
    if probe is None:
        raise RuntimeError(f"no decodable pairs in {pair_dir}")
    h, w = probe[0].shape[:2]

    in_path = os.path.join(out_dir, f"{split}_inputs.npy")
    lb_path = os.path.join(out_dir, f"{split}_labels.npy")
    in_shape = (len(pairs), h, w, 4) if layout == "nhwc" else (len(pairs), 4, h, w)
    lb_shape = (len(pairs), h, w, 1) if layout == "nhwc" else (len(pairs), 1, h, w)
    inputs = np.lib.format.open_memmap(in_path, mode="w+",
                                       dtype=np.float32, shape=in_shape)
    labels = np.lib.format.open_memmap(lb_path, mode="w+",
                                       dtype=np.float32, shape=lb_shape)

    def decode(pair):
        try:
            x, y = _decode_pair(*pair)
            if x.shape[:2] != (h, w):
                raise ValueError(f"resolution {x.shape[:2]} != pack ({h},{w})")
            return x, y
        except Exception as e:  # noqa: BLE001 — skip policy
            logging.warning("skipping %s: %s", pair[0], e)
            return None

    count = 0
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        for decoded in pool.map(decode, pairs):
            if decoded is None:
                continue
            x, y = decoded
            if layout == "nchw":
                x, y = x.transpose(2, 0, 1), y.transpose(2, 0, 1)
            inputs[count] = x
            labels[count] = y
            count += 1
    inputs.flush()
    labels.flush()
    del inputs, labels
    if count < len(pairs):
        _shrink_pack(in_path, count)
        _shrink_pack(lb_path, count)

    meta = {"count": count, "height": h, "width": w, "layout": layout}
    with open(os.path.join(out_dir, f"{split}_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    logging.info("%s: packed %d/%d pairs at %dx%d (%s)", split, count,
                 len(pairs), h, w, layout)
    return meta


def export_per_file(pair_dir: str, out_dir: str, normalize: str = "none",
                    num_workers: int = 8) -> int:
    """One ``{stem}.npz`` per pair with ``input`` [H,W,4] and ``label``
    [H,W,1] arrays; ``normalize="minmax"`` rescales each input channel to
    [0,1] (preprocess.py:40-49 semantics).  Returns the number exported."""
    if normalize not in ("none", "minmax"):
        raise ValueError(f"normalize must be none|minmax, got {normalize!r}")
    pairs = discover_pairs(pair_dir)
    if not pairs:
        raise FileNotFoundError(f"no pairs in {pair_dir}")
    os.makedirs(out_dir, exist_ok=True)

    def export(pair):
        exr, png = pair
        stem = os.path.basename(exr)[: -len("_input.exr")]
        try:
            x, y = _decode_pair(exr, png)
        except Exception as e:  # noqa: BLE001 — skip policy
            logging.warning("skipping %s: %s", exr, e)
            return 0
        if normalize == "minmax":
            lo = x.min(axis=(0, 1), keepdims=True)
            hi = x.max(axis=(0, 1), keepdims=True)
            x = (x - lo) / (hi - lo + 1e-8)
        np.savez(os.path.join(out_dir, f"{stem}.npz"), input=x, label=y)
        return 1

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        return sum(pool.map(export, pairs))
