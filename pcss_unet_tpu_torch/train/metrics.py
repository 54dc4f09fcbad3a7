"""Metric writers (port of ``pcss_unet_tpu/train/metrics.py``).

Reproduces the reference's TensorBoard taxonomy (main.py:435-467, 509-533,
644-656): scalars ``Loss/{train,val}_{total,l1,vgg,perturbation}``,
``LR/learning_rate`` and periodic image grids (input RGB, alpha,
prediction, ground truth, |pred − gt|).  TensorBoard
(``torch.utils.tensorboard``) is optional: without it the writer is a JSONL
file, so headless training never loses metrics.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping

import numpy as np


class JsonlWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps(
            {"t": time.time(), "tag": tag, "value": float(value),
             "step": int(step)}) + "\n")

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        pass  # images only supported by the TB backend

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TBWriter:
    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self.writer.add_scalar(tag, float(value), int(step))

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        # img: [H, W, C] float in [0,1]
        self.writer.add_image(tag, np.clip(img, 0.0, 1.0), int(step),
                              dataformats="HWC")

    def flush(self) -> None:
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()


def make_writer(log_dir: str):
    """TensorBoard where ``torch.utils.tensorboard`` imports, else JSONL."""
    try:
        return TBWriter(log_dir)
    except ImportError:
        return JsonlWriter(log_dir)


def log_loss_scalars(writer, prefix: str, terms: Mapping[str, float],
                     step: int) -> None:
    """Scalar taxonomy of main.py:435-443 / 651-656."""
    name_map = {"total_loss": "total", "l1_loss": "l1", "vgg_loss": "vgg",
                "perturbation_loss": "perturbation"}
    for key, value in terms.items():
        short = name_map.get(key, key)
        writer.scalar(f"Loss/{prefix}_{short}", float(value), step)


def log_image_grid(writer, inputs: np.ndarray, prediction: np.ndarray,
                   target: np.ndarray, step: int) -> None:
    """Image grid of main.py:445-463: input RGB, input alpha, prediction,
    ground truth, absolute difference (first batch element)."""
    x = np.asarray(inputs[0], np.float32)
    pred = np.asarray(prediction[0], np.float32)
    tgt = np.asarray(target[0], np.float32)
    x_rng = x.max() - x.min() + 1e-8
    writer.image("Images/input_rgb", (x[..., :3] - x.min()) / x_rng, step)
    writer.image("Images/input_alpha", x[..., 3:4], step)
    writer.image("Images/prediction", pred, step)
    writer.image("Images/ground_truth", tgt, step)
    writer.image("Images/abs_diff", np.abs(pred - tgt), step)
