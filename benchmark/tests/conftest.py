"""Shared set-up of the benchmark's CPU tests: the checkout's root on the
path, the ``cuda`` marker, and each cell shrunk to a size a test can hold
(the drivers' plain CPU path: the program's kernels run their plain
versions)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips where there is none)")


def tiny(cell: str):
    """(workload, configuration) of ``cell`` at a CPU test's size: frames
    of 64 x 128 (padded as the cell pads), two ring slots; the training
    cell on a (16, 32, 64, 128) net, batch 2 of 32 x 64 from 4 frames, in
    float32: at this size a bfloat16 step's pre-BatchNorm conv biases get
    rounding-noise gradients above the exclusion rule's thousandth of the
    median leaf, which at the cell's size fall far below it."""
    from benchmark import harness

    wl = copy.deepcopy(harness.workload(cell))
    cfg = copy.deepcopy(harness.config(wl["config"]))
    if wl["driver"] == "render":
        h = 60 if "pad_h" in wl else 64
        wl.update(frame_h=h, frame_w=128, ring=2, check_frames=2, trace_frames=2)
        if "pad_h" in wl:
            wl["pad_h"] = 64
    else:
        cfg["encoder_widths"] = [16, 32, 64, 128]
        cfg["train"].update(image_height=32, image_width=64, batch_size=2,
                            compute_dtype="float32")
        wl.update(cache_frames=4)
    return wl, cfg


@pytest.fixture
def card():
    """Skip where there is no CUDA card (decided inside the test)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
