"""Determinism setup (port of ``pcss_unet_tpu/utils/prng.py``).

Reference: seed 42 into python/numpy/torch (main.py:73-92).  This seeds the
host-side RNGs the data pipeline uses and returns an explicit CPU
``torch.Generator`` seeded with ``seed`` (the JAX package returns its root
PRNG key); the port draws its randomness from explicit generators, never
from torch's global one."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
