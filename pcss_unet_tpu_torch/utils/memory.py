"""Memory governor: analytic device-memory estimate + live device stats
(port of ``pcss_unet_tpu/utils/memory.py``).

Reference: analytic VRAM estimator (params×2 + optimizer state + 18×
activation factor + fixed overhead, main.py:666-780), a free-memory check
with a 1.2× buffer (main.py:720-764), and a doubling search for batch size
(main.py:766-780, whose result the reference then ignores —
SURVEY.md §2 'Memory governor' row).  Here, as in the JAX package, the
result is actually *used* by the train CLI when batch_size=0 (auto).

The arithmetic is the JAX package's, unchanged, so the same inputs and
budget give the same answers (``tests/test_torch_governor.py``).  Its
activation factor was calibrated on compiled XLA plans and over-estimates
the port's steps on a card (batch 8 of 2048×1024: 124.9 GB estimated, 54.0
GB measured, ``PERF.md``): it is a pre-screen, and the measured probe
(``train/governor.py``) decides.  Where no budget is passed, it is the
card's total memory; on a host without a card, ``HBM_BYTES_DEFAULT``.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

HBM_BYTES_DEFAULT = 16 * 1024 ** 3  # the budget where no card is present


def param_count(params: Any) -> int:
    """Trainable parameters of an ``nn.Module`` (``.parameters()``: the
    BatchNorm running statistics are buffers and are not counted), or of a
    (nested) dict of arrays such as ``dict(model.named_parameters())`` or
    flax's ``variables["params"]``."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return int(np.prod(params.shape))


def estimate_memory_usage(n_params: int, batch_size: int, height: int,
                          width: int, in_ch: int = 4,
                          optimizer: str = "adamw",
                          compute_bytes: int = 2,
                          activation_factor: float | None = None,
                          overhead_bytes: int = 512 * 1024 ** 2) -> dict:
    """Analytic bytes estimate (structure mirrors main.py:697-712: params,
    gradients, optimizer state, activation factor, fixed overhead).

    The default activation factor is the JAX package's shape-aware
    ``170 + 45·(pixels·batch / 1M)``, fitted from above to compiled XLA
    plans; it is only the fast pre-screen (module docstring)."""
    param_bytes = n_params * 4                      # fp32 master params
    grad_bytes = n_params * 4
    opt_slots = {"adam": 2, "adamw": 2, "sgd": 1}.get(optimizer, 2)
    opt_bytes = n_params * 4 * opt_slots
    input_bytes = batch_size * height * width * in_ch * compute_bytes
    if activation_factor is None:
        activation_factor = 170.0 + 45.0 * (
            batch_size * height * width / 1e6)
    activation_bytes = int(input_bytes * activation_factor)
    total = (param_bytes + grad_bytes + opt_bytes + activation_bytes
             + overhead_bytes)
    return {"params": param_bytes, "grads": grad_bytes, "optimizer": opt_bytes,
            "activations": activation_bytes, "overhead": overhead_bytes,
            "total": total}


def device_memory_stats(device=None) -> dict | None:
    """Live memory stats of a card (``torch.cuda.mem_get_info`` and
    ``memory_stats``); None for the CPU or where there is no card.
    ``device`` None: the current card, if any."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "bytes_limit": int(total),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_free": int(free)}


def device_budget(device=None) -> int:
    """The memory budget of ``device``: a card's total memory, or
    ``HBM_BYTES_DEFAULT`` for the CPU."""
    stats = device_memory_stats(device)
    return (stats or {}).get("bytes_limit") or HBM_BYTES_DEFAULT


def check_memory(n_params: int, batch_size: int, height: int, width: int,
                 optimizer: str = "adamw", safety_factor: float = 1.2,
                 hbm_bytes: int | None = None) -> bool:
    """Does the estimated working set fit the budget with a 1.2× buffer?
    (main.py:720-764 role)."""
    est = estimate_memory_usage(n_params, batch_size, height, width,
                                optimizer=optimizer)
    if hbm_bytes is None:
        hbm_bytes = device_budget()
    fits = est["total"] * safety_factor <= hbm_bytes
    logging.info("memory estimate: %.2f GiB of %.2f GiB device memory "
                 "(batch %d) → %s", est["total"] / 2 ** 30,
                 hbm_bytes / 2 ** 30, batch_size,
                 "OK" if fits else "TOO LARGE")
    return fits


def find_accum_steps(n_params: int, batch_size: int, height: int,
                     width: int, optimizer: str = "adamw",
                     hbm_bytes: int | None = None) -> int:
    """Smallest divisor A of ``batch_size`` whose microbatch (batch/A) fits
    the budget — the gradient-accumulation auto-selector
    (cfg.grad_accum_steps=0).  Under accumulation only the per-microbatch
    activations are live, so the check runs on the microbatch.  Returns
    ``batch_size`` (microbatch 1) when even that estimate exceeds the
    budget — the caller warns, the run gets the final say."""
    for a in range(1, batch_size + 1):
        if batch_size % a:
            continue
        if check_memory(n_params, batch_size // a, height, width, optimizer,
                        hbm_bytes=hbm_bytes):
            return a
    return batch_size


def find_optimal_batch_size(n_params: int, height: int, width: int,
                            optimizer: str = "adamw", start: int = 1,
                            max_batch: int = 256,
                            hbm_bytes: int | None = None) -> int:
    """Largest power-of-two batch that fits (main.py:766-780 role — but the
    result is actually used here)."""
    batch = start
    best = start
    while batch <= max_batch:
        if check_memory(n_params, batch, height, width, optimizer,
                        hbm_bytes=hbm_bytes):
            best = batch
            batch *= 2
        else:
            break
    return best
