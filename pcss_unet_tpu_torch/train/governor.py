"""Measured-step memory governor (port of ``pcss_unet_tpu/train/governor.py``).

The analytic estimator (``utils/memory.py``, mirroring the reference's
main.py:666-780 VRAM arithmetic) is a guess.  The JAX package asks XLA for
the static memory plan of the compiled train step; PyTorch has no such plan,
so here the governor *measures*: ``probe_step_memory`` runs ONE real train
step — the same ``build_train_step`` the loop runs, with the same loss
structure (perturbation, distillation) — on the card, at the candidate's
``grad_accum_steps`` and microbatch, on a zero batch of the training shape,
and reads the peak allocated memory (``torch.cuda.max_memory_allocated``
from a reset of the peak statistics).  An out-of-memory error there means
"does not fit"; any other error propagates.

The probe leaves the run untouched: it trains a deep copy of the model
(parameters and BatchNorm buffers) with its own ``create_train_state``, its
own loss bundle (the seeded VGG tower, which has the reference
architecture's shapes) and its own ``torch.Generator``, and frees what it
allocated.  On the CPU there are no allocator statistics: it returns None
and the analytic answer stands, as the JAX walk does when its probe
returns None.  ``governor = xla`` in config.ini (shared with the JAX
package) selects this measured probe in the port.

``find_accum_steps_compiled`` keeps the JAX name and walk: the divisors of
the per-device batch from ``start``, a ``safety`` factor of 1.15, the
device-cache reserve subtracted from the budget, the last probed candidate
when none fits, and None when no probe succeeded.

Reference contract: main.py:720-780 (fit-check with a safety buffer and a
search whose result is actually used here — SURVEY.md §2 'Memory
governor').
"""

from __future__ import annotations

import copy
import gc
import logging
import math
from typing import Callable

import torch

from pcss_unet_tpu_torch.utils.memory import device_budget


def _probe_setup(cfg, model, means, stds, batch: int, h: int, w: int,
                 steps_per_epoch: int):
    """The probe's own copy of everything a step touches, on the model's
    device: → (step, state, x, y, generator)."""
    from pcss_unet_tpu_torch.train.loop import _teacher, make_bundle
    from pcss_unet_tpu_torch.train.state import create_train_state
    from pcss_unet_tpu_torch.train.step import build_train_step

    device = next(model.parameters()).device
    probe_model = copy.deepcopy(model).train()
    state = create_train_state(probe_model, cfg, steps_per_epoch)
    # structure-true bundle: the seeded VGG tower has the reference
    # architecture's shapes, with or without the weights artifact
    bundle = make_bundle(cfg.replace(vgg_weights_path=""), device)
    teacher = _teacher(cfg, device) if cfg.distill_teacher else None
    step = build_train_step(cfg, bundle, means, stds, steps_per_epoch,
                            teacher=teacher)
    x = torch.zeros((batch, h, w, cfg.input_channels), device=device)
    y = torch.zeros((batch, h, w, 1), device=device)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    return step, state, x, y, generator


def run_probe_step(cfg, model, means, stds, batch: int, h: int, w: int,
                   steps_per_epoch: int = 100) -> dict:
    """One train step of a deep copy of ``model`` at ``cfg`` (its
    ``grad_accum_steps`` included) on a zero batch [batch, h, w, C], on the
    model's device.  → the step's metrics.  ``model`` and the global random
    state are left as they were."""
    with _own_random_state(model):
        step, *args = _probe_setup(cfg, model, means, stds, batch, h, w,
                                   steps_per_epoch)
        return step(*args)


def _own_random_state(model):
    """The global random state (host, and the model's card) restored on
    exit: building the probe's modules draws from it."""
    device = next(model.parameters()).device
    return torch.random.fork_rng(
        devices=[device] if device.type == "cuda" else [])


def probe_step_memory(cfg, model, means, stds, batch: int, h: int, w: int,
                      steps_per_epoch: int = 100) -> dict | None:
    """Peak device memory of ONE real train step at this config (module
    docstring).  → ``{"total": the peak allocated above what was allocated
    before the probe, "args": the probe's own state and batch, "temp":
    total − args, "out": 0}`` in bytes; ``total`` is ``inf`` (``"oom":
    True``) when the step ran out of memory; None on the CPU."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        return None
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    state_bytes = peak = None
    try:
        with _own_random_state(model):
            step, *inputs = _probe_setup(cfg, model, means, stds, batch, h, w,
                                         steps_per_epoch)
            torch.cuda.synchronize(device)
            state_bytes = torch.cuda.memory_allocated(device) - base
            step(*inputs)
            torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - base
    except torch.cuda.OutOfMemoryError:
        logging.info("measured step @accum=%d (batch %d): out of memory",
                     cfg.grad_accum_steps, batch)
    finally:
        step = inputs = None
        gc.collect()
        torch.cuda.empty_cache()
    if peak is None:
        return {"total": math.inf, "args": state_bytes or 0,
                "temp": math.inf, "out": 0, "oom": True}
    return {"total": peak, "args": state_bytes, "temp": peak - state_bytes,
            "out": 0, "oom": False}


def find_accum_steps_compiled(cfg, model, means, stds, per_chip_batch: int,
                              h: int, w: int, *,
                              hbm_bytes: int | None = None,
                              reserve_bytes: int = 0,
                              safety: float = 1.15,
                              start: int = 1,
                              probe: Callable | None = None) -> int | None:
    """Smallest divisor A of ``per_chip_batch`` whose measured step fits
    ``hbm_bytes - reserve_bytes`` with a ``safety`` buffer.

    ``start``: first candidate.  ``reserve_bytes``: device memory the step
    must coexist with (the device dataset cache).  ``hbm_bytes`` None: the
    model's device's budget (``utils/memory.py::device_budget``).  Returns
    None when no candidate's probe succeeds (caller falls back to
    analytic)."""
    if hbm_bytes is None:
        hbm_bytes = device_budget(None if model is None
                                  else next(model.parameters()).device)
    budget = hbm_bytes - reserve_bytes
    probe = probe or probe_step_memory
    probed_any = False
    last = None
    for a in range(max(1, start), per_chip_batch + 1):
        if per_chip_batch % a:
            continue
        plan = probe(cfg.replace(grad_accum_steps=a), model, means, stds,
                     per_chip_batch, h, w)
        if plan is None:
            continue
        probed_any = True
        last = a
        fits = plan["total"] * safety <= budget
        logging.info("measured step @accum=%d (microbatch %d): %.2f GiB "
                     "(state %.2f + step %.2f) vs %.2f GiB budget → %s",
                     a, per_chip_batch // a, plan["total"] / 2 ** 30,
                     plan["args"] / 2 ** 30, plan["temp"] / 2 ** 30,
                     budget / 2 ** 30, "OK" if fits else "too large")
        if fits:
            return a
    if probed_any:
        # every divisor was measured but none fit — microbatch 1 is the
        # floor; let the run have the final say, loudly
        logging.warning("no accumulation split fits the measured step "
                        "within %.2f GiB; proceeding with accum=%d",
                        budget / 2 ** 30, last)
        return last
    return None
