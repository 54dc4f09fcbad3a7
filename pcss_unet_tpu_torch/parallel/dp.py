"""Explicit data-parallel train steps: the replicated step and ZeRO-1 (port
of ``pcss_unet_tpu/parallel/dp.py``).

The reference has two formulations of data parallelism: the automatic one
(``jit`` over a mesh, XLA inserts the collectives) and this explicit one
(``shard_map`` with hand-placed ``pmean``s and ``axis_name`` BatchNorm).
torch has no partitioner, so the port's only formulation is explicit: the
group step of ``train/step.py::build_train_step``.  This module keeps the
reference's builders over it, with the reference's refusals of the
perturbation loss, accumulation and (ZeRO-1) EMA.  The group step always
takes BatchNorm's statistics over the group's whole batch, so the
reference's other refusal, of a model built without sync-BN
(``bn_axis_name='data'``), has no state to refuse here.

- ``build_explicit_dp_train_step``: the group step, standard loss, no
  accumulation;
- ``create_zero1_state`` / ``build_zero1_dp_train_step``: the same step with
  the optimizer's state sharded over the ranks.  The optimizers are
  elementwise, so each rank keeps the moments of one chunk of the
  flattened, padded parameter vector (``ceil(n / N)`` elements), updates
  its chunk with ``train/state.py::Optimizer``, and the chunks are put back
  together in every rank by one all-reduce of a zero-filled vector (an
  all-gather made of the collective gloo also takes on CUDA tensors: x + 0
  is exact).  The gradients are still averaged whole (ZeRO-1, not ZeRO-2).

The reference's per-device dropout streams (``fold_in`` of the device
index) have no counterpart: the group step draws each mask for the whole
batch and slices it, so a step here equals the one-process step on the
whole batch.  Its ZeRO-1 also makes optax ``zero_nans``' found-NaN flag
global with a MAX reduction; the port's optimizer keeps no such flag (its
state is the count and the moments), so there is nothing to reduce.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from pcss_unet_tpu_torch.losses import LossBundle
from pcss_unet_tpu_torch.train.state import Optimizer, make_optimizer
from pcss_unet_tpu_torch.train.step import (_commit, _grad_step, _metrics,
                                            build_train_step)


def _require_explicit_supported(cfg, fn_name: str) -> None:
    """The explicit builders pin the standard-loss whole-batch semantics;
    the perturbation loss and gradient accumulation are refused, as the
    reference refuses them."""
    if getattr(cfg, "loss_type", "standard") != "standard":
        raise ValueError(f"{fn_name} implements the standard loss only; "
                         f"got loss_type={cfg.loss_type!r} — use "
                         "build_train_step with a group")
    if int(getattr(cfg, "grad_accum_steps", 1)) > 1:
        raise ValueError(f"{fn_name} does not implement gradient "
                         "accumulation; use build_train_step with a group")


def build_explicit_dp_train_step(cfg, bundle: LossBundle, means, stds,
                                 steps_per_epoch: int, group) -> Callable:
    """→ ``train_step(state, x, y, generator)`` with x, y this rank's rows
    of the global batch: the group step of ``build_train_step``.  Keeps
    ``state.ema_params`` where ``cfg.ema_decay > 0``.  (The reference also
    takes the model, for its sync-BN check.)"""
    _require_explicit_supported(cfg, "build_explicit_dp_train_step")
    return build_train_step(cfg, bundle, means, stds, steps_per_epoch,
                            per_block_norms=False, group=group)


@dataclass
class Zero1State:
    """Like ``TrainState``, but ``opt_state`` holds only this rank's chunk
    of the flattened parameters' optimizer state; ``n_flat`` is the
    unpadded parameter count and ``chunk`` each rank's share."""

    model: nn.Module
    tx: Optimizer
    opt_state: dict
    step: torch.Tensor
    skipped_steps: torch.Tensor
    n_flat: int
    chunk: int
    ema_params: None = None

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for _, p in self.model.named_parameters()]


def _flat(ts: list[torch.Tensor], size: int) -> torch.Tensor:
    """The tensors flattened into one vector, zero-padded to ``size``."""
    flat = torch.cat([t.reshape(-1) for t in ts])
    return torch.nn.functional.pad(flat, (0, size - flat.numel()))


def create_zero1_state(model: nn.Module, cfg, steps_per_epoch: int,
                       group) -> Zero1State:
    """The ZeRO-1 state of ``model``'s current weights: this rank's chunk
    of the optimizer state."""
    params = [p.detach() for p in model.parameters()]
    n_flat = sum(p.numel() for p in params)
    world = dist.get_world_size(group)
    chunk = -(-n_flat // world)
    r = dist.get_rank(group)
    mine = _flat(params, chunk * world)[r * chunk:(r + 1) * chunk]
    tx = make_optimizer(cfg, steps_per_epoch)
    device = params[0].device
    return Zero1State(
        model=model, tx=tx, opt_state=tx.init([mine]),
        step=torch.zeros((), dtype=torch.int64, device=device),
        skipped_steps=torch.zeros((), dtype=torch.int64, device=device),
        n_flat=n_flat, chunk=chunk)


def build_zero1_dp_train_step(cfg, bundle: LossBundle, means, stds,
                              steps_per_epoch: int, group) -> Callable:
    """The explicit step with ZeRO-1 sharded optimizer state:
    ``train_step(zero1_state, x, y, generator)``, x and y this rank's rows.
    Equal to the replicated explicit step (the partition is a memory
    layout).  Refuses EMA (``Zero1State`` keeps none), as the reference
    does.  (The reference also takes the state, to derive its shard specs,
    and the model, for its sync-BN check; here neither is needed.)"""
    _require_explicit_supported(cfg, "build_zero1_dp_train_step")
    if float(getattr(cfg, "ema_decay", 0.0)) > 0:
        raise ValueError("build_zero1_dp_train_step does not maintain EMA "
                         "parameters; use build_train_step with a group or "
                         "set ema_decay=0")
    grads = _grad_step(cfg, bundle, means, stds, steps_per_epoch, None, group)
    world = dist.get_world_size(group)
    r = dist.get_rank(group)

    def train_step(state: Zero1State, x_raw: torch.Tensor, y: torch.Tensor,
                   generator: torch.Generator | None = None) -> dict:
        params, g, new_stats, terms, total, gnorm, max_norm = grads(
            state, x_raw, y, generator)
        size = state.chunk * world
        mine = slice(r * state.chunk, (r + 1) * state.chunk)
        p_chunk = _flat(params, size)[mine]
        updates, new_opt = state.tx.update([_flat(g, size)[mine]],
                                           state.opt_state, [p_chunk])
        # the all-gather: every rank's chunk in place, zeros elsewhere, summed
        full = torch.zeros(size, dtype=p_chunk.dtype, device=p_chunk.device)
        full[mine] = p_chunk + updates[0]
        dist.all_reduce(full, group=group)
        new_params, i = [], 0
        for p in params:
            new_params.append(full[i:i + p.numel()].view_as(p))
            i += p.numel()
        ok = torch.isfinite(total) & torch.isfinite(gnorm)
        skipped = _commit(state, ok, new_params, new_stats, new_opt, 0.0)
        return _metrics(state, terms, g, gnorm, max_norm, skipped, False)

    return train_step
