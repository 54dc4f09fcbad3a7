"""Train state and optimizer construction (port of
``pcss_unet_tpu/train/state.py``).

Optimizers mirror the reference's selection (main.py:952-957) as the JAX
package builds them with optax, ``zero_nans → core``:

- adam: torch Adam's L2-in-gradient weight decay (``add_decayed_weights``
  before ``scale_by_adam``), then the learning rate;
- adamw: ``optax.adamw`` (Adam, then decoupled decay of every parameter,
  BatchNorm scales and biases included, then the learning rate);
- sgd: L2, then momentum 0.9 (``trace``), then the learning rate.

``zero_nans`` replaces NaN (not ±Inf) gradients with 0.  The learning rate
is the schedule at the optimizer's count *before* it increments, as in
optax, so under warmup the first update is zero.  Everything is functional
over lists of tensors (``torch._foreach_*``) and the state is plain tensors
(``count``, ``mu``/``nu`` or ``trace``) that a checkpoint stores as they are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

B1, B2, EPS = 0.9, 0.999, 1e-8      # optax.scale_by_adam defaults


class Optimizer:
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, new_state)`` over lists of tensors, as an optax
    ``GradientTransformation``; ``lr(count)`` is the schedule."""

    def __init__(self, kind: str, lr: Callable, weight_decay: float,
                 momentum: float = 0.9):
        if kind not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer_type: {kind}")
        self.kind, self.lr = kind, lr
        self.weight_decay, self.momentum = weight_decay, momentum

    def init(self, params: list[torch.Tensor]) -> dict:
        count = torch.zeros((), dtype=torch.int32, device=params[0].device)
        zeros = [torch.zeros_like(p) for p in params]
        if self.kind == "sgd":
            return {"count": count, "trace": zeros}
        return {"count": count, "mu": zeros,
                "nu": [torch.zeros_like(p) for p in params]}

    def update(self, grads: list[torch.Tensor], state: dict,
               params: list[torch.Tensor]) -> tuple[list, dict]:
        g = [torch.where(torch.isnan(t), torch.zeros_like(t), t)
             for t in grads]                                   # zero_nans
        count = state["count"]
        if self.kind in ("adam", "sgd"):                       # L2 in the gradient
            g = torch._foreach_add(g, torch._foreach_mul(params, self.weight_decay))
        new = {"count": count + 1}
        if self.kind == "sgd":
            trace = torch._foreach_add(g, torch._foreach_mul(state["trace"],
                                                             self.momentum))
            u, new["trace"] = trace, trace
        else:
            mu = torch._foreach_add(torch._foreach_mul(g, 1 - B1),
                                    torch._foreach_mul(state["mu"], B1))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1 - B2),
                torch._foreach_mul(state["nu"], B2))
            c = (count + 1).to(params[0].dtype)
            bc1, bc2 = 1 - B1 ** c, 1 - B2 ** c
            u = [(m / bc1) / (torch.sqrt(v / bc2) + EPS) for m, v in zip(mu, nu)]
            if self.kind == "adamw":                           # decoupled decay
                u = torch._foreach_add(u, torch._foreach_mul(params, self.weight_decay))
            new["mu"], new["nu"] = mu, nu
        step_size = -self.lr(count).to(params[0].dtype)
        return [t * step_size for t in u], new


def make_optimizer(cfg, steps_per_epoch: int) -> Optimizer:
    """The optimizer ``cfg.optimizer_type`` names, with the warmup-cosine
    learning rate of ``train.schedule``."""
    from pcss_unet_tpu_torch.train.schedule import warmup_cosine_schedule

    lr = warmup_cosine_schedule(cfg.learning_rate, cfg.warmup_epochs,
                                cfg.num_epochs, steps_per_epoch,
                                cfg.lr_floor_fraction)
    kind = cfg.optimizer_type.lower()
    wd = cfg.weight_decay_adamw if kind == "adamw" else cfg.weight_decay_adam
    return Optimizer(kind, lr, wd, cfg.sgd_momentum)


@dataclass
class TrainState:
    """What training carries from step to step.  ``model`` holds the
    parameters and the BatchNorm running statistics (its buffers); the
    rest are tensors on the model's device: the optimizer's state, the
    step, the count of skipped steps (reference main.py:240-246, 315-317)
    and, with ``cfg.ema_decay > 0``, an EMA of the parameters (a distinct
    copy, one tensor per parameter; None = disabled)."""

    model: nn.Module
    tx: Optimizer
    opt_state: dict
    step: torch.Tensor
    skipped_steps: torch.Tensor
    ema_params: list[torch.Tensor] | None = None

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for _, p in self.model.named_parameters()]


def create_train_state(model: nn.Module, cfg, steps_per_epoch: int) -> TrainState:
    """A train state for ``model``'s current weights (the JAX package
    initializes its weights here; a torch module carries its own, see
    ``models.init.init_train_weights``)."""
    device = next(model.parameters()).device
    tx = make_optimizer(cfg, steps_per_epoch)
    params = [p.detach() for p in model.parameters()]
    return TrainState(
        model=model, tx=tx, opt_state=tx.init(params),
        step=torch.zeros((), dtype=torch.int64, device=device),
        skipped_steps=torch.zeros((), dtype=torch.int64, device=device),
        ema_params=([p.clone() for p in params]
                    if getattr(cfg, "ema_decay", 0.0) > 0 else None))
