"""The train and eval steps — the framework's hot loop (port of
``pcss_unet_tpu/train/step.py``).

What the reference does per batch in Python (main.py:237-423: input NaN
screen, AMP forward, loss, backward, per-parameter gradient triage, dynamic
clip, optimizer step) runs here as one sequence of device work that never
reads a value back to the host:

- input standardization on the device ((x−μ)/(σ+1e-8), setdata.py:316)
- the forward in the model's working dtype (bf16: convs in bf16 with the
  float32 parameters cast per forward, BatchNorm, losses and gradients in
  float32; bf16 needs no GradScaler)
- NaN gradient repair (``zero_nans``) inside the optimizer, the dynamic
  global-norm clip (main.py:356-358) before it
- the non-finite-loss skip: every new tensor (parameters, BatchNorm running
  statistics, optimizer state, EMA) is selected with ``torch.where`` against
  a device-side flag, and a skip counter increments (main.py:240-246,
  315-317) — no ``if loss.isfinite()`` on the host.

The step updates the ``TrainState`` in place and returns its metrics as
device tensors.  Randomness (dropout masks, perturbation noise) comes from
the ``torch.Generator`` the caller passes, on the batch's device.
"""

from __future__ import annotations

from typing import Callable

import torch

from pcss_unet_tpu_torch.losses import LossBundle, enhanced_loss, standard_loss
from pcss_unet_tpu_torch.train.schedule import clip_norm_for_step
from pcss_unet_tpu_torch.train.state import TrainState


def standardize(x: torch.Tensor, means: torch.Tensor,
                stds: torch.Tensor) -> torch.Tensor:
    """Per-channel standardization with train-set stats (setdata.py:316)."""
    return (x - means) / (stds + 1e-8)


def _global_norm(ts: list[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in ts))


def _stats_on(means, stds) -> Callable:
    """device → the train-set (means, stds) as float32 tensors there,
    copied once per device."""
    cache = {}

    def on(device):
        if device not in cache:
            cache[device] = tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                                  for a in (means, stds))
        return cache[device]
    return on


def build_train_step(cfg, bundle: LossBundle, means, stds,
                     steps_per_epoch: int, per_block_norms: bool = True,
                     teacher=None) -> Callable:
    """→ ``train_step(state, x, y, generator) -> metrics`` (updates
    ``state`` in place).

    ``per_block_norms`` adds a ``grad_norm/<block>`` metric per top-level
    module (of the clipped gradients), the reference's per-module backward
    hooks (main.py:180-222) without the hooks.

    ``teacher``: an eval-mode UNet for distillation (paper.md:143): it runs
    on the same standardized batch without gradients, and
    ``cfg.distill_weight · mean((out − teacher_out)²)`` joins the loss.

    ``cfg.grad_accum_steps > 1`` splits the batch into that many equal
    microbatches, sums their gradients in float32 and applies ONE update on
    their mean; each microbatch takes its own BatchNorm batch statistics and
    the running statistics chain through them.

    ``cfg.ema_decay > 0`` maintains ``state.ema_params`` (ema ← d·ema +
    (1−d)·θ after every applied update; skipped steps leave it untouched).

    With ``cfg.loss_type == 'perturb'`` the p perturbed forwards run in
    train mode without gradients, with one set of dropout masks drawn for
    all p copies (one dropout key under the reference's ``vmap``), and
    their BatchNorm statistics are discarded."""
    use_perturb = cfg.loss_type == "perturb"
    accum = max(1, int(getattr(cfg, "grad_accum_steps", 1)))
    ema_decay = float(getattr(cfg, "ema_decay", 0.0))
    distill_w = float(cfg.distill_weight)
    on = _stats_on(means, stds)

    def grads_one(state, stats, x_mb, y_mb, gen):
        """Gradients, new running stats and loss terms for one (micro)batch."""
        model = state.model
        b = x_mb.shape[0]
        masks = model.dropout_masks(b, gen, x_mb.device)
        pert_masks = model.dropout_masks(b, gen, x_mb.device) if use_perturb else None
        soft = None
        if teacher is not None:
            with torch.no_grad():
                soft = teacher(x_mb).float()
        out, new_stats = model.forward_train(x_mb, masks, stats)
        if use_perturb:
            def pert_apply(xp):
                # train-mode forward (dropout, batch-stat BN), BN updates
                # discarded — pert_loss.py:78-81 semantics
                return model.forward_train(xp, pert_masks, stats)[0]
            total, terms = enhanced_loss(bundle, pert_apply, x_mb, out, y_mb,
                                         training=True, generator=gen)
        else:
            total, terms = standard_loss(bundle, out, y_mb)
        if soft is not None:
            d = torch.mean((out.float() - soft) ** 2)
            total = total + distill_w * d
            terms = dict(terms, distill_loss=d, total_loss=total)
        grads = torch.autograd.grad(total, state.params)
        return list(grads), new_stats, {k: v.detach() for k, v in terms.items()}, \
            total.detach()

    def train_step(state: TrainState, x_raw: torch.Tensor, y: torch.Tensor,
                   generator: torch.Generator | None = None) -> dict:
        model = state.model
        m, s = on(x_raw.device)
        x = standardize(x_raw.float(), m, s)
        y = y.float()
        params = [p.detach() for p in state.params]
        old_stats = {n: t.detach() for n, t in model.named_buffers()
                     if ".running_" in n}
        if accum == 1:
            grads, new_stats, terms, total = grads_one(state, old_stats, x, y,
                                                       generator)
        else:
            b = x.shape[0]
            if b % accum:
                raise ValueError(f"batch size {b} is not divisible by "
                                 f"grad_accum_steps={accum}")
            mb = b // accum
            stats, gsum, seq = old_stats, None, []
            for i in range(accum):
                g, stats, terms_i, total_i = grads_one(
                    state, stats, x[i * mb:(i + 1) * mb], y[i * mb:(i + 1) * mb],
                    generator)
                g = [t.float() for t in g]
                gsum = g if gsum is None else torch._foreach_add(gsum, g)
                seq.append((terms_i, total_i))
            new_stats = stats
            # mean over microbatches, in the parameters' dtypes as at accum 1
            grads = [(t / accum).to(p.dtype) for t, p in zip(gsum, params)]
            terms = {k: torch.stack([t[k] for t, _ in seq]).mean()
                     for k in seq[0][0]}
            total = torch.stack([t for _, t in seq]).mean()

        # dynamic global-norm clip (main.py:356-358, 405)
        gnorm = _global_norm(grads)
        max_norm = clip_norm_for_step(state.step, steps_per_epoch,
                                      cfg.num_epochs, cfg.grad_clip_norm,
                                      cfg.grad_clip_decay)
        scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
        grads = [g * scale.to(g.dtype) for g in grads]

        updates, new_opt = state.tx.update(grads, state.opt_state, params)
        new_params = torch._foreach_add(params, updates)
        ok = torch.isfinite(total) & torch.isfinite(gnorm)

        # skip-update guard: non-finite loss or gradient norm → keep state
        with torch.no_grad():
            if state.ema_params is not None:
                d = torch.tensor(ema_decay, dtype=torch.float32)
                for e, p in zip(state.ema_params, new_params):
                    e.copy_(torch.where(ok, (e * d + p.float() * (1 - d)).to(e.dtype), e))
            for p, n in zip(state.params, new_params):
                p.copy_(torch.where(ok, n, p))
            buffers = dict(model.named_buffers())
            for name, t in new_stats.items():
                buffers[name].copy_(torch.where(ok, t, buffers[name]))
            for key, new in new_opt.items():
                old = state.opt_state[key]
                if isinstance(old, list):
                    for o, n in zip(old, new):
                        o.copy_(torch.where(ok, n, o))
                else:
                    old.copy_(torch.where(ok, new, old))
            skipped = (~ok).to(torch.int64)
            state.skipped_steps += skipped
            state.step += 1

        metrics = dict(terms)
        metrics["grad_norm"] = gnorm.detach()
        metrics["clip_max_norm"] = max_norm
        metrics["skipped"] = skipped
        if per_block_norms:
            blocks: dict[str, list] = {}
            for (name, _), g in zip(state.model.named_parameters(), grads):
                blocks.setdefault(name.split(".")[0], []).append(g)
            for block, gs in blocks.items():
                metrics[f"grad_norm/{block}"] = _global_norm(gs).detach()
        return metrics

    return train_step


def build_eval_step(cfg, bundle: LossBundle, means, stds) -> Callable:
    """Full-frame validation step (main.py:583-664): eval-mode forward
    (running statistics, no dropout) + loss components, without gradients.
    → ``eval_step(model, x, y, params=None) -> (terms, output)``;
    ``params``: tensors to run in place of the model's parameters, in
    ``named_parameters`` order (the EMA weights)."""
    on = _stats_on(means, stds)

    def eval_step(model, x_raw: torch.Tensor, y: torch.Tensor,
                  params: list[torch.Tensor] | None = None):
        dev = x_raw.device
        with torch.no_grad():
            was = model.training
            model.eval()
            try:
                x = standardize(x_raw.float(), *on(dev))
                if params is None:
                    out = model(x)
                else:
                    names = [n for n, _ in model.named_parameters()]
                    out = torch.func.functional_call(
                        model, dict(zip(names, params)), (x,))
                _, terms = standard_loss(bundle, out, y.float())
            finally:
                model.train(was)
        # perturbation is a train-only term (pert_loss.py:149); reference
        # validation reports it as 0
        terms["perturbation_loss"] = torch.zeros((), device=dev)
        return terms, out

    return eval_step
