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

Data parallelism is the same step in each rank of a process group
(``group``): each rank takes its rows of the global batch and all of them
compute the whole batch's step, with one explicit all-reduce of the
gradients and loss terms (``parallel/dp.py`` holds the reference's
explicit and ZeRO-1 formulations).  Spatial parallelism splits each of
those samples' frames into row shards over the ranks of a (data × spatial)
grid (``rows``, ``parallel/spatial.py``): the same step, each rank on its
rows, the halos exchanged inside the model and the losses.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from pcss_unet_tpu_torch.losses import LossBundle, enhanced_loss, standard_loss
from pcss_unet_tpu_torch.train.schedule import clip_norm_for_step
from pcss_unet_tpu_torch.train.state import TrainState
from pcss_unet_tpu_torch.utils.distributed import rank_slice
from pcss_unet_tpu_torch.utils.profiling import span


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


def rank_rows(batch: int, rank: int, world: int, accum: int = 1) -> np.ndarray:
    """The rows of a global batch of ``batch`` that rank ``rank`` of
    ``world`` takes for the group step, in the order it takes them: for each
    of the ``accum`` microbatches (rows [i·mb, (i+1)·mb), mb = batch /
    accum), the rank's equal share of it, in rank order.  On a (data ×
    spatial) grid, ``rank`` and ``world`` are the data index and the data
    axis's length: the spatial ranks of a data index take the same rows."""
    if batch % (world * accum):
        raise ValueError(f"batch {batch} does not divide over {world} ranks "
                         f"× {accum} microbatches")
    mb, share = batch // accum, batch // accum // world
    return np.concatenate([np.arange(i * mb + rank * share,
                                     i * mb + (rank + 1) * share)
                           for i in range(accum)])


def _grad_step(cfg, bundle: LossBundle, means, stds, steps_per_epoch: int,
               teacher, group, rows=None) -> Callable:
    """The part of the step before the clip: → ``grads(state, x_raw, y,
    generator) -> (params, grads, new running stats, terms, total)``; see
    ``build_train_step``."""
    use_perturb = cfg.loss_type == "perturb"
    accum = max(1, int(getattr(cfg, "grad_accum_steps", 1)))
    distill_w = float(cfg.distill_weight)
    on = _stats_on(means, stds)
    world = 1 if group is None else dist.get_world_size(group)
    spatial = 1 if rows is None else rows.count

    def grads_one(state, stats, x_mb, y_mb, gen):
        """Gradients, new running stats and loss terms for one (micro)batch
        of raw inputs ``x_mb``."""
        model = state.model
        b = x_mb.shape[0]
        # drawn for the group's whole (micro)batch, this data index's
        # samples kept (a sample's row shards share its masks)
        mine = slice(0, b) if group is None else rank_slice(group, b, spatial)

        def draw():
            return {k: m[mine] for k, m in model.dropout_masks(
                b * world // spatial, gen, x_mb.device).items()}
        with span("step.forward"):
            x_mb = standardize(x_mb, *on(x_mb.device))
            masks = draw()
            pert_masks = draw() if use_perturb else None
            soft = None
            if teacher is not None:
                with torch.no_grad():
                    soft = teacher(x_mb, rows=rows).float()
            out, new_stats = model.forward_train(x_mb, masks, stats,
                                                 group=group, rows=rows)
        if use_perturb:
            def pert_apply(xp):
                # train-mode forward (dropout, batch-stat BN), BN updates
                # discarded — pert_loss.py:78-81 semantics
                return model.forward_train(xp, pert_masks, stats, group=group,
                                           rows=rows)[0]
            total, terms = enhanced_loss(bundle, pert_apply, x_mb, out, y_mb,
                                         training=True, generator=gen,
                                         group=group, rows=rows)
        else:
            total, terms = standard_loss(bundle, out, y_mb, group=group,
                                         rows=rows)
        if soft is not None:
            d = torch.mean((out.float() - soft) ** 2)
            total = total + distill_w * d
            terms = dict(terms, distill_loss=d, total_loss=total)
        with span("step.backward"):
            grads = torch.autograd.grad(total, state.params)
        return list(grads), new_stats, {k: v.detach() for k, v in terms.items()}, \
            total.detach()

    def grads(state: TrainState, x_raw: torch.Tensor, y: torch.Tensor,
              generator: torch.Generator | None):
        model = state.model
        x = x_raw.float()
        y = y.float()
        params = [p.detach() for p in state.params]
        old_stats = {n: t.detach() for n, t in model.named_buffers()
                     if ".running_" in n}
        if accum == 1:
            g, new_stats, terms, total = grads_one(state, old_stats, x, y,
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
            g = [(t / accum).to(p.dtype) for t, p in zip(gsum, params)]
            terms = {k: torch.stack([t[k] for t, _ in seq]).mean()
                     for k in seq[0][0]}
            total = torch.stack([t for _, t in seq]).mean()
        if group is not None:
            g, terms, total = _all_reduce_mean(g, terms, total, group, world)
        return params, g, new_stats, terms, total

    return grads


def _clip(cfg, steps_per_epoch: int, state, g: list[torch.Tensor]):
    """The dynamic global-norm clip (main.py:356-358, 405): → (clipped
    grads, their norm before the clip, the step's max norm)."""
    gnorm = _global_norm(g)
    max_norm = clip_norm_for_step(state.step, steps_per_epoch,
                                  cfg.num_epochs, cfg.grad_clip_norm,
                                  cfg.grad_clip_decay)
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    return [t * scale.to(t.dtype) for t in g], gnorm, max_norm


def _all_reduce_mean(grads, terms, total, group, world):
    """The ranks' mean of the gradients, the loss terms and the total, in
    one all-reduce of one flat bucket."""
    keys = list(terms)
    scalars = torch.stack([terms[k] for k in keys] + [total]).to(grads[0].dtype)
    flat = torch.cat([t.reshape(-1) for t in grads] + [scalars])
    dist.all_reduce(flat, group=group)
    flat = flat / world
    out, i = [], 0
    for t in grads:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    means = flat[i:].to(total.dtype)
    return out, dict(zip(keys, means[:-1])), means[-1]


def _commit(state: TrainState, ok: torch.Tensor, new_params, new_stats,
            new_opt, ema_decay: float) -> torch.Tensor:
    """The skip-update guard: every new tensor replaces the old one where
    ``ok`` (finite loss and gradient norm), and the step and skip counters
    advance.  → the skipped flag."""
    with torch.no_grad():
        if state.ema_params is not None:
            d = torch.tensor(ema_decay, dtype=torch.float32)
            for e, p in zip(state.ema_params, new_params):
                e.copy_(torch.where(ok, (e * d + p.float() * (1 - d)).to(e.dtype), e))
        for p, n in zip(state.params, new_params):
            p.copy_(torch.where(ok, n, p))
        buffers = dict(state.model.named_buffers())
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
    return skipped


def _metrics(state, terms, grads, gnorm, max_norm, skipped,
             per_block_norms: bool) -> dict:
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


def build_train_step(cfg, bundle: LossBundle, means, stds,
                     steps_per_epoch: int, per_block_norms: bool = True,
                     teacher=None, group=None, rows=None) -> Callable:
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
    their BatchNorm statistics are discarded.

    ``group``: a ``torch.distributed`` process group of data-parallel
    ranks.  Each rank passes its rows of the global batch (``rank_rows``)
    and the same generator state, and the step computes the one-process
    step on the whole batch, as the reference's step does sharded over a
    mesh's data axis: dropout masks and perturbation noise are drawn for
    the whole batch and sliced to the rank's rows, BatchNorm (the
    perturbed forwards' too) and the perturbation's channel σ take the
    whole batch's statistics, and the gradients, loss terms and total are
    averaged over the ranks (one flat all-reduce) before the clip, so
    every rank applies the same update and the same skip decision.  The
    all-reduce is explicit: ``DistributedDataParallel`` hooks ``.backward()``
    and this step takes ``torch.autograd.grad``.

    ``rows``: ``group`` is a (data × spatial) grid and this rank holds its
    row shard of its data index's samples (``parallel/spatial.py::
    RowShard``; x and y [b, H/S, W, C], its rows of ``rank_rows`` of the
    data index).  Masks and noise are drawn for the whole batch and sliced
    to the data index (and the noise to the rows); convs, resizes, the VGG
    tower and the loss stencils exchange halos; BatchNorm, the channel σ,
    the penumbra ratio and SSIM take the grid's sums; the teacher runs its
    eval forward on the shard.  The step is still the one-process step on
    the whole frames."""
    ema_decay = float(getattr(cfg, "ema_decay", 0.0))
    grads = _grad_step(cfg, bundle, means, stds, steps_per_epoch, teacher,
                       group, rows)

    def train_step(state: TrainState, x_raw: torch.Tensor, y: torch.Tensor,
                   generator: torch.Generator | None = None) -> dict:
        with span("step"):
            params, g, new_stats, terms, total = grads(state, x_raw, y,
                                                       generator)
            with span("step.update"):
                with span("step.clip"):
                    g, gnorm, max_norm = _clip(cfg, steps_per_epoch, state, g)
                with span("step.optimizer"):
                    updates, new_opt = state.tx.update(g, state.opt_state,
                                                       params)
                    new_params = torch._foreach_add(params, updates)
                with span("step.commit"):
                    ok = torch.isfinite(total) & torch.isfinite(gnorm)
                    skipped = _commit(state, ok, new_params, new_stats,
                                      new_opt, ema_decay)
                with span("step.metrics"):
                    return _metrics(state, terms, g, gnorm, max_norm, skipped,
                                    per_block_norms)

    return train_step


def build_eval_step(cfg, bundle: LossBundle, means, stds, group=None,
                    rows=None) -> Callable:
    """Full-frame validation step (main.py:583-664): eval-mode forward
    (running statistics, no dropout) + loss components, without gradients.
    → ``eval_step(model, x, y, params=None) -> (terms, output)``;
    ``params``: tensors to run in place of the model's parameters, in
    ``named_parameters`` order (the EMA weights).

    ``group``: every rank of the group runs the step on its part of the
    batch (its samples and, with ``rows``, its row shard of their frames,
    as the train step) and the terms are averaged over the group, so every
    rank returns the whole batch's; ``output`` is the rank's part."""
    on = _stats_on(means, stds)
    world = 1 if group is None else dist.get_world_size(group)

    def eval_step(model, x_raw: torch.Tensor, y: torch.Tensor,
                  params: list[torch.Tensor] | None = None):
        dev = x_raw.device
        with torch.no_grad():
            was = model.training
            model.eval()
            try:
                x = standardize(x_raw.float(), *on(dev))
                if params is None:
                    out = model(x, rows=rows)
                else:
                    names = [n for n, _ in model.named_parameters()]
                    out = torch.func.functional_call(
                        model, dict(zip(names, params)), (x,), {"rows": rows})
                _, terms = standard_loss(bundle, out, y.float(), group=group,
                                         rows=rows)
                if group is not None:
                    keys = list(terms)
                    mean = torch.stack([terms[k] for k in keys])
                    dist.all_reduce(mean, group=group)
                    terms = dict(zip(keys, mean / world))
            finally:
                model.train(was)
        # perturbation is a train-only term (pert_loss.py:149); reference
        # validation reports it as 0
        terms["perturbation_loss"] = torch.zeros((), device=dev)
        return terms, out

    return eval_step
