"""Training loop — the reference's ``train_model`` (main.py:132-581), port
of ``pcss_unet_tpu/train/loop.py``.

- epoch/batch loops, per-epoch validation, best-checkpoint logic
  (main.py:225-561), with resume (the reference cannot resume), a
  mid-epoch cursor and a preemption handler;
- the step (``train/step.py``) queues its work and returns device tensors:
  the loop adds the metrics up on the device and reads them once per epoch
  (and every ``log_every`` steps), and keeps a host mirror of the step;
- TB scalars/images (main.py:435-467) through ``train/metrics.py``.

Data parallelism: ``fit(..., group=g)`` in every rank of a process group
trains with the group step (``train/step.py``).  Each rank reads the same
global batch and takes its rows (``rank_rows``), or, where the loader is
sharded per process (``--multihost``), its own shard's batch; rank 0 alone
validates, logs and writes checkpoints while the others wait at a barrier,
and every rank resumes from the same file.  Spatial parallelism in training
is ROADMAP Queue 1 item 14b.  When ``device_data_cache`` allows it (``data/device_cache.py::
cache_eligible``: on, or auto within ``device_cache_budget_mb``), the
dataset is uploaded once and batches are gathered and cropped on the
device, the same stream bit for bit; otherwise they stream from the host
loader through ``prefetch_to_device``.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from pcss_unet_tpu_torch.data.device_cache import DeviceCache, cache_eligible
from pcss_unet_tpu_torch.data.pipeline import Loader, prefetch_to_device
from pcss_unet_tpu_torch.losses import LossBundle, PerceptualLoss
from pcss_unet_tpu_torch.train.checkpoint import (CheckpointManager,
                                                  check_resume_compat)
from pcss_unet_tpu_torch.train.metrics import (log_image_grid,
                                               log_loss_scalars, make_writer)
from pcss_unet_tpu_torch.train.schedule import warmup_cosine_schedule
from pcss_unet_tpu_torch.train.state import TrainState, create_train_state
from pcss_unet_tpu_torch.train.step import (build_eval_step, build_train_step,
                                            rank_rows)


@dataclass
class FitResult:
    state: TrainState
    best_val_loss: float
    history: list = field(default_factory=list)


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: randomness is a function of
    (seed, step), so a resumed run draws what an uninterrupted one would."""
    return (seed + 1) * 1_000_003 + step


def to_host(tensors: dict) -> dict[str, float]:
    """Device scalars → floats in one transfer."""
    if not tensors:
        return {}
    vals = torch.stack([t.detach().double() for t in tensors.values()])
    return dict(zip(tensors, vals.cpu().tolist()))


def make_bundle(cfg, device) -> LossBundle:
    return LossBundle(
        perceptual=PerceptualLoss(cfg.vgg_weights_path or None,
                                  grad=cfg.vgg_grad, device=device),
        alpha=cfg.alpha, perturb_weight=cfg.perturb_weight,
        perturbation_count=cfg.perturbation_count,
        high_freq_weight=cfg.high_freq_weight,
        penumbra_weight=cfg.penumbra_weight, sobel_weight=cfg.sobel_weight,
        ssim_weight=cfg.ssim_weight)


def _teacher(cfg, device):
    """Distillation: eval-mode soft targets from a trained full-size net
    (paper.md:143); the checkpoint is the authority on its architecture."""
    from pcss_unet_tpu_torch.infer import load_variables
    from pcss_unet_tpu_torch.models.unet import unet_for_variables

    t_cfg = cfg.replace(model_depth=cfg.distill_teacher_depth,
                        base_width=cfg.distill_teacher_width)
    t_vars = load_variables(cfg.distill_teacher)
    teacher = unet_for_variables(t_cfg, t_vars, device=device,
                                 dtype=getattr(torch, cfg.compute_dtype))
    logging.info("distillation on: teacher=%s (depth %d, width %d), weight "
                 "%.3f", cfg.distill_teacher, cfg.distill_teacher_depth,
                 cfg.distill_teacher_width, cfg.distill_weight)
    return teacher.requires_grad_(False)


class _NoWriter:
    """The writer of ranks other than 0: takes everything, writes nothing."""

    def __getattr__(self, name):
        return lambda *a, **k: None


def fit(cfg, model, train_loader: Loader, val_loader: Loader | None = None,
        *, log_every: int = 100, image_every: int = 100, writer=None,
        checkpoint_dir: str | None = None, profile_dir: str | None = None,
        install_preemption_handler: bool = True,
        step_hook=None, group=None) -> FitResult:
    """Train ``model`` (the port's UNet, with its current weights, on its
    device) per ``cfg`` over the given loaders.

    ``profile_dir``: a torch.profiler trace (Chrome format) of epoch 0's
    first batches.  ``install_preemption_handler``: on SIGTERM/SIGINT,
    finish the current step, save a checkpoint, and exit cleanly.
    ``step_hook(host_step, epoch, batch_idx) -> bool``: called after every
    train step; returning True requests a graceful stop through the same
    checkpoint-and-exit path as a preemption signal.  ``group``: the
    process group of data-parallel ranks this one belongs to (see the
    module docstring); a stop any rank asks for stops them all."""
    # the handler first, so that a signal during set-up is still caught
    stop_requested = []
    prev_handlers = {}
    if install_preemption_handler:
        def _on_signal(signum, frame):  # noqa: ARG001
            logging.warning("signal %d received: will checkpoint and stop "
                            "after the current step", signum)
            stop_requested.append(signum)

        try:
            prev_handlers = {s: signal.signal(s, _on_signal)
                             for s in (signal.SIGTERM, signal.SIGINT)}
        except ValueError:  # not the main thread
            prev_handlers = {}

    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    # the per-step stop flag goes over gloo on the host, so reading it never
    # waits for the device (a new group: every process of the default
    # group calls fit)
    stop_group = group
    if group is not None and dist.get_backend(group) != "gloo":
        stop_group = dist.new_group(dist.get_process_group_ranks(group),
                                    backend="gloo")
    if cfg.spatial_parallel != 1:
        raise ValueError(
            f"spatial_parallel={cfg.spatial_parallel}: spatial parallelism "
            "in training is not ported yet (ROADMAP Queue 1 item 14b) — use "
            "python -m pcss_unet_tpu train")
    if cfg.data_parallel not in (-1, world):
        raise ValueError(
            f"data_parallel={cfg.data_parallel} with {world} rank(s): pass "
            "a process group of that many ranks (the train CLI starts them)")
    if train_loader.batches_per_epoch() < 1:
        raise ValueError(
            f"batch_size {train_loader.batch_size} yields no full batch "
            f"from {len(train_loader.ds)} training samples"
            f"{' on this host shard' if train_loader.shard_count > 1 else ''}"
            " — lower batch_size")
    device = next(model.parameters()).device
    steps_per_epoch = train_loader.batches_per_epoch()
    ds = train_loader.ds
    was_training = model.training
    model.train()
    state = create_train_state(model, cfg, steps_per_epoch)
    bundle = make_bundle(cfg, device)
    teacher = _teacher(cfg, device) if cfg.distill_teacher else None
    train_step = build_train_step(cfg, bundle, ds.means, ds.stds,
                                  steps_per_epoch, teacher=teacher, group=group)
    # this rank's rows of each global batch; a per-process shard is its own
    rows = None
    if group is not None and train_loader.shard_count == 1:
        rows = rank_rows(train_loader.batch_size, rank, world,
                         max(1, int(cfg.grad_accum_steps)))
    eval_step = build_eval_step(cfg, bundle, ds.means, ds.stds)
    lr_fn = warmup_cosine_schedule(cfg.learning_rate, cfg.warmup_epochs,
                                   cfg.num_epochs, steps_per_epoch,
                                   cfg.lr_floor_fraction)

    ckpt = None
    start_epoch = start_batch = 0
    if checkpoint_dir or cfg.save_dir:
        ckpt = CheckpointManager(checkpoint_dir or cfg.save_dir,
                                 max_to_keep=cfg.max_checkpoints_to_keep)
        if cfg.resume:
            check_resume_compat(cfg, ckpt.directory)
        if cfg.resume and ckpt.latest_epoch() is not None:
            state, cursor = ckpt.restore(state)
            last = int(ckpt.latest_epoch())
            if 0 <= cursor < steps_per_epoch:
                # mid-epoch save: pick up at the next batch of the
                # interrupted epoch — no replayed or skipped batches
                start_epoch, start_batch = last, cursor
                logging.info("resumed mid-epoch %d at batch %d (step %d)",
                             last, cursor, int(state.step))
            else:
                start_epoch = last + 1
                logging.info("resumed from epoch %d (step %d)", last,
                             int(state.step))

    if rank:
        ckpt, writer = None, _NoWriter()
    writer = writer or make_writer(cfg.log_dir)
    generator = torch.Generator(device=device)
    best_val = float("inf")
    history = []

    # Device-resident dataset cache: upload the packs once, gather/crop
    # batches on the device — no per-step host→device copies.  Falls back
    # to the streaming host path when the dataset exceeds the budget.
    train_cache = val_cache = None
    if cache_eligible(cfg, ds):
        train_cache = DeviceCache(ds, crop_hw=train_loader.crop_hw,
                                  device=device)
    if (val_loader is not None and val_loader.ds is not ds and rank == 0
            and cache_eligible(cfg, val_loader.ds)):
        val_cache = DeviceCache(val_loader.ds, crop_hw=val_loader.crop_hw,
                                device=device)
    elif val_loader is not None and val_loader.ds is ds:
        val_cache = train_cache

    def train_batches(epoch, skip=0):
        if train_cache is not None:
            return train_cache.batches(train_loader, epoch, start_batch=skip,
                                       rows=rows)
        host = train_loader.epoch(epoch, start_batch=skip)
        if rows is not None:
            host = ((x[rows], y[rows]) for x, y in host)
        return prefetch_to_device(host, device)

    def val_batches():
        if val_cache is not None:
            yield from val_cache.batches(val_loader, 0)
            return
        for x, y in val_loader.epoch(0):
            yield torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

    profiler = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        profiler = profile(activities=acts)
        profiler.start()

    def finish_profile():
        profiler.stop()
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        logging.info("wrote profiler trace to %s", profile_dir)

    first_logged = start_epoch > 0
    # host mirror of state.step: the step always advances it by one
    host_step = int(state.step)
    for epoch in range(start_epoch, cfg.num_epochs):
        epoch_t0 = time.time()
        metrics_acc = None   # device-side running sums; one transfer/epoch
        n_batches = 0
        skip = start_batch if epoch == start_epoch else 0
        batches_done = skip   # data-order cursor within this epoch
        batches = train_batches(epoch, skip)
        for x, y in batches:
            generator.manual_seed(step_seed(cfg.seed, host_step))
            metrics = train_step(state, x, y, generator)
            n_batches += 1
            batches_done += 1
            host_step += 1
            metrics_acc = metrics if metrics_acc is None else {
                k: metrics_acc[k] + v for k, v in metrics.items()}
            if not first_logged:
                loss = float(metrics["total_loss"])   # one sync, once
                logging.info("first train step done (%.1fs, loss %.5f)",
                             time.time() - epoch_t0, loss)
                first_logged = True
            if profiler is not None and n_batches >= 4:
                finish_profile()
                profiler = None
            if step_hook is not None and step_hook(host_step, epoch,
                                                   batches_done - 1):
                logging.info("step_hook requested stop at epoch %d batch %d",
                             epoch, batches_done - 1)
                stop_requested.append("step_hook")
            if group is not None:
                # every rank stops at the same step, or the others would
                # wait in the next step's collectives
                flag = torch.tensor([float(bool(stop_requested))])
                dist.all_reduce(flag, group=stop_group)
                if flag.item() and not stop_requested:
                    stop_requested.append("rank")
            if stop_requested:
                break
            if host_step % log_every == 0:
                metrics_host = to_host(metrics)
                log_loss_scalars(writer, "train_step", metrics_host, host_step)
                writer.scalar("LR/learning_rate", float(lr_fn(host_step)),
                              host_step)
                writer.scalar("Grad/global_norm", metrics_host["grad_norm"],
                              host_step)
        batches.close()

        train_avg = {k: v / max(1, n_batches)
                     for k, v in to_host(metrics_acc or {}).items()}
        log_loss_scalars(writer, "train", train_avg, epoch)

        val_avg = None
        if (val_loader is not None and rank == 0
                and epoch % cfg.validation_frequency == 0):
            val_acc = ema_acc = last = None   # device-side sums
            nv = 0
            for xd, yd in val_batches():
                terms, out = eval_step(model, xd, yd)
                last = (xd[:1], out[:1], yd[:1])
                val_acc = terms if val_acc is None else {
                    k: val_acc[k] + v for k, v in terms.items()}
                if state.ema_params is not None:
                    # the same batch through the EMA weights: the serving
                    # net's quality, observable during training
                    t2, _ = eval_step(model, xd, yd, params=state.ema_params)
                    ema_acc = (t2["total_loss"] if ema_acc is None
                               else ema_acc + t2["total_loss"])
                nv += 1
            if nv:
                if ema_acc is not None:
                    val_acc = dict(val_acc, total_loss_ema=ema_acc)
                val_avg = {k: v / nv for k, v in to_host(val_acc).items()}
                log_loss_scalars(writer, "val", val_avg, epoch)
                if image_every and last is not None:
                    log_image_grid(writer, *(t.float().cpu().numpy() for t in last),
                                   epoch)

        epoch_loss = (val_avg or train_avg).get("total_loss", float("inf"))
        history.append({"epoch": epoch, "train": train_avg, "val": val_avg,
                        "seconds": time.time() - epoch_t0})
        logging.info(
            "epoch %d/%d train %.5f%s (%.1fs, %d skipped)", epoch + 1,
            cfg.num_epochs, train_avg.get("total_loss", float("nan")),
            f" val {val_avg['total_loss']:.5f}" if val_avg else "",
            time.time() - epoch_t0, int(state.skipped_steps))

        mid_epoch_stop = bool(stop_requested) and batches_done < steps_per_epoch
        if ckpt is not None:
            is_best = epoch_loss < best_val
            periodic = epoch % max(1, cfg.save_frequency) == 0
            if (is_best or periodic or stop_requested
                    or epoch == cfg.num_epochs - 1):
                key = "val_loss" if val_avg else "train_loss"
                ckpt.save(state, {key: epoch_loss}, epoch,
                          cursor_batch=batches_done if mid_epoch_stop else None)
        if group is not None:
            dist.barrier(group)      # rank 0's checkpoint is on disk
        if not mid_epoch_stop:
            # a partial epoch's average is not comparable to full epochs'
            best_val = min(best_val, epoch_loss)
        if stop_requested:
            logging.warning("stopping at epoch %d on signal; checkpoint "
                            "saved — rerun to resume", epoch)
            break

    if profiler is not None:
        finish_profile()
    for s, h in prev_handlers.items():
        signal.signal(s, h)
    writer.flush()
    model.train(was_training)
    return FitResult(state=state, best_val_loss=best_val, history=history)
