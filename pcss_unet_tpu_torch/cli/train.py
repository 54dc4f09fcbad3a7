"""Training CLI (port of ``pcss_unet_tpu/cli/train.py``; the reference's
main.py role).

    python -m pcss_unet_tpu_torch train --config config.ini \\
        --processed_data_dir D --save_dir C [--allow_random_vgg] [...]

Every flag of the JAX CLI, plus ``--device`` (default ``cuda``: the card,
or raise where there is none; ``cpu`` for the tests; ``cuda:K``: card K).  Reference flags:
``--loss_type {standard,perturb}``, ``--perturb_weight`` (main.py:870-873),
config via INI (main.py:875-885).  ``--batch_size 0`` engages the memory
governor's doubling search (main.py:766-780 role — and unlike the
reference, the result is used); ``--grad_accum_steps 0`` picks the
smallest accumulation split that fits, with the measured probe
(``train/governor.py``) when ``governor = xla``.  ``--grain`` takes the
port's ``data/grain_pipeline.py::GrainLoader``.

Data parallelism is one process per rank, joined by ``torch.distributed``:

- ``--data_parallel N`` (N > 1) on one host: the CLI starts N ranks itself
  (``torch.multiprocessing``, joined through a file store under the save
  dir).  Rank r trains on ``cuda:r`` (``--device cuda``: N cards needed,
  NCCL), on the CPU (``--device cpu``, gloo) or, with ``--device cuda:K``,
  all on card K (gloo: NCCL refuses two ranks on one card).  Every rank
  reads the same global batch of ``batch_size`` and takes its rows, so the
  run trains what ``--data_parallel 1`` trains.  ``-1`` (the default) is
  gcd(batch_size, visible cards): 1 on the CPU.  Rank 0 alone writes
  ``resolved_config.json``, the logs and the checkpoints.
- ``--multihost``: this process is one rank of a group whose launcher set
  ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and
  ``LOCAL_RANK`` (torchrun's names; ``cuda:LOCAL_RANK``, NCCL, or the CPU
  with gloo).  Each process reads ``batch_size`` samples per step from its
  own shard of the training set (``host_shard_args``), so a step trains on
  ``batch_size × WORLD_SIZE / spatial_parallel`` samples; every rank
  validates its part of the whole validation set.

Spatial parallelism, ``--spatial_parallel S`` (S > 1), splits every frame
into S row shards, one per rank: ``--data_parallel D --spatial_parallel S``
starts D·S ranks on the devices above (rank r is cell (r // S, r % S) of the
data × spatial grid) and trains what ``--spatial_parallel 1`` trains
(``parallel/spatial.py``); with ``--multihost`` WORLD_SIZE must be a
multiple of S.  A frame height whose shards are not a multiple of the row
alignment (16 for the reference net) exits non-zero, naming it.  The
memory governor keeps the JAX CLI's arithmetic (a chip's batch is
batch_size / D; S does not enter), so ``resolved_config.json`` is the JAX
CLI's."""

import argparse
import logging
import math
import os
import shutil
import sys
import tempfile

from pcss_unet_tpu_torch.config import load_config, save_config
from pcss_unet_tpu_torch.utils.logging import setup_logger


def _rank_devices(device: str, n: int) -> list:
    """The devices of ``n`` ranks started on this host: the CPU, card K for
    every rank (``cuda:K``), or cards 0 … n−1 (``cuda``; raises where there
    are fewer)."""
    import torch

    from pcss_unet_tpu_torch.parallel.mesh import make_mesh

    if device == "cpu" or ":" in device:
        return [torch.device(device)] * n
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [row[0] for row in make_mesh(n, 1, cards).devices]


def _rank_main(rank: int, argv: list, devices: list, init_method: str) -> None:
    """A rank started by ``main``: join the group, then train."""
    main(argv, _rank=(rank, devices, init_method))


def _start_ranks(argv: list, devices: list, save_dir: str) -> None:
    """Run ``main(argv)`` in ``len(devices)`` new processes, rank r on
    ``devices[r]``, joined through a file store under ``save_dir``; raises
    if any of them fails (the others are stopped)."""
    import torch.multiprocessing as mp

    os.makedirs(save_dir, exist_ok=True)
    store = tempfile.mkdtemp(prefix=".ranks-", dir=save_dir)
    try:
        mp.spawn(_rank_main, args=(argv, devices,
                                   f"file://{os.path.join(store, 'store')}"),
                 nprocs=len(devices), join=True)
    finally:
        shutil.rmtree(store, ignore_errors=True)


def main(argv=None, _rank=None):
    """Run the CLI; returns ``fit``'s ``FitResult`` (rank 0's), or None
    where the ranks ran in processes of their own."""
    p = argparse.ArgumentParser(description="Train the shadow U-Net")
    p.add_argument("--config", default="config.ini")
    # reference CLI surface (main.py:870-873)
    p.add_argument("--loss_type", choices=["standard", "perturb"], default=None)
    p.add_argument("--perturb_weight", type=float, default=None)
    # framework overrides
    p.add_argument("--batch_size", type=int, default=None,
                   help="0 → auto (memory-governor doubling search)")
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--ema_decay", type=float, default=None,
                   help="exponential-moving-average decay for a parallel "
                        "set of serving weights (0 = off)")
    p.add_argument("--grad_accum_steps", type=int, default=None,
                   help="split each batch into N sequential microbatches "
                        "(float32 gradient accumulation, one optimizer "
                        "update); batch_size must divide by it; 0 → auto "
                        "(the memory governor)")
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--processed_data_dir", default=None)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--no_shuffle", action="store_true",
                   help="reference-parity mode: train without shuffling "
                        "(the reference's default, main.py:850)")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--data_parallel", type=int, default=None)
    p.add_argument("--spatial_parallel", type=int, default=None)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of the first steps")
    p.add_argument("--multihost", action="store_true",
                   help="one rank of a multi-process run whose launcher set "
                        "MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE/LOCAL_RANK")
    p.add_argument("--grain", action="store_true",
                   help="the Grain-interface input pipeline "
                        "(data/grain_pipeline.py)")
    p.add_argument("--grain_workers", type=int, default=0)
    # distillation (paper.md:143 deployment trimming)
    p.add_argument("--distill_teacher", default=None,
                   help="teacher checkpoint (.npz export or .pth) — enables "
                        "distillation of the (trimmed) model being trained")
    p.add_argument("--distill_teacher_depth", type=int, default=None)
    p.add_argument("--distill_teacher_width", type=int, default=None)
    p.add_argument("--distill_weight", type=float, default=None)
    p.add_argument("--allow_random_vgg", action="store_true",
                   help="proceed even when no converted ImageNet VGG-19 "
                        "artifact exists (vgg_weights_path unset/missing): "
                        "the perceptual term then runs on seeded-random "
                        "features — a usable embedding, but NOT loss-value "
                        "parity with the reference (customLoss.py:20)")
    p.add_argument("--device", default="cuda",
                   help="where training runs: cuda (the card, or raise; "
                        "rank r on cuda:r), cuda:K or cpu")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(argv)
    if args.device not in ("cuda", "cpu") and not args.device.startswith("cuda:"):
        p.error(f"--device: cuda, cuda:K or cpu, not {args.device!r}")

    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("config", "no_shuffle", "no_resume",
                              "profile_dir", "multihost", "grain",
                              "grain_workers", "allow_random_vgg", "device")
                 and v is not None}
    cfg = load_config(args.config, overrides)
    spatial = cfg.spatial_parallel

    # The reference trains its perceptual term on ImageNet VGG-19 features
    # (customLoss.py:20).  Without the converted artifact only seeded-random
    # features are possible: refuse unless the user opts in.  alpha == 1.0
    # gives the VGG term zero weight, so pure-L1 runs are unaffected.
    from pcss_unet_tpu_torch.models.vgg import vgg_weights_provenance

    vgg_prov = vgg_weights_provenance(cfg.vgg_weights_path)
    if (cfg.alpha < 1.0 and vgg_prov == "random-seeded-fallback"
            and not args.allow_random_vgg):
        raise SystemExit(
            "loss_type %r blends a perceptual (VGG) term (alpha=%.2f < 1) "
            "but no converted ImageNet VGG-19 artifact is available "
            "(vgg_weights_path=%r). Either produce the artifact on a "
            "machine with torchvision:\n"
            "    python scripts/convert_vgg_weights.py --out "
            "vgg19_imagenet.npz\n"
            "and set vgg_weights_path, or pass --allow_random_vgg to train "
            "on seeded-random VGG features (usable, but not loss-value "
            "parity with the reference), or set alpha = 1.0 for pure L1."
            % (cfg.loss_type, cfg.alpha, cfg.vgg_weights_path))
    if args.no_shuffle:
        cfg = cfg.replace(shuffle=False)
    if args.no_resume:
        cfg = cfg.replace(resume=False)

    import torch
    import torch.distributed as dist

    from pcss_unet_tpu_torch.utils.distributed import (TIMEOUT, backend_for,
                                                       host_shard_args,
                                                       initialize_multihost,
                                                       local_rank)

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: training runs on the card "
                           "(pass --device cpu to run on the CPU)")
    device, group = args.device, None
    if args.multihost:
        initialize_multihost(backend="nccl" if device == "cuda" else "gloo")
        group = dist.group.WORLD
        if dist.get_world_size() % spatial:
            raise ValueError(f"--multihost: WORLD_SIZE={dist.get_world_size()} "
                             f"is not a multiple of spatial_parallel={spatial}")
        if device == "cuda":
            device = f"cuda:{local_rank()}"
    elif _rank is not None:
        rank, devices, init_method = _rank
        dist.init_process_group(backend_for(devices), init_method=init_method,
                                world_size=len(devices), rank=rank,
                                timeout=TIMEOUT)
        group, device = dist.group.WORLD, str(devices[rank])
    else:
        dp = cfg.data_parallel
        if dp == -1:
            # the largest data axis that divides the batch and the cards
            # the spatial axis leaves
            cards = torch.cuda.device_count() if device == "cuda" else spatial
            dp = math.gcd(cfg.batch_size, max(1, cards // spatial))
        if spatial > 1:
            _check_rows(cfg)
        if dp * spatial > 1:
            _start_ranks(argv, _rank_devices(device, dp * spatial), cfg.save_dir)
            return None
    data = 1
    if group is not None:
        world = dist.get_world_size()
        if cfg.data_parallel not in (-1, world // spatial):
            raise ValueError(f"data_parallel={cfg.data_parallel} in a group "
                             f"of {world} ranks of spatial_parallel={spatial}")
        # a --multihost rank's batch is its own already
        data = 1 if args.multihost else world // spatial
    if device.startswith("cuda:"):
        torch.cuda.set_device(torch.device(device))
    rank0 = group is None or dist.get_rank() == 0
    try:
        return _train(cfg, args, device, group, rank0, vgg_prov, data)
    finally:
        if group is not None:
            dist.destroy_process_group()


def _check_rows(cfg) -> None:
    """Refuse, before any rank starts, a frame whose row shards are not
    aligned (``parallel/spatial.py::check_config_rows``): the training
    pack's frames, or the crops."""
    from pcss_unet_tpu_torch.data.pipeline import PackedDataset
    from pcss_unet_tpu_torch.parallel.spatial import check_config_rows

    h = (cfg.crop_height if cfg.crop_height and cfg.crop_width else
         PackedDataset(cfg.processed_data_dir, "train").sample_hw[0])
    try:
        check_config_rows(cfg, h)
    except ValueError as e:
        raise SystemExit(f"pcss_unet_tpu_torch train: {e}") from None


def _train(cfg, args, device: str, group, rank0: bool, vgg_prov: str,
           data: int):
    """The run in this process: rank 0 of ``group`` (or the only process)
    writes the config, the logs and the checkpoints.  ``data``: the data
    axis the governor divides the batch by."""
    import torch.distributed as dist

    from pcss_unet_tpu_torch.data.pipeline import Loader, PackedDataset
    from pcss_unet_tpu_torch.models.init import init_train_weights
    from pcss_unet_tpu_torch.models.unet import unet_from_config
    from pcss_unet_tpu_torch.train.checkpoint import check_resume_compat
    from pcss_unet_tpu_torch.train.loop import fit
    from pcss_unet_tpu_torch.utils.prng import set_seed

    if rank0:
        setup_logger(cfg.log_dir)
    gen = set_seed(cfg.seed)
    model = init_train_weights(unet_from_config(cfg, device="cpu"), gen)
    model = model.to(device)

    train_ds = PackedDataset(cfg.processed_data_dir, "train")
    try:
        val_ds = PackedDataset(cfg.processed_data_dir, "val")
    except FileNotFoundError:
        logging.warning("no val pack found; training without validation "
                        "(best checkpoint keyed on train loss, "
                        "main.py:548-561 behavior)")
        val_ds = None

    if cfg.batch_size == 0 or cfg.grad_accum_steps == 0:
        # memory-governor prologue shared by both auto modes: parameter
        # count and the shape the step will actually train on (crops when
        # configured, else the full pack frames); the budget is the card's
        # memory (the CPU: utils/memory.py's default)
        from pcss_unet_tpu_torch.utils.memory import device_budget, param_count

        n = param_count(model)
        h, w = train_ds.sample_hw
        if cfg.crop_height and cfg.crop_width:
            h, w = cfg.crop_height, cfg.crop_width
        hbm = device_budget(device)

    if cfg.batch_size == 0:
        from pcss_unet_tpu_torch.utils.memory import find_optimal_batch_size

        cfg = cfg.replace(batch_size=min(
            find_optimal_batch_size(n, h, w, cfg.optimizer_type,
                                    hbm_bytes=hbm),
            max(1, len(train_ds))))  # no point exceeding the dataset
        logging.info("auto-selected batch_size=%d", cfg.batch_size)

    if cfg.grad_accum_steps == 0:
        # auto: smallest microbatch split whose activations fit the
        # device.  The analytic model gives a first answer; with
        # governor=xla the authority is one real step per candidate,
        # measured (train/governor.py).  The walk starts at 1: the
        # analytic model over-estimates the port's steps on a card (its
        # factor was fitted to XLA plans), so its answer bounds nothing
        # from below here.
        from pcss_unet_tpu_torch.utils.memory import (check_memory,
                                                      find_accum_steps)

        dp = data
        per_chip = max(1, cfg.batch_size // dp)
        a = find_accum_steps(n, per_chip, h, w, cfg.optimizer_type,
                             hbm_bytes=hbm)
        picked_by = "analytic"
        if cfg.governor == "xla":
            from pcss_unet_tpu_torch.data.device_cache import (cache_eligible,
                                                               dataset_nbytes)
            from pcss_unet_tpu_torch.train.governor import \
                find_accum_steps_compiled

            reserve = (dataset_nbytes(train_ds)
                       if cache_eligible(cfg, train_ds) else 0)
            a_measured = find_accum_steps_compiled(
                cfg, model, train_ds.means, train_ds.stds, per_chip, h, w,
                hbm_bytes=hbm, reserve_bytes=reserve, start=1)
            if a_measured is not None:
                a, picked_by = a_measured, "measured step"
        if a == per_chip and not check_memory(n, 1, h, w,
                                              cfg.optimizer_type,
                                              hbm_bytes=hbm):
            logging.warning("even microbatch 1 exceeds the memory estimate; "
                            "proceeding with grad_accum_steps=%d and "
                            "letting the run decide", a)
        cfg = cfg.replace(grad_accum_steps=a)
        logging.info("auto-selected grad_accum_steps=%d (per-chip "
                     "microbatch %d over dp=%d, %s)", a, per_chip // a, dp,
                     picked_by)

    if rank0:
        if cfg.resume:
            # before resolved_config.json is overwritten below: refuse to
            # auto-resume into checkpoints from a structurally different run
            check_resume_compat(cfg, cfg.save_dir)
        save_config(cfg, f"{cfg.save_dir}/resolved_config.json",
                    extra={"vgg_weights": vgg_prov})
    if group is not None:
        dist.barrier()
    shard_kw = host_shard_args(cfg.spatial_parallel) if args.multihost else {}
    if args.grain:
        from pcss_unet_tpu_torch.data.grain_pipeline import GrainLoader

        train_loader = GrainLoader(train_ds, cfg.batch_size,
                                   shuffle=cfg.shuffle, seed=cfg.seed,
                                   read_workers=args.grain_workers, **shard_kw)
    else:
        crop = ((cfg.crop_height, cfg.crop_width)
                if cfg.crop_height and cfg.crop_width else None)
        train_loader = Loader(train_ds, cfg.batch_size, shuffle=cfg.shuffle,
                              seed=cfg.seed, crop_hw=crop, **shard_kw)
    val_loader = (Loader(val_ds, cfg.batch_size, shuffle=False)
                  if val_ds is not None else None)
    result = fit(cfg, model, train_loader, val_loader,
                 profile_dir=args.profile_dir if rank0 else None, group=group)
    logging.info("training done; best val loss %.6f", result.best_val_loss)
    return result


if __name__ == "__main__":
    main()
