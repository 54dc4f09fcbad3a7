"""Training CLI (port of ``pcss_unet_tpu/cli/train.py``; the reference's
main.py role).

    python -m pcss_unet_tpu_torch train --config config.ini \\
        --processed_data_dir D --save_dir C [--allow_random_vgg] [...]

Every flag of the JAX CLI, plus ``--device`` (default ``cuda``: the card,
or raise where there is none; ``cpu`` for the tests).  Reference flags:
``--loss_type {standard,perturb}``, ``--perturb_weight`` (main.py:870-873),
config via INI (main.py:875-885).  ``--batch_size 0`` engages the memory
governor's doubling search (main.py:766-780 role — and unlike the
reference, the result is used); ``--grad_accum_steps 0`` picks the
smallest accumulation split that fits, with the measured probe
(``train/governor.py``) when ``governor = xla``.  ``--grain`` takes the
port's ``data/grain_pipeline.py::GrainLoader``.  What this package cannot
do yet exits 2 with a message that names the JAX package and the ROADMAP
item: ``--multihost`` and ``data_parallel`` or ``spatial_parallel`` above 1
(Queue 1 items 13–14; ``data_parallel = -1`` is one card here)."""

import argparse
import logging
import sys

from pcss_unet_tpu_torch.config import load_config, save_config
from pcss_unet_tpu_torch.utils.logging import setup_logger


def _not_ported(what: str, item: str) -> None:
    print(f"pcss_unet_tpu_torch train: {what} is not ported yet ({item}); "
          "run it with python -m pcss_unet_tpu train", file=sys.stderr)
    raise SystemExit(2)


def main(argv=None):
    """Run the CLI; returns ``fit``'s ``FitResult``."""
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
                   help="multi-host training (not ported yet)")
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
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where training runs (cuda: the card, or raise)")
    args = p.parse_args(argv)

    if args.multihost:
        _not_ported("--multihost", "ROADMAP Queue 1 item 13")
    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("config", "no_shuffle", "no_resume",
                              "profile_dir", "multihost", "grain",
                              "grain_workers", "allow_random_vgg", "device")
                 and v is not None}
    cfg = load_config(args.config, overrides)
    if cfg.data_parallel > 1 or cfg.spatial_parallel > 1:
        _not_ported(f"data_parallel={cfg.data_parallel}, spatial_parallel="
                    f"{cfg.spatial_parallel}", "ROADMAP Queue 1 items 13-14")

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

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: training runs on the card "
                           "(pass --device cpu to run on the CPU)")
    from pcss_unet_tpu_torch.data.pipeline import Loader, PackedDataset
    from pcss_unet_tpu_torch.models.init import init_train_weights
    from pcss_unet_tpu_torch.models.unet import unet_from_config
    from pcss_unet_tpu_torch.train.checkpoint import check_resume_compat
    from pcss_unet_tpu_torch.train.loop import fit
    from pcss_unet_tpu_torch.utils.prng import set_seed

    setup_logger(cfg.log_dir)
    gen = set_seed(cfg.seed)
    model = init_train_weights(unet_from_config(cfg, device="cpu"), gen)
    model = model.to(args.device)

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
        hbm = device_budget(args.device)

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

        dp = cfg.data_parallel if cfg.data_parallel > 0 else 1
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

    if cfg.resume:
        # before resolved_config.json is overwritten below: refuse to
        # auto-resume into checkpoints from a structurally different run
        check_resume_compat(cfg, cfg.save_dir)
    save_config(cfg, f"{cfg.save_dir}/resolved_config.json",
                extra={"vgg_weights": vgg_prov})
    if args.grain:
        from pcss_unet_tpu_torch.data.grain_pipeline import GrainLoader

        train_loader = GrainLoader(train_ds, cfg.batch_size,
                                   shuffle=cfg.shuffle, seed=cfg.seed,
                                   read_workers=args.grain_workers)
    else:
        crop = ((cfg.crop_height, cfg.crop_width)
                if cfg.crop_height and cfg.crop_width else None)
        train_loader = Loader(train_ds, cfg.batch_size, shuffle=cfg.shuffle,
                              seed=cfg.seed, crop_hw=crop)
    val_loader = (Loader(val_ds, cfg.batch_size, shuffle=False)
                  if val_ds is not None else None)
    result = fit(cfg, model, train_loader, val_loader,
                 profile_dir=args.profile_dir)
    logging.info("training done; best val loss %.6f", result.best_val_loss)
    return result


if __name__ == "__main__":
    main()
