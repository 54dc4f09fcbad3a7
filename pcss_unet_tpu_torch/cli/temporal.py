"""Temporal-stability evaluation CLI (port of
``pcss_unet_tpu/cli/temporal.py``).

Computes the paper's temporal-instability metric (eq. 3; reference
implementation pert_loss.py:170-199 with a stubbed motion branch, completed
in ``losses/temporal.py``) over a *sequence* of G-buffer frames: run
inference on each frame in order, then measure
``mean(exp(α·|I_t − warp(I_{t−1})|) − 1)``.  Optional motion vectors come
from `.npy` files ([T-1, H, W, 2] (dy, dx) in pixels).  Every flag of the
JAX CLI, plus ``--device`` (default ``cuda``: the card, or raise where
there is none); the engines are the port's, in each posture
(``--fold_bn``, ``--quantize int8``), frame after frame."""

import argparse
import os

import numpy as np

from pcss_unet_tpu_torch.config import load_config
from pcss_unet_tpu_torch.utils.logging import setup_logger


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"frames": T, "score": instability}``."""
    p = argparse.ArgumentParser(description="Temporal instability of an "
                                            "inferred shadow sequence")
    p.add_argument("--frames_dir", required=True,
                   help="directory of sequential *.exr frames (sorted order)")
    p.add_argument("--weights", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--stats_dir", default=None)
    p.add_argument("--ema", action="store_true",
                   help="measure the EMA parameters (ema_decay > 0 runs)")
    p.add_argument("--motion_vectors", default=None,
                   help=".npy [T-1, H, W, 2] per-pixel (dy, dx)")
    p.add_argument("--alpha", type=float, default=3.0,
                   help="exponent weight (paper uses 3; reference default 5)")
    p.add_argument("--save_masks_dir", default=None)
    p.add_argument("--fold_bn", action="store_true",
                   help="fold BN and enable the fused deployment kernels "
                        "(same posture as infer --fold_bn)")
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="int8 deployment posture (requires --fold_bn)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the engine runs (cuda: the card, or raise)")
    args = p.parse_args(argv)
    setup_logger()

    import torch

    from pcss_unet_tpu_torch.data.stats import load_channel_stats
    from pcss_unet_tpu_torch.infer import InferenceEngine, load_variables
    from pcss_unet_tpu_torch.io.exr import read_exr_stack
    from pcss_unet_tpu_torch.io.png import write_mask_png
    from pcss_unet_tpu_torch.losses import measure_temporal_instability
    from pcss_unet_tpu_torch.models.unet import unet_for_variables

    cfg = load_config(args.config)
    variables = load_variables(args.weights, ema=args.ema)
    # the checkpoint is the authority on the architecture; the engine
    # builds its own forward on the device (or raises without a card)
    model = unet_for_variables(cfg, variables, device="cpu")
    means = stds = None
    if args.stats_dir:
        means, stds = load_channel_stats(args.stats_dir)
    engine = InferenceEngine(model, variables, means=means, stds=stds,
                             fold_bn=args.fold_bn, quantize=args.quantize,
                             device=args.device)

    exrs = sorted(f for f in os.listdir(args.frames_dir)
                  if f.endswith(".exr"))
    if len(exrs) < 2:
        raise SystemExit("need at least 2 frames")
    masks = []
    for fname in exrs:
        frame = read_exr_stack(os.path.join(args.frames_dir, fname))
        mask = engine(frame)
        masks.append(mask)
        if args.save_masks_dir:
            os.makedirs(args.save_masks_dir, exist_ok=True)
            write_mask_png(os.path.join(args.save_masks_dir,
                                        fname.replace(".exr", ".png")), mask)
    frames = torch.from_numpy(np.stack(masks))[:, None].to(args.device)
    mv = None
    if args.motion_vectors:
        mv = torch.from_numpy(np.load(args.motion_vectors))[:, None].to(
            args.device)
    score = float(measure_temporal_instability(frames, mv, alpha=args.alpha))
    print(f"frames: {len(exrs)}")
    print(f"temporal instability (alpha={args.alpha}): {score:.6f}")
    return {"frames": len(exrs), "score": score}


if __name__ == "__main__":
    main()
