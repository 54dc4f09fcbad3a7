"""Consistency-validation CLI (port of ``pcss_unet_tpu/cli/validate.py``;
the reference validate_consistency.py role): run one checkpoint through
the training-visualization pathway and the inference pathway, write both
PNGs + a difference image, report MSE/PSNR with the reference verdict
thresholds (validate_consistency.py:186-191).  ``--device`` (default
``cuda``) picks where both pathways run."""

import argparse
import os

import numpy as np

from pcss_unet_tpu_torch.config import load_config
from pcss_unet_tpu_torch.utils.logging import setup_logger


def main(argv=None) -> dict:
    """Run the CLI; returns the comparison (mse, psnr, max_abs, verdict)."""
    p = argparse.ArgumentParser(description="Train-vs-infer output parity")
    p.add_argument("--weights", required=True)
    p.add_argument("--input", required=True, help="input .exr")
    p.add_argument("--output_dir", default="./consistency_out")
    p.add_argument("--config", default=None)
    p.add_argument("--stats_dir", default=None)
    p.add_argument("--ema", action="store_true",
                   help="validate the EMA parameters (only checkpoint "
                        "directories of ema_decay > 0 runs carry them)")
    p.add_argument("--fold_bn", action="store_true",
                   help="inference pathway in the deployment posture "
                        "(folded BN + fused kernels)")
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="inference pathway with int8 whole-block kernels "
                        "(requires --fold_bn)")
    p.add_argument("--bf16", action="store_true",
                   help="inference pathway in bf16 (the serving dtype)")
    p.add_argument("--panel", action="store_true",
                   help="also write a side-by-side comparison figure "
                        "(reference validate_consistency.py matplotlib "
                        "panel; headless Agg backend)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where both pathways run (cuda: the card, or raise)")
    args = p.parse_args(argv)
    setup_logger()

    import torch

    from pcss_unet_tpu_torch.data.stats import load_channel_stats
    from pcss_unet_tpu_torch.infer import load_variables
    from pcss_unet_tpu_torch.io.exr import read_exr_stack
    from pcss_unet_tpu_torch.io.png import write_mask_png
    from pcss_unet_tpu_torch.models.unet import unet_for_variables
    from pcss_unet_tpu_torch.parity import validate_train_infer_consistency

    cfg = load_config(args.config)
    variables = load_variables(args.weights, ema=args.ema)
    # The checkpoint, not the config, is the authority on the architecture
    # (infer.py:36-41 never asks for it).  The model stays on the host: it
    # is the architecture the engine checks, and the engine builds its own
    # forward on the device (or raises where there is no card).
    model = unet_for_variables(cfg, variables, device="cpu")
    means = stds = None
    if args.stats_dir:
        means, stds = load_channel_stats(args.stats_dir)
    frame = read_exr_stack(args.input)
    engine_kwargs = {"device": args.device}
    if args.fold_bn:
        engine_kwargs["fold_bn"] = True
    if args.quantize != "none":
        engine_kwargs["quantize"] = args.quantize
    if args.bf16:
        engine_kwargs["dtype"] = torch.bfloat16
    res = validate_train_infer_consistency(model, variables, frame,
                                           means=means, stds=stds,
                                           pad_multiple=cfg.pad_multiple,
                                           **engine_kwargs)
    os.makedirs(args.output_dir, exist_ok=True)
    write_mask_png(os.path.join(args.output_dir, "train_pathway.png"),
                   res["train_pathway"])
    write_mask_png(os.path.join(args.output_dir, "infer_pathway.png"),
                   res["infer_pathway"])
    diff = np.abs(res["train_pathway"] - res["infer_pathway"])
    write_mask_png(os.path.join(args.output_dir, "abs_diff.png"),
                   diff / max(float(diff.max()), 1e-8))
    if args.panel:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        for ax, (img, title) in zip(axes, [
                (res["train_pathway"], "training pathway"),
                (res["infer_pathway"], "inference pathway"),
                (diff, "abs diff")]):
            im = ax.imshow(np.squeeze(img), cmap="gray", vmin=0,
                           vmax=1 if title != "abs diff" else None)
            ax.set_title(title)
            ax.axis("off")
            if title == "abs diff":
                fig.colorbar(im, ax=ax, fraction=0.046)
        fig.suptitle(f"MSE {res['mse']:.3e} | PSNR {res['psnr']:.2f} dB | "
                     f"{res['verdict'].upper()}")
        fig.savefig(os.path.join(args.output_dir, "panel.png"),
                    bbox_inches="tight", dpi=110)
        plt.close(fig)
    print(f"MSE  = {res['mse']:.3e}")
    print(f"PSNR = {res['psnr']:.2f} dB")
    print(f"verdict: {res['verdict'].upper()}")
    return {k: res[k] for k in ("mse", "psnr", "max_abs", "verdict")}


if __name__ == "__main__":
    main()
