"""Inference CLI (port of ``pcss_unet_tpu/cli/infer.py``; the reference's
infer.py + inference.py roles).

Reference flags preserved: ``--input x.exr --output y.png --weights ckpt``
(infer.py:13-18).  Accepts ``.npz`` exports, reference ``.pth`` files
(both formats, infer.py:36-41) and this package's ``train --save_dir``
(its best checkpoint); Orbax directories are refused with the converter's
name.  ``--save_format`` L/RGB/RGBA mirrors
inference.py:111-128; ``--tile``/``--halo`` engage the halo-tiled path;
``--stats_dir`` applies train-set standardization like the training
pipeline.  ``--device`` (default ``cuda``) picks where the engine runs;
without a card ``cuda`` raises rather than running on the CPU.

The mask is written as ``(mask·255).astype(uint8)`` on the host, truncated
as the reference writes it, so the CLI does not use the engine's
``render_u8`` (K4 rounds half to even)."""

import argparse
import time

from pcss_unet_tpu_torch.config import load_config
from pcss_unet_tpu_torch.io.exr import read_exr_stack
from pcss_unet_tpu_torch.io.png import write_mask_png
from pcss_unet_tpu_torch.utils.logging import setup_logger


def main(argv=None) -> dict:
    """Run the CLI; returns the host-clock times of the decode, the forward
    and the PNG write (ms), the EXR codec that decoded and the frame's
    shape."""
    p = argparse.ArgumentParser(description="Shadow-mask inference on a "
                                            "G-buffer EXR stack")
    p.add_argument("--input", required=True, help="input .exr")
    p.add_argument("--output", required=True, help="output .png")
    p.add_argument("--weights", required=True,
                   help=".npz export | reference .pth | train --save_dir")
    p.add_argument("--config", default=None)
    p.add_argument("--stats_dir", default=None,
                   help="directory with train_stats.npy for standardization")
    p.add_argument("--save_format", choices=["L", "RGB", "RGBA"], default="L")
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--tile", type=int, default=0,
                   help=">0 → halo-tiled inference with this tile size")
    p.add_argument("--halo", type=int, default=32)
    p.add_argument("--fold_bn", action="store_true",
                   help="deployment posture: fold BatchNorm into the convs "
                        "(exact at eval) and route the blocks through the "
                        "fused kernels")
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="int8: dynamic-int8 whole-block kernels for the "
                        "wide stages (requires --fold_bn)")
    p.add_argument("--layout", choices=["nhwc", "chw"], default="nhwc",
                   help="chw: channels-major end-to-end forward (requires "
                        "--fold_bn)")
    p.add_argument("--ema", action="store_true",
                   help="deploy the EMA parameters (only checkpoint "
                        "directories of ema_decay > 0 runs carry them)")
    p.add_argument("--decode_threads", type=int, default=0,
                   help="EXR chunk-decode threads (0 = hardware count)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the engine runs (cuda: the card, or raise)")
    args = p.parse_args(argv)
    setup_logger()

    import torch

    from pcss_unet_tpu_torch.data.stats import load_channel_stats
    from pcss_unet_tpu_torch.infer import (InferenceEngine, infer_tiled,
                                           load_variables)
    from pcss_unet_tpu_torch.io.exr import last_backend, set_decode_threads
    from pcss_unet_tpu_torch.models.unet import unet_for_variables

    set_decode_threads(args.decode_threads)
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
    engine = InferenceEngine(model, variables, means=means, stds=stds,
                             dtype=getattr(torch, args.dtype),
                             pad_multiple=cfg.pad_multiple,
                             fold_bn=args.fold_bn, quantize=args.quantize,
                             layout=args.layout, device=args.device)

    t0 = time.perf_counter()
    frame = read_exr_stack(args.input)
    t1 = time.perf_counter()
    if args.tile > 0:
        mask = infer_tiled(engine, frame, tile=args.tile, halo=args.halo)
    else:
        mask = engine(frame)
    t2 = time.perf_counter()
    write_mask_png(args.output, mask, mode=args.save_format)
    t3 = time.perf_counter()
    times = {"decode_ms": (t1 - t0) * 1e3, "forward_ms": (t2 - t1) * 1e3,
             "write_ms": (t3 - t2) * 1e3, "exr_backend": last_backend(),
             "shape": list(frame.shape)}
    print(f"wrote {args.output}  ({frame.shape[1]}x{frame.shape[0]}, "
          f"decode {times['decode_ms']:.1f} ms ({times['exr_backend']}), "
          f"forward {times['forward_ms']:.1f} ms, "
          f"write {times['write_ms']:.1f} ms)")
    return times


if __name__ == "__main__":
    main()
