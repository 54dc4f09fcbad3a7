"""Batch-serving CLI (port of ``pcss_unet_tpu/cli/serve.py``): stream a
directory of G-buffer EXR frames through the pipeline server
(``infer/server.py``) and write uint8 mask PNGs.

    python -m pcss_unet_tpu_torch serve --frames_dir renders/ --out_dir masks/ \\
        --weights model.npz --stats_dir ./data/processed --batch 4

Every flag of the reference; ``--device`` (default ``cuda``) picks where the
engine runs, and without a card ``cuda`` raises rather than running on the
CPU.  The PNGs hold the served codes as they come (K4 rounds half to even,
as the reference's serving path does), written by the port's encoder.
"""

import argparse
import os
import time

from pcss_unet_tpu_torch.config import load_config
from pcss_unet_tpu_torch.utils.logging import setup_logger


def main(argv=None) -> dict:
    """Run the CLI; returns the server's stats (``stats``) and the host
    seconds the sink spent encoding and writing PNGs (``write_seconds``)."""
    p = argparse.ArgumentParser(description="Streaming batch inference")
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--config", default=None)
    p.add_argument("--stats_dir", default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--ema", action="store_true",
                   help="deploy the EMA parameters (only checkpoint "
                        "directories of ema_decay > 0 runs carry them)")
    p.add_argument("--decode_workers", type=int, default=4)
    p.add_argument("--fold_bn", action="store_true", default=True)
    p.add_argument("--no_fold_bn", dest="fold_bn", action="store_false")
    p.add_argument("--quantize", choices=["none", "int8"], default="none",
                   help="int8: dynamic-int8 whole-block kernels for the "
                        "wide stages (requires fold_bn)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the engine runs (cuda: the card, or raise)")
    args = p.parse_args(argv)
    setup_logger()

    import torch

    from pcss_unet_tpu_torch.data.stats import load_channel_stats
    from pcss_unet_tpu_torch.infer import InferenceEngine, load_variables
    from pcss_unet_tpu_torch.infer.server import ShadowServer
    from pcss_unet_tpu_torch.io.png import encode_png
    from pcss_unet_tpu_torch.models.unet import unet_for_variables

    cfg = load_config(args.config)
    variables = load_variables(args.weights, ema=args.ema)
    # the architecture the engine checks; it builds its own forward
    model = unet_for_variables(cfg, variables, device="cpu")
    means = stds = None
    if args.stats_dir:
        means, stds = load_channel_stats(args.stats_dir)
    engine = InferenceEngine(model, variables, means=means, stds=stds,
                             dtype=torch.bfloat16, fold_bn=args.fold_bn,
                             quantize=args.quantize, device=args.device)
    server = ShadowServer(engine, batch_size=args.batch,
                          decode_workers=args.decode_workers)

    paths = [os.path.join(args.frames_dir, f)
             for f in sorted(os.listdir(args.frames_dir))
             if f.endswith(".exr")]
    os.makedirs(args.out_dir, exist_ok=True)
    written = [0.0]

    def sink(path: str, mask_u8) -> None:
        t0 = time.perf_counter()
        name = os.path.splitext(os.path.basename(path))[0] + ".png"
        with open(os.path.join(args.out_dir, name), "wb") as f:
            f.write(encode_png(mask_u8[..., 0], "L"))
        written[0] += time.perf_counter() - t0

    stats = server.run(paths, sink)
    print(f"{stats.frames} frames, {stats.wall_seconds:.2f}s, "
          f"{stats.fps:.1f} fps")
    return {"stats": stats, "write_seconds": written[0]}


if __name__ == "__main__":
    main()
