"""Model inspection CLI (port of ``pcss_unet_tpu/cli/inspect.py``): the
reference's debug dump (inference.py:285-297 model-info print), the graph
rendering of visualize.py, and the paper's per-layer timing analysis
(paper.md:139-147), all runnable:

    python -m pcss_unet_tpu_torch inspect --config config.ini \
        [--hlo graph.txt] [--dot graph.dot] [--latency] [--memory] \
        [--device cpu]

The graphs are ``torch.export`` graphs of the plain eval model (the port
has no HLO).  ``--device`` (default ``cuda``) picks where the model runs.
"""

import argparse

from pcss_unet_tpu_torch.config import load_config
from pcss_unet_tpu_torch.utils.logging import setup_logger


def main(argv=None) -> list | None:
    """Run the CLI; returns the ``--latency`` rows (None without it)."""
    p = argparse.ArgumentParser(description="Inspect the configured model")
    p.add_argument("--config", default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--hlo", default=None,
                   help="write the torch.export graph of the plain eval "
                        "model here (the port has no HLO)")
    p.add_argument("--dot", default=None,
                   help="write the exported graph as DOT here")
    p.add_argument("--latency", action="store_true",
                   help="per-block latency report")
    p.add_argument("--memory", action="store_true",
                   help="device-memory estimate for training at the config's "
                        "batch size")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the model runs (cuda: the card, or raise)")
    args = p.parse_args(argv)
    setup_logger()

    import torch

    from pcss_unet_tpu_torch.models.init import init_train_weights
    from pcss_unet_tpu_torch.models.unet import unet_from_config
    from pcss_unet_tpu_torch.utils.memory import (estimate_memory_usage,
                                                  param_count)
    from pcss_unet_tpu_torch.utils.profiling import layer_latency_report
    from pcss_unet_tpu_torch.utils.visualize import graph_dot, graph_text

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: inspect runs on the card unless "
                           "--device cpu is passed")
    cfg = load_config(args.config)
    h = args.height or cfg.image_height
    w = args.width or cfg.image_width
    model = init_train_weights(unet_from_config(cfg, device=args.device),
                               torch.Generator().manual_seed(0))
    n = param_count(model)
    print(f"model: depth={cfg.model_depth} widths={model.encoder_widths}")
    print(f"parameters: {n:,} ({n * 4 / 2**20:.1f} MB fp32, "
          f"{n * 2 / 2**20:.1f} MB bf16)")
    print(f"configured frame: {w}x{h}  compute dtype: {cfg.compute_dtype}")

    if args.memory:
        est = estimate_memory_usage(n, cfg.batch_size, h, w,
                                    optimizer=cfg.optimizer_type)
        for k, v in est.items():
            print(f"  HBM {k}: {v / 2**30:.2f} GiB")

    frame = torch.zeros((1, h - h % 16, w - w % 16, cfg.input_channels),
                        dtype=torch.float32, device=args.device)
    if args.hlo:
        with open(args.hlo, "w") as f:
            f.write(graph_text(model, frame))
        print(f"wrote the torch.export graph to {args.hlo}")
    if args.dot:
        with open(args.dot, "w") as f:
            f.write(graph_dot(model, frame))
        print(f"wrote the exported graph's DOT to {args.dot}")
    if not args.latency:
        return None
    report = layer_latency_report(model, None, tuple(frame.shape))
    for row in report:
        extra = f"  flops={row['flops']:.3g}" if row.get("flops") else ""
        print(f"  {row['stage']:<12} {row['seconds'] * 1e3:8.2f} ms{extra}")
    print(f"  float32 convolutions on TF32: {'yes' if report[-1]['tf32'] else 'no'}")
    return report


if __name__ == "__main__":
    main()
