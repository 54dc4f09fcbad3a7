"""Channel-statistics CLI (port of ``pcss_unet_tpu/cli/stats.py``; the
reference calculate_dataset_stats.py role; its ``--dataset_path`` flag name
is preserved, calculate_dataset_stats.py:111-115).  Host-only (float64
numpy), so it takes no ``--device``."""

import argparse

from pcss_unet_tpu_torch.data.stats import compute_channel_stats
from pcss_unet_tpu_torch.utils.logging import setup_logger


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"means", "stds"}`` (float64)."""
    p = argparse.ArgumentParser(description="Per-channel mean/std of a "
                                            "packed dataset")
    p.add_argument("--dataset_path", required=True,
                   help="directory containing {split}_inputs.npy")
    p.add_argument("--split", default="train")
    p.add_argument("--chunk", type=int, default=64)
    args = p.parse_args(argv)
    setup_logger()
    stats = compute_channel_stats(args.dataset_path, args.split,
                                  chunk=args.chunk)
    for i, (m, s) in enumerate(zip(stats["means"], stats["stds"])):
        print(f"channel {i}: mean {m:+.6f}  std {s:.6f}")
    return stats


if __name__ == "__main__":
    main()
