"""Scene split CLI (port of ``pcss_unet_tpu/cli/organize.py``; the
reference organize_data.py role).  Host-only (numpy and file copies), so
it takes no ``--device``."""

import argparse

from pcss_unet_tpu_torch.data.organize import (organize_dataset,
                                               replace_exr_files)
from pcss_unet_tpu_torch.utils.logging import setup_logger


def main(argv=None) -> dict:
    """Run the CLI; returns the per-split counts (``{"replaced": n}`` with
    ``--replace_exr_from``)."""
    p = argparse.ArgumentParser(description="Split scene renders into "
                                            "train/val pair directories")
    p.add_argument("--scene_dir", required=True,
                   help="directory containing conditioning_images/ and images/")
    p.add_argument("--out_dir", default="./data")
    p.add_argument("--train_fraction", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--exr_subdir", default="conditioning_images")
    p.add_argument("--png_subdir", default="images")
    p.add_argument("--replace_exr_from", default=None,
                   help="instead of splitting: replace *_input.exr in "
                        "--out_dir (a split dir) from this directory")
    args = p.parse_args(argv)
    setup_logger()
    if args.replace_exr_from:
        n = replace_exr_files(args.out_dir, args.replace_exr_from)
        print(f"replaced {n} EXR files in {args.out_dir}")
        return {"replaced": n}
    counts = organize_dataset(args.scene_dir, args.out_dir,
                              args.train_fraction, args.seed,
                              args.exr_subdir, args.png_subdir)
    print(f"train: {counts['train']}  val: {counts['val']}")
    return counts


if __name__ == "__main__":
    main()
