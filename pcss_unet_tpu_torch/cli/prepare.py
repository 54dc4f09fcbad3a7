"""Pack-building CLI (port of ``pcss_unet_tpu/cli/prepare.py``; the
reference prepare_dataset.py role).  Host-only (the EXR/PNG decode and
numpy memmaps), so it takes no ``--device``."""

import argparse

from pcss_unet_tpu_torch.config import load_config
from pcss_unet_tpu_torch.data.records import build_packs, export_per_file
from pcss_unet_tpu_torch.utils.logging import setup_logger


def main(argv=None) -> dict:
    """Run the CLI; returns each split's pack meta."""
    p = argparse.ArgumentParser(description="Pack EXR/PNG pairs into "
                                            "mmap-able .npy arrays")
    p.add_argument("--config", default=None, help="config.ini for paths")
    p.add_argument("--train_dir", default=None)
    p.add_argument("--val_dir", default=None)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--layout", choices=["nhwc", "nchw"], default="nhwc",
                   help="nchw writes reference-compatible packs")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--per_file", action="store_true",
                   help="also export one .npz per pair (the reference's "
                        "orphan preprocess.py capability)")
    p.add_argument("--per_file_normalize", choices=["none", "minmax"],
                   default="none")
    args = p.parse_args(argv)
    setup_logger()
    cfg = load_config(args.config)
    train_dir = args.train_dir or cfg.train_dir
    val_dir = args.val_dir or cfg.val_dir
    out_dir = args.out_dir or cfg.processed_data_dir
    metas = {}
    for split, root in (("train", train_dir), ("val", val_dir)):
        meta = metas[split] = build_packs(root, out_dir, split,
                                          layout=args.layout,
                                          num_workers=args.num_workers)
        print(f"{split}: {meta['count']} samples "
              f"{meta['height']}x{meta['width']} ({meta['layout']})")
        if args.per_file:
            n = export_per_file(root, f"{out_dir}/{split}_files",
                                normalize=args.per_file_normalize,
                                num_workers=args.num_workers)
            print(f"{split}: exported {n} per-file .npz artifacts")
    return metas


if __name__ == "__main__":
    main()
