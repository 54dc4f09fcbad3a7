"""Dataset QA CLI (port of ``pcss_unet_tpu/cli/check.py``) — the
diagnostics layer (SURVEY.md §1 L6: check.py, check_channel_stats.py,
test.py rolled into subcommands).  Host-only, so it takes no ``--device``.

    check channels  — every *_input.exr has the 4-channel contract (test.py:18-36)
    check split     — every channel of one EXR → normalized grayscale PNGs
                      (test.py:38-86)
    check pair      — channel stats of one EXR/PNG pair (check.py:48-91)
    check packs     — per-sample per-channel stats report of packed arrays
                      (check_channel_stats.py:24-130)

The port does not use Pillow: ``split`` writes its PNGs with
``io/png.py::encode_png`` and ``pair --compare_decodes`` decodes RGB with
``io/png.py::decode_png_rgb``.  ``pair --figure`` and ``packs --histogram``
need matplotlib, imported when asked for; without it they exit with a
message that names it.
"""

import argparse
import json
import os

import numpy as np

from pcss_unet_tpu_torch.utils.logging import setup_logger


def _pyplot(flag: str):
    """matplotlib's pyplot on the headless Agg backend, or exit naming the
    missing package."""
    try:
        import matplotlib
    except ImportError:
        raise SystemExit(f"{flag} needs matplotlib, which is not installed "
                         "(pip install matplotlib)") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def cmd_channels(args) -> int:
    from pcss_unet_tpu_torch.io.exr import read_exr_channels

    bad = 0
    total = 0
    for root in args.dirs:
        for fname in sorted(os.listdir(root)):
            if not fname.endswith("_input.exr"):
                continue
            total += 1
            path = os.path.join(root, fname)
            try:
                chans = read_exr_channels(path, ["R", "G", "B", "A"])
                missing = [n for n in "RGB" if chans[n] is None]
                if missing:
                    print(f"FAIL {path}: missing {missing}")
                    bad += 1
                elif chans["A"] is None:
                    print(f"WARN {path}: no alpha (default-ones will be used)")
            except Exception as e:  # noqa: BLE001 - report-and-continue QA tool
                print(f"FAIL {path}: {e}")
                bad += 1
    print(f"{total - bad}/{total} files satisfy the 4-channel contract")
    return 1 if bad else 0


def cmd_pair(args) -> int:
    from pcss_unet_tpu_torch.io.exr import read_exr
    from pcss_unet_tpu_torch.io.png import decode_png_rgb, read_label_png

    planes = read_exr(args.exr)
    for name, arr in zip("RGBA", planes):
        print(f"channel {name}: shape {arr.shape} min {arr.min():+.5f} "
              f"max {arr.max():+.5f} mean {arr.mean():+.5f} std {arr.std():.5f}")
    if args.png:
        label = read_label_png(args.png)
        print(f"label   : shape {label.shape} min {label.min():.5f} "
              f"max {label.max():.5f} mean {label.mean():.5f} "
              f"median {np.median(label):.5f}")
        if args.compare_decodes:
            # grayscale-convert vs RGB-mean label decoding A/B
            # (reference check.py:149-204)
            with open(args.png, "rb") as f:
                rgb = decode_png_rgb(f.read()).astype(np.float32) / 255.0
            rgb_mean = rgb.mean(axis=-1)
            diff = np.abs(label - rgb_mean)
            print(f"decode A/B: convert('L') vs RGB-mean — max diff "
                  f"{diff.max():.6f}, mean diff {diff.mean():.6f} "
                  f"({'identical' if diff.max() < 1e-6 else 'differs: L uses ITU-R 601 weights'})")
    if args.figure:
        # headless montage of every channel (+ label): the capability of the
        # reference's interactive viewer (check.py:93-147) as a writable
        # artifact — works over SSH/CI where a display is unavailable
        plt = _pyplot("--figure")

        panels = [(arr, f"input {name}") for name, arr in zip("RGBA", planes)]
        if args.png:
            panels.append((label, "label"))
        fig, axes = plt.subplots(1, len(panels), figsize=(4 * len(panels), 4))
        for ax, (img, title) in zip(np.atleast_1d(axes), panels):
            lo, hi = float(np.nanmin(img)), float(np.nanmax(img))
            im = ax.imshow(img, cmap="gray", vmin=lo, vmax=max(hi, lo + 1e-8))
            ax.set_title(f"{title}\n[{lo:.3f}, {hi:.3f}]")
            ax.axis("off")
            fig.colorbar(im, ax=ax, fraction=0.046)
        fig.tight_layout()
        fig.savefig(args.figure, dpi=100)
        print(f"wrote channel montage to {args.figure}")
    return 0


def cmd_split(args) -> int:
    """Split every channel of an EXR into min-max-normalized 8-bit grayscale
    PNGs (reference test.py:38-86 ``split_exr_channels`` — its interactive
    cv2.imshow step is replaced by the written artifacts)."""
    from pcss_unet_tpu_torch.io.exr import (list_exr_channels,
                                            read_exr_channels)
    from pcss_unet_tpu_torch.io.png import encode_png

    names = list_exr_channels(args.exr)
    chans = read_exr_channels(args.exr, names)
    os.makedirs(args.out_dir, exist_ok=True)
    for name in names:
        arr = chans[name]
        lo, hi = float(np.nanmin(arr)), float(np.nanmax(arr))
        # reference test.py:66-72: constant channels map to zeros
        norm = np.zeros_like(arr) if hi == lo else (arr - lo) / (hi - lo)
        u8 = (np.nan_to_num(norm, nan=0.0) * 255).astype(np.uint8)
        safe = name.replace("/", "_").replace(".", "_")  # layered names
        out = os.path.join(args.out_dir, f"{safe}.png")
        with open(out, "wb") as f:
            f.write(encode_png(u8, "L"))
        print(f"wrote {out}  range [{lo:.5f}, {hi:.5f}]")
    return 0


def cmd_packs(args) -> int:
    path = os.path.join(args.dataset_path, f"{args.split}_inputs.npy")
    data = np.load(path, mmap_mode="r")
    ch_axis = 1 if data.shape[1] <= 8 < data.shape[3] else 3
    n = data.shape[0]
    rows = []
    for i in range(min(n, args.max_samples)):
        sample = np.asarray(data[i], np.float64)
        axes = tuple(a for a in range(3) if a != (ch_axis - 1))
        rows.append({
            "sample": i,
            "min": sample.min(axis=axes).tolist(),
            "max": sample.max(axis=axes).tolist(),
            "mean": sample.mean(axis=axes).tolist(),
            "std": sample.std(axis=axes).tolist(),
        })
        print(f"sample {i}: mean {np.round(rows[-1]['mean'], 4)} "
              f"std {np.round(rows[-1]['std'], 4)}")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"wrote report to {args.report}")
    if args.histogram:
        # per-channel value distributions (check_channel_stats.py:132-149)
        plt = _pyplot("--histogram")

        n_ch = data.shape[ch_axis]
        fig, axes = plt.subplots(1, n_ch, figsize=(4 * n_ch, 3))
        sample = np.asarray(data[: min(n, 16)], np.float32)
        for c in range(n_ch):
            vals = (sample[:, c] if ch_axis == 1 else sample[..., c]).ravel()
            axes[c].hist(vals, bins=64)
            axes[c].set_title(f"channel {c}")
        fig.tight_layout()
        fig.savefig(args.histogram, dpi=100)
        print(f"wrote histograms to {args.histogram}")
    return 0


def main(argv=None) -> None:
    setup_logger()
    p = argparse.ArgumentParser(description="Dataset QA diagnostics")
    sub = p.add_subparsers(dest="cmd", required=True)
    c1 = sub.add_parser("channels", help="verify EXR 4-channel contract")
    c1.add_argument("dirs", nargs="+")
    c2 = sub.add_parser("pair", help="channel stats of one EXR/PNG pair")
    c2.add_argument("--exr", required=True)
    c2.add_argument("--png", default=None)
    c2.add_argument("--compare_decodes", action="store_true",
                    help="A/B label decode methods (check.py:149-204)")
    c2.add_argument("--figure", default=None,
                    help="write a per-channel montage PNG here (headless "
                         "equivalent of the reference interactive viewer, "
                         "check.py:93-147)")
    c4 = sub.add_parser("split", help="split every EXR channel into "
                                      "normalized grayscale PNGs "
                                      "(test.py:38-86)")
    c4.add_argument("--exr", required=True)
    c4.add_argument("--out_dir", default=".")
    c3 = sub.add_parser("packs", help="per-sample stats of packed arrays")
    c3.add_argument("--dataset_path", required=True)
    c3.add_argument("--split", default="train")
    c3.add_argument("--max_samples", type=int, default=16)
    c3.add_argument("--report", default=None)
    c3.add_argument("--histogram", default=None,
                    help="write per-channel histogram PNG here "
                         "(check_channel_stats.py:132-149)")
    args = p.parse_args(argv)
    raise SystemExit({"channels": cmd_channels, "pair": cmd_pair,
                      "packs": cmd_packs, "split": cmd_split}[args.cmd](args))


if __name__ == "__main__":
    main()
