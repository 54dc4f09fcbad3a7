"""Multiply-adds of the work a cell does, from its configuration's shapes
alone (whatever the program implements them with): the ``mfu`` metrics'
numerators.  Convolutions only; the align-corners resizes are two taps an
output and are left out."""

from __future__ import annotations

from benchmark.inputs import unet_layout

# VGG-19 ``features`` up to the perceptual loss's last tap (conv5_2,
# torchvision index 30): (index, cin, cout, pools before it)
VGG_TO_30 = ((0, 3, 64, 0), (2, 64, 64, 0), (5, 64, 128, 1), (7, 128, 128, 1),
             (10, 128, 256, 2), (12, 256, 256, 2), (14, 256, 256, 2),
             (16, 256, 256, 2), (19, 256, 512, 3), (21, 512, 512, 3),
             (23, 512, 512, 3), (25, 512, 512, 3), (28, 512, 512, 4),
             (30, 512, 512, 4))


def unet_macs(widths, h: int, w: int, in_ch: int = 4, out_ch: int = 1) -> int:
    """One forward of the U-Net on one h x w frame: each ConvBlock's 3x3
    (cin -> cin) and 1x1 (cin -> cout) at its level's resolution, and the
    head's 1x1."""
    blocks, (hc, ho) = unet_layout(widths, in_ch, out_ch)
    depth = len(widths)
    total = 0
    for name, cin, cout in blocks:
        kind, idx = name.split("_")
        level = (int(idx) if kind == "enc" else
                 0 if idx == "final" else depth - 2 - int(idx))
        px = (h // 2 >> level) * (w // 2 >> level)
        total += px * (9 * cin * cin + cin * cout)
    return total + (h // 2) * (w // 2) * hc * ho


def vgg_macs(h: int, w: int) -> int:
    """The perceptual loss's VGG-19 tower on one h x w image, to conv5_2."""
    return sum((h >> p) * (w >> p) * 9 * cin * cout for _, cin, cout, p in VGG_TO_30)
