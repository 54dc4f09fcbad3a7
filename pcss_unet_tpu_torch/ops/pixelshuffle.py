"""Space↔depth shuffles in NHWC with torch channel ordering (port of
``pcss_unet_tpu/ops/pixelshuffle.py``).

Output channel ``c·r² + dy·r + dx`` for input channel ``c`` and intra-block
offset ``(dy, dx)``, as ``F.pixel_unshuffle`` emits it.  The reference's
``_mxu`` twins are one-hot matrix products that are bit-equal to these
reshapes, so the port has only the reshape form.  The channels-major
engine's entry (``pixel_unshuffle_chw_padded``) lives here too, beside its
NHWC twin, so that K1's plain version can build either layout.
"""

from __future__ import annotations

import torch


def pixel_unshuffle_nhwc(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """[N, H, W, C] → [N, H/r, W/r, C·r²], channel order c·r²+dy·r+dx."""
    n, h, w, c = x.shape
    if h % r or w % r:
        raise ValueError(f"pixel_unshuffle: spatial dims {(h, w)} not divisible by r={r}")
    x = x.reshape(n, h // r, r, w // r, r, c)       # [N, H', dy, W', dx, C]
    x = x.permute(0, 1, 3, 5, 2, 4)                 # [N, H', W', C, dy, dx]
    return x.reshape(n, h // r, w // r, c * r * r)


def padded_width(w: int) -> int:
    """Lane-padded width of the channels-major layout: the next multiple
    of 128 with at least one zero pad column."""
    return (w // 128 + 1) * 128


def pixel_unshuffle_chw_padded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[N, H, W, C] → pixel-unshuffled, channels-major, padded
    [N, C·4, H/2, padded_width(W/2)] in ``dtype`` (channel order
    c·4+dy·2+dx, zero pad columns): the channels-major engine's entry."""
    n, h, w, c = x.shape
    x = x.to(dtype).reshape(n, h // 2, 2, w // 2, 2, c)   # [N,H',dy,W',dx,C]
    x = x.permute(0, 5, 2, 4, 1, 3).reshape(n, c * 4, h // 2, w // 2)
    return torch.nn.functional.pad(x, (0, padded_width(w // 2) - w // 2))


def pixel_shuffle_nhwc(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """[N, H, W, C·r²] → [N, H·r, W·r, C], inverse of
    :func:`pixel_unshuffle_nhwc`."""
    n, h, w, crr = x.shape
    if crr % (r * r):
        raise ValueError(f"pixel_shuffle: channels {crr} not divisible by r²={r*r}")
    c = crr // (r * r)
    x = x.reshape(n, h, w, c, r, r)                 # [..., C, dy, dx]
    x = x.permute(0, 1, 4, 2, 5, 3)                 # [N, H, dy, W, dx, C]
    return x.reshape(n, h * r, w * r, c)
