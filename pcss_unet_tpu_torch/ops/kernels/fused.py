"""K1 ``fused_scrub_standardize`` and K4 ``fused_mask_to_u8``: the passes
that bracket every inference call (port of
``pcss_unet_tpu/ops/pallas/fused.py``; CUDA in ``csrc/fused.cu``).

K1 can also write the forward's first input in one pass (``entry``): the
NHWC posture's pixel-unshuffled frame, or the channels-major engine's
padded planes.  Each wrapper runs its CUDA kernel on a CUDA tensor and its
plain PyTorch version on a CPU tensor, and counts its kernel launches in
``.launches``.
"""

from __future__ import annotations

import torch

from pcss_unet_tpu_torch.ops.kernels import _build
from pcss_unet_tpu_torch.ops.pixelshuffle import (padded_width,
                                                  pixel_unshuffle_chw_padded,
                                                  pixel_unshuffle_nhwc)

ENTRIES = (None, "nhwc", "chw")
# how the card kernel reads and stores (csrc/fused.cu): element by element,
# C = 4 with each unit's values contiguous, C = 4 into the chw planes
GENERAL, UNIT, PLANES = 0, 1, 2


def entry_shape(shape, entry: str | None) -> tuple[int, ...]:
    """K1's output shape for a frame of ``shape`` [N, H, W, C]."""
    n, h, w, c = shape
    if entry is None:
        return (n, h, w, c)
    if entry == "nhwc":
        return (n, h // 2, w // 2, 4 * c)
    return (n, 4 * c, h // 2, padded_width(w // 2))


def _check(x, means, stds, entry) -> None:
    if x.dim() != 4 or means.shape != (x.shape[-1],) or stds.shape != means.shape:
        raise ValueError(f"need x [N,H,W,C] and means/stds [C]; got "
                         f"{tuple(x.shape)}, {tuple(means.shape)}, {tuple(stds.shape)}")
    if entry not in ENTRIES:
        raise ValueError(f"entry must be one of {ENTRIES}, got {entry!r}")
    if entry is not None and (x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError(f"entry={entry!r} needs H, W even; got {tuple(x.shape)}")


def scrub_standardize_plain(x: torch.Tensor, means: torch.Tensor,
                            stds: torch.Tensor,
                            out_dtype: torch.dtype = torch.bfloat16, *,
                            entry: str | None = None) -> torch.Tensor:
    """NaN→0, +Inf→1, −Inf→0, then ``(x − mean) · inv_std`` with
    ``inv_std = 1/(std + 1e-8)`` in float32 (a multiply, as the kernel),
    rounded once to ``out_dtype``, then laid out as ``entry`` says."""
    _check(x, means, stds, entry)
    x = torch.nan_to_num(x.float(), nan=0.0, posinf=1.0, neginf=0.0)
    inv_std = 1.0 / (stds.float() + 1e-8)
    y = ((x - means.float()) * inv_std).to(out_dtype)
    if entry == "nhwc":
        return pixel_unshuffle_nhwc(y, 2)
    if entry == "chw":
        return pixel_unshuffle_chw_padded(y, out_dtype)
    return y


def fused_scrub_standardize(x: torch.Tensor, means: torch.Tensor,
                            stds: torch.Tensor,
                            out_dtype: torch.dtype = torch.bfloat16, *,
                            entry: str | None = None) -> torch.Tensor:
    """x [N, H, W, C] float32 → scrubbed, standardized, in ``out_dtype``
    (float32 or bfloat16), laid out as ``entry`` says:

    - ``None``: [N, H, W, C], the reference's contract;
    - ``"nhwc"``: ``pixel_unshuffle_nhwc(·, 2)``, [N, H/2, W/2, 4C], the
      NHWC posture's first input (``UNet.forward_entered``);
    - ``"chw"``: ``pixel_unshuffle_chw_padded``, [N, 4C, H/2, Wp] with
      zero pad columns, the channels-major engine's first input
      (``chw_forward_entered``).

    Every layout is bit for bit its plain version."""
    _check(x, means, stds, entry)
    if x.device.type == "cpu":
        return scrub_standardize_plain(x, means, stds, out_dtype, entry=entry)
    if x.dtype != torch.float32 or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 in, float32/bfloat16 out; got "
                         f"{x.dtype} → {out_dtype}")
    _build.check_device(x, means, stds)
    out = torch.empty(entry_shape(x.shape, entry), dtype=out_dtype, device=x.device)
    _build.check_extent(x, out)
    _launch(x.contiguous(), means.float().contiguous(), stds.float().contiguous(),
            out, entry, torch.cuda.current_stream(x.device).cuda_stream)
    fused_scrub_standardize.launches += 1
    return out


fused_scrub_standardize.launches = 0


def _launch(x, mean, std, out, entry, stream) -> None:
    """The C entry on contiguous x: the destination's six element strides
    of the index (n, h', dy, w', dx, c) and the kernel's read/store mode."""
    n, h, w, c = x.shape
    r = 1 if entry is None else 2
    chan, hax, wax = (1, 2, 3) if entry == "chw" else (3, 1, 2)
    s = out.stride()
    # output channel c·r² + dy·r + dx (c alone for r = 1)
    strides = (s[0], s[hax], r * s[chan], s[wax], s[chan], r * r * s[chan])
    vec = c == 4 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    mode = GENERAL if not vec else PLANES if entry == "chw" else UNIT
    _build.call("pcss_scrub_standardize", x.data_ptr(), mean.data_ptr(),
                std.data_ptr(), out.data_ptr(), n, h, w, c, r, out.shape[wax],
                *strides, int(out.dtype == torch.bfloat16), mode, stream)


def mask_to_u8_plain(x: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 1], NaN→0, ``round(x·255)`` half to even, uint8.  It
    scrubs and clips by itself: equal, bit for bit, on any float32 mask and
    on that mask scrubbed and clipped first."""
    x = torch.clamp(x.float(), 0.0, 1.0)
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return torch.round(x * 255.0).to(torch.uint8)


def fused_mask_to_u8(x: torch.Tensor) -> torch.Tensor:
    """Serving-path quantization: float mask [N, H, W, 1] → uint8 ×255."""
    if x.device.type == "cpu":
        return mask_to_u8_plain(x)
    if x.dtype != torch.float32:
        raise ValueError(f"kernel takes a float32 mask, got {x.dtype}")
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    _build.check_extent(x)
    _launch_u8(x, out, torch.cuda.current_stream(x.device).cuda_stream)
    fused_mask_to_u8.launches += 1
    return out


fused_mask_to_u8.launches = 0


def _launch_u8(x, out, stream) -> None:
    """The C entry on contiguous x, read in place: the 16-pixel vector path
    where x starts 16-byte aligned, value by value elsewhere."""
    _build.call("pcss_mask_to_u8", x.data_ptr(), out.data_ptr(), x.numel(),
                int(x.data_ptr() % 16 == 0), stream)
