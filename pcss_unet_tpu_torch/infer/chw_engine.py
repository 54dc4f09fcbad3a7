"""Channels-major end-to-end deployment forward (port of
``pcss_unet_tpu/infer/chw_engine.py``).

The activation stays in the kernels' layout ``[N, C, H, Wp]`` — W padded
with zero columns to the next multiple of 128, at least one — through the
whole forward:

- entry: pixel unshuffle to [N, in_ch·4, H/2, Wp]
  (``pixel_unshuffle_chw_padded``); the inference engine has K1 write it in
  the same pass as the scrub and standardization and starts the forward at
  ``chw_forward_entered``
- small-channel ConvBlocks run the K2 kernel (``fused_conv_block_chw``)
  directly, with the pad-column re-zeroing and the decoder skip-add in its
  epilogue
- pools, upsamples, the folded head resize and the skip-adds work on the
  padded tensor (resize matrices are zero-padded, so pad columns stay zero)
- wide stages are plain convolutions, or go through the NHWC kernels (K3,
  K5, and with ``wide="nhwc"`` K6) in a local NHWC interlude
- exit: slice, pixel shuffle, sigmoid back to [N, H, W, out_ch]

Semantics match ``UNet`` at inference on BN-folded variables; pinned against
the reference engine by ``tests/test_torch_chw_engine.py``.  Each stage's
kernel is the reference's, from ``ops/kernels/deploy.py::route``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pcss_unet_tpu_torch.models.unet import widths_from_params
from pcss_unet_tpu_torch.ops.kernels.convblock import fused_conv_block_chw
from pcss_unet_tpu_torch.ops.kernels.deploy import (block_nhwc, chw_operands,
                                                    nhwc_interlude, route)
from pcss_unet_tpu_torch.ops.pixelshuffle import padded_width as _wp
from pcss_unet_tpu_torch.ops.pixelshuffle import pixel_unshuffle_chw_padded
from pcss_unet_tpu_torch.ops.resize import (apply_matrix, matrix_on,
                                            resize_chain)
from pcss_unet_tpu_torch.utils.profiling import span


def _padded_chain(sizes: tuple[int, ...], rows: int, cols: int) -> np.ndarray:
    """``resize_chain(sizes)`` [out,in] embedded into [rows,cols]: zero rows
    → zero pad outputs, zero cols → pad-column values in the input cannot
    leak in."""
    m = resize_chain(sizes)
    out = np.zeros((rows, cols), np.float32)
    out[:m.shape[0], :m.shape[1]] = m
    return out


def _leaky(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, v, v * 0.2)


def _param(p, device) -> torch.Tensor:
    """A variables leaf (tensor or numpy) as a tensor on ``device``."""
    if isinstance(p, torch.Tensor):
        return p.to(device)
    return torch.tensor(p, device=device)


def _weights(p, device) -> tuple[torch.Tensor, ...]:
    """A block's HWIO ``(kernel_a, bias_a, kernel_b, bias_b)`` on
    ``device``."""
    return tuple(_param(p[conv][leaf], device)
                 for conv in ("conv_a", "conv_b") for leaf in ("kernel", "bias"))


def _exit_nhwc(x: torch.Tensor, w: int, out_ch: int) -> torch.Tensor:
    """[N, out·4, H', Wp] → slice true W', pixel shuffle → [N, H, W, out]
    with sigmoid, float32."""
    n, _, hh, _ = x.shape
    x = x[..., :w // 2].reshape(n, out_ch, 2, 2, hh, w // 2)  # [N,C,dy,dx,H',W']
    x = x.permute(0, 4, 2, 5, 3, 1).reshape(n, hh * 2, w, out_ch)
    return torch.sigmoid(x.float())


def _pool2x_chw(x: torch.Tensor, w: int) -> torch.Tensor:
    """2×2 average pool on the padded tensor, repadded to the half width's
    lane multiple (pad columns are zero in, so pooled pads stay zero)."""
    n, c, h, wp = x.shape
    x = x.reshape(n, c, h // 2, 2, wp // 2, 2).mean(dim=(3, 5))
    return F.pad(x, (0, _wp(w // 2) - wp // 2))


def _resize_chw(x, sizes_h: tuple[int, ...], sizes_w: tuple[int, ...],
                rows: int) -> torch.Tensor:
    """The chains of align-corners resizes ``sizes_h`` on H and ``sizes_w``
    on the true columns of W, written into ``rows`` padded columns."""
    dev = x.device
    x = apply_matrix(x, matrix_on(dev, resize_chain, sizes_h), 2)
    return apply_matrix(x, matrix_on(dev, _padded_chain, sizes_w, rows,
                                     x.shape[3]), 3)


def _upsample2x_chw(x: torch.Tensor, w: int) -> torch.Tensor:
    h = x.shape[2]
    return _resize_chw(x, (h, h * 2), (w, w * 2), _wp(w * 2))


def _block_chw_plain(x, p, *, dtype, residual=None):
    """Wide ConvBlock on the channels-major tensor as plain convolutions in
    float32 on dtype-rounded operands (the reference's nine shifted einsums,
    ``_block_chw_einsum``).  Pad columns of the output are not zero; every
    consumer of a wide stage (pool, upsample) filters them."""
    ka, b1, kb, b2 = _weights(p, x.device)                      # HWIO
    hid = F.conv2d(x.float(), ka.to(dtype).float().permute(3, 2, 0, 1),
                   padding=1)
    hid = hid + b1.float()[None, :, None, None]
    hid = _leaky(hid).to(dtype).float()
    w2 = kb[0, 0].to(dtype).float()                              # [Cm, Co]
    out = torch.einsum("cm,nchw->nmhw", w2, hid)
    out = out + b2.float()[None, :, None, None]
    out = _leaky(out).to(dtype)
    return out if residual is None else out + residual


def _block_chw(x, p, w, *, taps: str, dtype, residual=None):
    """Folded ConvBlock through the K2 kernel, no layout change.  Pad-column
    re-zeroing and the additive skip run in the kernel's epilogue."""
    w1, b1, w2, b2 = chw_operands(*_weights(p, x.device), dtype)
    return fused_conv_block_chw(
        x.to(dtype), w1, b1, w2, b2, negative_slope=0.2, taps=taps, true_w=w,
        residual=None if residual is None else residual.to(dtype))


def _block_interlude(x, p, w, name, dtype):
    """Folded ConvBlock in a local NHWC interlude: the true ``w`` columns
    as NHWC through the kernel ``name`` (``ops.kernels.deploy``), or plain
    convolutions where it is None, then repadded channels-major."""
    xh = x[..., :w].permute(0, 2, 3, 1).contiguous()
    if name is None:
        out = _block_chw_plain(xh.permute(0, 3, 1, 2), p, dtype=dtype)
    else:
        out = block_nhwc(name, xh, *_weights(p, x.device),
                         dtype=dtype).permute(0, 3, 1, 2)
    return F.pad(out, (0, _wp(w) - w)).contiguous()


def _check(h: int, w: int, depth: int, movers: str, wide: str) -> None:
    align = 2 ** depth
    if h % align or w % align:
        raise ValueError(f"chw_forward needs H,W divisible by {align} "
                         f"(got {h}x{w}); pad at the pipeline edge")
    if movers not in ("mxu", "xla"):
        raise ValueError(f"movers must be 'mxu' or 'xla', got {movers!r}")
    if wide not in ("auto", "einsum", "nhwc"):
        raise ValueError(f"wide must be auto/einsum/nhwc, got {wide!r}")


@torch.inference_mode()
def chw_forward(variables: dict, x: torch.Tensor, *,
                dtype: torch.dtype = torch.bfloat16, int8: bool = False,
                taps: str | dict = "stack", use128_chw: bool = True,
                movers: str = "mxu", wide: str = "auto") -> torch.Tensor:
    """Channels-major inference forward, equal to the plain ``UNet`` forward
    on BN-folded ``variables`` (JAX layout: HWIO kernels, numpy or tensor
    leaves).  x [N,H,W,in_ch] with H, W divisible by 2^depth (pad first).
    Returns the float32 mask [N,H,W,out_ch].

    ``taps``: K2 tap strategy, or a dict stage name → strategy (``"*"`` =
    default).  ``movers`` ("mxu"/"xla") picks the reference's
    implementation of the layout stages; both compute the same function and
    the port has one.  ``wide``: ``"auto"`` runs the wide stages as plain
    channels-major convolutions except where the int8 NHWC kernel engages;
    ``"einsum"``/``"nhwc"`` force one path."""
    _, h, w, _ = x.shape
    _check(h, w, len(widths_from_params(variables["params"])[0]), movers, wide)
    return chw_forward_entered(
        variables, pixel_unshuffle_chw_padded(x, dtype), w, dtype=dtype,
        int8=int8, taps=taps, use128_chw=use128_chw, movers=movers, wide=wide)


@torch.inference_mode()
def chw_forward_entered(variables: dict, x: torch.Tensor, w: int, *,
                        dtype: torch.dtype = torch.bfloat16, int8: bool = False,
                        taps: str | dict = "stack", use128_chw: bool = True,
                        movers: str = "mxu", wide: str = "auto") -> torch.Tensor:
    """:func:`chw_forward` from its first input: x is the entered frame
    [N, in·4, H/2, Wp] in ``dtype`` (``pixel_unshuffle_chw_padded``, or K1
    with ``entry="chw"`` in one pass), ``w`` the frame's width W."""
    params = variables["params"]
    widths, _, out_ch = widths_from_params(params)
    depth = len(widths)
    _check(2 * x.shape[2], w, depth, movers, wide)
    if x.shape[3] != _wp(w // 2):
        raise ValueError(f"entered frame has {x.shape[3]} columns, want "
                         f"{_wp(w // 2)} for W = {w}")
    cur_w = w // 2

    def any_block(x, name, cur_w, residual=None):
        p = params[name]
        cin = p["conv_a"]["kernel"].shape[2]
        cout = p["conv_b"]["kernel"].shape[-1]
        t = (taps.get(name, taps.get("*", "stack"))
             if isinstance(taps, dict) else taps)
        with span(f"unet.{name}"):
            kernel = route(cin, cout, x.shape[2], cur_w, layout="chw",
                           int8=int8, use128_chw=use128_chw, wide=wide)
            if kernel == "fused_conv_block_chw":
                return _block_chw(x, p, cur_w, taps=t, dtype=dtype,
                                  residual=residual)
            if kernel is None and not nhwc_interlude(cin, cout, int8=int8,
                                                     wide=wide):
                return _block_chw_plain(x, p, dtype=dtype, residual=residual)
            out = _block_interlude(x, p, cur_w, kernel, dtype)
            return out if residual is None else out + residual

    skips = []
    for i in range(depth - 1):
        x = any_block(x, f"enc_{i}", cur_w)
        skips.append(x)
        x = _pool2x_chw(x, cur_w)
        cur_w //= 2
    x = any_block(x, f"enc_{depth - 1}", cur_w)

    for i, skip in enumerate(reversed(skips)):
        with span("unet.resize"):
            x = _upsample2x_chw(x, cur_w)
        cur_w *= 2
        x = any_block(x, f"dec_{i}", cur_w, residual=skip)

    # head: composed up-2×-then-match-down align-corners pair, one matrix
    # per axis (exact fold of the reference's resize chain)
    hh, wp = x.shape[2], x.shape[3]
    with span("unet.resize"):
        x = _resize_chw(x, (hh, hh * 2, hh), (cur_w, cur_w * 2, cur_w), wp)
    x = any_block(x, "dec_final", cur_w)
    with span("unet.head"):
        hk = _param(params["head"]["kernel"], x.device)[0, 0].to(dtype).float()
        x = torch.einsum("co,nchw->nohw", hk, x.float())
        x = x + _param(params["head"]["bias"],
                       x.device).float()[None, :, None, None]
        return _exit_nhwc(x.to(dtype), w, out_ch)
