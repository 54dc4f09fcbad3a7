"""The shadow U-Net as PyTorch modules, evaluation forward (port of
``pcss_unet_tpu/models/unet.py``).

Same architecture and parameter names as the reference:

- pixel-unshuffle front end: [B,H,W,4] → 16 channels at half resolution
- encoder of ``ConvBlock`` (3×3 conv keeping the channel count → norm →
  act → Dropout2d → 1×1 conv to the level width → norm → act) with 2×2
  average pools; ``apply_dilation`` dilates encoder level i's 3×3 by 2^i
- decoder: align-corners 2× upsample, ConvBlock, additive skip
- head: the up-2×-then-match-down resize pair folded into one matrix per
  axis, ``dec_final``, 1×1 conv to ``out_ch·4``, pixel shuffle, sigmoid
- odd-size inputs resized to even first

``activation`` is ``leaky_relu`` (slope 0.2, the reference's), ``relu`` or
``gelu`` (flax's ``nn.gelu``: the tanh approximation); ``normalization`` is
``batch_norm`` (running statistics), ``group_norm`` (groups of 16 channels),
``instance_norm`` (groups of one) or ``none`` (a folded checkpoint), every
norm in float32 with eps 1e-5.

Frames are NHWC at the public interface, as in the reference; inside, the
modules run NCHW.  This is the forward of ``layout="nhwc"`` and the tests'
reference for the channels-major engine.

The deployment posture (``fused_inference`` / ``int8_inference`` on a
BN-folded net at eval) routes each ConvBlock as the reference's gates do
(``_int8able``, ``_fusable128``, ``_fusable``, same precedence): int8
whole-block kernels (K3, or K5 where K3's weights would not fit) for the
≥256-channel inputs, the NHWC 128-channel kernel (K6), the channels-major
kernel through its NHWC wrapper (K2′) for ≤64-channel inputs, plain
convolutions otherwise.  As in the reference, only a LeakyReLU block
without dilation takes a kernel.  The kernels take NHWC; the NCHW
activations reach them as permuted views.

Training runs ``UNet.forward_train``, the reference's ``train=True``
forward: BatchNorm normalizes with the batch's statistics (flax's: mean
E[x], biased variance E[x²] − E[x]² clipped at 0, in float32 or wider) and
returns the updated running statistics (flax momentum 0.9, the biased
variance) instead of writing them, so the train step decides whether to
keep them; Dropout2d takes its masks from the caller (``dropout_masks``:
drawn from an explicit generator, at half the rate for ``dec_final``); the
bottleneck runs under ``torch.utils.checkpoint`` (the reference's
``remat_bottleneck``) with its mask drawn outside the checkpointed region,
so the recompute applies the same mask.  Given a ``torch.distributed``
process group (the reference's ``bn_axis_name``), the train-mode BatchNorm
takes its statistics over the group's whole batch.

Window mode is the reference's ``spatial_window`` for spatially sharded
inference (``infer.tiled.infer_sharded_halo``): ``forward`` and
``forward_entered`` take ``window=(frame_h, offset)`` (the frame's height
and the window's first row in it) and every align-corners resize then uses
the frame's coefficients, so the window's rows away from its edges are the
frame's.
``spatial_align`` and ``spatial_halo`` give the window starts' alignment
and the halo that makes them exact.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pcss_unet_tpu_torch.ops.kernels.convblock import fused_conv_block_nhwc
from pcss_unet_tpu_torch.ops.kernels.deploy import block_kernel_nhwc
from pcss_unet_tpu_torch.ops.pixelshuffle import (pixel_shuffle_nhwc,
                                                  pixel_unshuffle_nhwc)
from pcss_unet_tpu_torch.ops.resize import (apply_matrix, interp_matrix,
                                            matrix_on,
                                            resize_bilinear_align_corners,
                                            resize_chain, resize_rows_window,
                                            upsample2x_window)
from pcss_unet_tpu_torch.utils.distributed import all_reduce_sum


ACTIVATIONS = ("leaky_relu", "relu", "gelu")


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "leaky_relu":
        return F.leaky_relu(x, 0.2)
    if name == "relu":
        return F.relu(x)
    return F.gelu(x, approximate="tanh")


class GroupNorm(nn.Module):
    """flax's ``nn.GroupNorm(group_size=...)`` on NCHW in float32: per
    sample and group, mean E[x] and variance E[x²] − E[x]² (clipped at 0),
    then ``(x − mean) · (rsqrt(var + eps) · scale) + bias``.  The affine
    parameters are ``weight`` (flax ``scale``) and ``bias``."""

    def __init__(self, ch: int, group_size: int, eps: float = 1e-5):
        super().__init__()
        if ch % group_size:
            raise ValueError(f"{ch} channels are not a multiple of the group "
                             f"size {group_size}")
        self.groups, self.eps = ch // group_size, eps
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = x.float().reshape(n, self.groups, -1)
        mean = g.mean(-1)
        var = torch.clamp((g * g).mean(-1) - mean * mean, min=0.0)
        per_ch = (n, self.groups, c // self.groups)

        def expand(v):
            return v[:, :, None].expand(per_ch).reshape(n, c, 1, 1)

        mul = torch.rsqrt(expand(var) + self.eps) * self.weight.float()[:, None, None]
        return (x.float() - expand(mean)) * mul + self.bias.float()[:, None, None]


def _norm(normalization: str, ch: int) -> nn.Module:
    if normalization == "batch_norm":
        return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.1)
    if normalization == "group_norm":
        return GroupNorm(ch, 16)
    if normalization == "instance_norm":
        return GroupNorm(ch, 1)
    if normalization == "none":
        return nn.Identity()
    raise ValueError(f"unknown normalization: {normalization}")


BN_MOMENTUM = 0.9     # flax's momentum (torch's 0.1)


def batch_norm_train(x: torch.Tensor, norm: nn.BatchNorm2d,
                     running: tuple[torch.Tensor, torch.Tensor],
                     dtype: torch.dtype, group=None) -> tuple[torch.Tensor, tuple]:
    """flax ``nn.BatchNorm(use_running_average=False)`` on NCHW ``x`` in
    ``dtype``: batch mean E[x] and biased variance max(0, E[x²] − E[x]²)
    over (N, H, W), ``(x − mean) · (rsqrt(var + eps) · scale) + bias``.
    Returns the output and the updated running (mean, var) computed from
    ``running`` (detached; nothing is written).

    ``group``: a process group whose ranks hold equal shards of one batch;
    E[x] and E[x²] are then the whole batch's, from one differentiable
    all-reduce of the per-channel sums and sums of squares (flax's
    ``axis_name`` BatchNorm)."""
    xf = x.to(dtype)
    if group is None:
        mean = xf.mean(dim=(0, 2, 3))
        ex2 = (xf * xf).mean(dim=(0, 2, 3))
    else:
        c = xf.shape[1]
        count = xf.numel() // c * dist.get_world_size(group)
        sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 2, 3)),
                                         (xf * xf).sum(dim=(0, 2, 3))]), group)
        mean, ex2 = sums[:c] / count, sums[c:] / count
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    mul = torch.rsqrt(var + norm.eps) * norm.weight.to(dtype)
    y = (xf - mean[:, None, None]) * mul[:, None, None] \
        + norm.bias.to(dtype)[:, None, None]
    with torch.no_grad():
        new = tuple(BN_MOMENTUM * r + (1.0 - BN_MOMENTUM) * s.to(r.dtype)
                    for r, s in zip(running, (mean, var)))
    return y, new


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Conv in the working dtype (inputs, kernel and bias cast first)."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    padding=conv.padding, dilation=conv.dilation)


class ConvBlock(nn.Module):
    """3×3 conv (dilated by ``dilation`` where ``apply_dilation``) → norm →
    act → Dropout2d → 1×1 conv → norm → act, on NCHW.  Norms run in
    float32; activations are cast back to ``dtype``.  ``fused_inference`` /
    ``int8_inference`` turn on the deployment kernels for folded
    (``normalization='none'``) LeakyReLU blocks without dilation at eval."""

    def __init__(self, in_ch: int, features: int, dropout_rate: float = 0.2,
                 normalization: str = "batch_norm",
                 dtype: torch.dtype = torch.float32,
                 fused_inference: bool = False, int8_inference: bool = False,
                 activation: str = "leaky_relu", dilation: int = 1,
                 apply_dilation: bool = False):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation: {activation}")
        self.normalization = normalization
        self.activation = activation
        self.apply_dilation = apply_dilation
        self.dtype = dtype
        self.features = features
        self.fused_inference = fused_inference
        self.int8_inference = int8_inference
        self.route = None    # the path the last forward took (route log)
        dil = dilation if apply_dilation else 1
        self.conv_a = nn.Conv2d(in_ch, in_ch, 3, padding=dil, dilation=dil)
        self.norm_a = _norm(normalization, in_ch)
        self.dropout = nn.Dropout2d(dropout_rate)    # inert at eval
        self.conv_b = nn.Conv2d(in_ch, features, 1)
        self.norm_b = _norm(normalization, features)

    # The reference's deployment gates (pcss_unet_tpu/models/unet.py:138-182)
    # on the NCHW input's channel count: eval, folded, LeakyReLU, no dilation.
    def _deployable(self) -> bool:
        return (not self.training and self.normalization == "none"
                and self.activation == "leaky_relu" and not self.apply_dilation)

    def _fusable128(self, x: torch.Tensor) -> bool:
        return (self.fused_inference and self._deployable()
                and x.shape[1] == 128 and self.features <= 128)

    def _fusable(self, x: torch.Tensor) -> bool:
        return (self.fused_inference and self._deployable()
                and x.shape[1] <= 64 and self.features <= 128)

    def _int8able(self, x: torch.Tensor) -> bool:
        cin = x.shape[1]
        return (self.int8_inference and self._deployable() and cin >= 256
                and (cin * self.features < 2 ** 18 or cin >= 1024))

    def _kernel_block(self, x: torch.Tensor) -> torch.Tensor | None:
        """The block through a deployment kernel (named in ``self.route``),
        or None where the gates leave it to the plain convolutions."""
        if not ((self.fused_inference or self.int8_inference)
                and self._deployable()):
            return None
        cin = x.shape[1]
        xh = x.to(self.dtype).permute(0, 2, 3, 1)              # NHWC view
        b1, b2 = self.conv_a.bias.float(), self.conv_b.bias.float()
        hit = block_kernel_nhwc(
            xh, self.conv_a.weight.permute(2, 3, 1, 0), b1,    # HWIO
            self.conv_b.weight.permute(2, 3, 1, 0), b2, dtype=self.dtype,
            int8=self._int8able(x), block128=self._fusable128(x))
        if hit is not None:
            self.route, out = hit
            return out
        if self._fusable(x):
            w1 = self.conv_a.weight.permute(2, 3, 0, 1).reshape(9, cin, cin)
            self.route = "fused_conv_block_nhwc"
            return fused_conv_block_nhwc(
                xh, w1.to(self.dtype), b1[:, None],
                self.conv_b.weight[:, :, 0, 0].to(self.dtype), b2[:, None],
                negative_slope=0.2)
        return None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self._kernel_block(x)
        if out is not None:
            return out.permute(0, 3, 1, 2)
        self.route = "plain"
        for conv, norm in ((self.conv_a, self.norm_a),
                           (self.conv_b, self.norm_b)):
            x = _conv(conv, x, self.dtype)
            if self.normalization != "none":
                x = norm(x.float())
            x = _act(self.activation, x).to(self.dtype)
            if conv is self.conv_a:
                x = self.dropout(x)
        return x

    def forward_train(self, x: torch.Tensor, mask: torch.Tensor | None,
                      running: tuple | None, group=None) -> tuple[torch.Tensor, tuple]:
        """Train-mode block on NCHW ``x``: BatchNorm on batch statistics
        (of the process ``group``'s whole batch where one is given),
        Dropout2d as ``torch.where(mask, x / keep, 0)`` with ``mask`` a bool
        [B, C, 1, 1] (None: no dropout), the reference's flax Dropout.
        ``running``: (mean_a, var_a, mean_b, var_b), the running statistics
        to update (batch_norm only).  → (output, updated running stats, or
        () for other norms)."""
        self.route = "plain"
        bn_dtype = torch.promote_types(torch.float32, self.dtype)
        new = []
        for i, (conv, norm) in enumerate(((self.conv_a, self.norm_a),
                                          (self.conv_b, self.norm_b))):
            x = _conv(conv, x, self.dtype)
            if self.normalization == "batch_norm":
                x, stats = batch_norm_train(x, norm, running[2 * i:2 * i + 2],
                                            bn_dtype, group)
                new += stats
            elif self.normalization != "none":
                x = norm(x.float())
            x = _act(self.activation, x).to(self.dtype)
            if conv is self.conv_a and mask is not None:
                keep = 1.0 - self.dropout.p
                x = torch.where(mask, x / keep, torch.zeros_like(x))
        return x, tuple(new)


def _pool2x(x: torch.Tensor) -> torch.Tensor:
    """2×2 average pool on NCHW, floor semantics on odd sizes."""
    n, c, h, w = x.shape
    x = x[:, :, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(n, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def _resize_nchw(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    h, w = x.shape[2:]
    if h != out_hw[0]:
        x = apply_matrix(x, matrix_on(x.device, interp_matrix, h, out_hw[0]), 2)
    if w != out_hw[1]:
        x = apply_matrix(x, matrix_on(x.device, interp_matrix, w, out_hw[1]), 3)
    return x


class UNet(nn.Module):
    """Shadow-mask U-Net.  Default widths are the reference network's
    (64, 128, 512, 1024); ``forward(x)`` takes NHWC frames [B, H, W, in_ch]
    and returns the sigmoid mask [B, H, W, out_ch] (float32 for float32
    input, else ``dtype``).  Call ``.eval()`` first: BatchNorm uses its
    running statistics and dropout is inert only in eval mode.
    ``activation``, ``normalization`` and ``apply_dilation`` are the
    reference's model options; ``fused_inference`` / ``int8_inference`` its
    deployment switches (see the module docstring)."""

    def __init__(self, in_ch: int = 4, out_ch: int = 1,
                 dropout_rate: float = 0.2,
                 encoder_widths: Sequence[int] = (64, 128, 512, 1024),
                 normalization: str = "batch_norm",
                 dtype: torch.dtype = torch.float32,
                 fused_inference: bool = False, int8_inference: bool = False,
                 activation: str = "leaky_relu", apply_dilation: bool = False,
                 remat_bottleneck: bool = True):
        super().__init__()
        widths = tuple(encoder_widths)
        if len(widths) < 2:
            raise ValueError("UNet needs at least two encoder levels")
        self.in_ch, self.out_ch = in_ch, out_ch
        self.encoder_widths = widths
        self.normalization = normalization
        self.activation = activation
        self.apply_dilation = apply_dilation
        self.remat_bottleneck = remat_bottleneck
        self.dtype = dtype
        kw = dict(normalization=normalization, dtype=dtype,
                  fused_inference=fused_inference,
                  int8_inference=int8_inference, activation=activation,
                  apply_dilation=apply_dilation)
        prev = in_ch * 4
        for i, width in enumerate(widths):
            # encoder level i dilates its 3×3 by 2^i where apply_dilation;
            # the bottleneck (the last level) does not, as in the reference
            dil = 2 ** i if i < len(widths) - 1 else 1
            self.add_module(f"enc_{i}",
                            ConvBlock(prev, width, dropout_rate, dilation=dil, **kw))
            prev = width
        for i, width in enumerate(reversed(widths[:-1])):
            self.add_module(f"dec_{i}",
                            ConvBlock(prev, width, dropout_rate, **kw))
            prev = width
        self.dec_final = ConvBlock(prev, in_ch * 4, dropout_rate / 2, **kw)
        self.head = nn.Conv2d(in_ch * 4, out_ch * 4, 1)

    def routes(self) -> dict[str, str | None]:
        """Block name → the path its last forward took (the route log)."""
        return {name: m.route for name, m in self.named_children()
                if isinstance(m, ConvBlock)}

    @staticmethod
    def _check_window(h: int, w: int, window: tuple[int, int] | None) -> None:
        """Window mode takes even sizes only: there is no odd-size fix-up
        of a window."""
        if window is not None and (h % 2 or w % 2 or window[0] % 2):
            raise ValueError("window mode requires even window and global "
                             "sizes (pad first)")

    def forward(self, x: torch.Tensor,
                window: tuple[int, int] | None = None) -> torch.Tensor:
        orig_dtype = x.dtype
        _, h, w, _ = x.shape
        self._check_window(h, w, window)
        if h % 2 or w % 2:
            # odd-size fixup, reference Unetmodel.py:93-97
            x = resize_bilinear_align_corners(x, (h - h % 2, w - w % 2))
        out = self.forward_entered(pixel_unshuffle_nhwc(x.to(self.dtype), 2),
                                   window)
        return out if orig_dtype == torch.float32 else out.to(self.dtype)

    def forward_entered(self, x: torch.Tensor,
                        window: tuple[int, int] | None = None) -> torch.Tensor:
        """The forward from its first input: x is the pixel-unshuffled frame
        [B, H/2, W/2, in_ch·4] in ``dtype`` (``pixel_unshuffle_nhwc``, or
        K1 with ``entry="nhwc"`` in one pass).  Returns the float32 sigmoid
        mask [B, H, W, out_ch].  ``window=(frame_h, offset)``: window mode,
        x the input rows [offset, offset + 2·x.shape[1]) of a frame of
        ``frame_h`` rows."""
        self._check_window(2 * x.shape[1], 2 * x.shape[2], window)
        return self._trunk(x, lambda name, h: getattr(self, name)(h), window)

    def blocks(self) -> list[str]:
        """The ConvBlocks' names in forward order."""
        return [name for name, m in self.named_children()
                if isinstance(m, ConvBlock)]

    def dropout_masks(self, batch: int, generator: torch.Generator | None,
                      device: torch.device | str) -> dict[str, torch.Tensor]:
        """One Dropout2d keep-mask per block with a non-zero rate: bool
        [batch, C, 1, 1] (C: the block's input width), kept with
        probability 1 − rate, drawn from ``generator`` in block order."""
        masks = {}
        for name in self.blocks():
            block = getattr(self, name)
            if block.dropout.p > 0:
                u = torch.rand((batch, block.conv_a.in_channels, 1, 1),
                               generator=generator, device=device)
                masks[name] = u < 1.0 - block.dropout.p
        return masks

    def forward_train(self, x: torch.Tensor,
                      masks: dict[str, torch.Tensor] | None = None,
                      running: dict[str, torch.Tensor] | None = None,
                      group=None) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """The reference's train-mode forward of NHWC frames [B, H, W,
        in_ch]: BatchNorm on batch statistics, Dropout2d with ``masks``
        (``dropout_masks``; None or a missing block: no dropout), the
        bottleneck recomputed in the backward where ``remat_bottleneck``.
        ``running``: buffer name → running statistic to update (the
        module's buffers where absent).  → (float32 sigmoid mask [B, H, W,
        out_ch], buffer name → updated running statistic); the module's
        buffers are not written.  ``group``: the process group the
        BatchNorm statistics are taken over (None: this process's batch)."""
        masks = masks or {}
        new: dict[str, torch.Tensor] = {}
        bottleneck = f"enc_{len(self.encoder_widths) - 1}"

        def block(name, h):
            blk = getattr(self, name)
            keys = [f"{name}.{n}.running_{s}" for n in ("norm_a", "norm_b")
                    for s in ("mean", "var")]
            stats = None
            if self.normalization == "batch_norm":
                buffers = dict(blk.named_buffers(prefix=name))
                stats = tuple((running or {}).get(k, buffers[k]) for k in keys)
            if (name == bottleneck and self.remat_bottleneck
                    and torch.is_grad_enabled()):
                # no randomness inside: the mask comes in as a tensor
                out, st = checkpoint(blk.forward_train, h, masks.get(name),
                                     stats, group, use_reentrant=False,
                                     preserve_rng_state=False)
            else:
                out, st = blk.forward_train(h, masks.get(name), stats, group)
            new.update(zip(keys, st))
            return out

        _, h, w, _ = x.shape
        if h % 2 or w % 2:
            x = resize_bilinear_align_corners(x, (h - h % 2, w - w % 2))
        out = self._trunk(pixel_unshuffle_nhwc(x.to(self.dtype), 2), block)
        return out, new

    def _trunk(self, x: torch.Tensor, block,
               window: tuple[int, int] | None = None) -> torch.Tensor:
        """The network from its pixel-unshuffled NHWC input to the sigmoid
        mask, ``block(name, h)`` running each ConvBlock on NCHW ``h``;
        with a ``window=(frame_h, offset)``, in window mode
        (global-coefficient resizes, no size re-match)."""
        x = x.permute(0, 3, 1, 2)
        # the frame's height and the window's first row, at half resolution
        g_half, a_half = (None, None) if window is None else (window[0] // 2,
                                                              window[1] // 2)
        depth = len(self.encoder_widths)
        skips = []
        for i in range(depth - 1):
            x = block(f"enc_{i}", x)
            skips.append(x)
            x = _pool2x(x)
        x = block(f"enc_{depth - 1}", x)
        for i, skip in enumerate(reversed(skips)):
            hh, ww = x.shape[2:]
            if a_half is None:
                x = _resize_nchw(x, (hh * 2, ww * 2))
                x = _resize_nchw(x, tuple(skip.shape[2:]))   # size re-match
            else:
                # the frame's align-corners coefficients, not the window's
                scale = 2 ** (depth - 1 - i)
                x = upsample2x_window(x, g_half // scale, a_half // scale,
                                      axes=(2, 3))
                if x.shape[2:] != skip.shape[2:]:
                    raise ValueError(
                        "window mode requires pooling-aligned sizes (decoder "
                        f"level {i}: {tuple(x.shape[2:])} vs "
                        f"{tuple(skip.shape[2:])})")
            x = block(f"dec_{i}", x) + skip
        hh, ww = x.shape[2:]
        th, tw = skips[0].shape[2:]
        # the head's up-2×-then-match-down resize pair, folded into one
        # matrix per axis (exact: a composition of linear maps)
        if a_half is not None:
            # the frame's th == hh
            x = resize_rows_window(x, (g_half, g_half * 2, g_half),
                                   (ww, ww * 2, tw), a_half, a_half, axes=(2, 3))
        else:
            for axis, sizes in ((2, (hh, hh * 2, th)), (3, (ww, ww * 2, tw))):
                if not np.array_equal(resize_chain(sizes),
                                      np.eye(sizes[0], dtype=np.float32)):
                    x = apply_matrix(x, matrix_on(x.device, resize_chain, sizes),
                                     axis)
        x = block("dec_final", x)
        x = _conv(self.head, x, self.dtype)
        x = pixel_shuffle_nhwc(x.permute(0, 2, 3, 1), 2)
        return torch.sigmoid(x.float())


def spatial_align(model: UNet) -> int:
    """Input-resolution row alignment every window start must keep for
    window-exact sharded inference: s/2 ≡ 0 (mod 2^(depth−1)), so each
    pooling level tiles cleanly and the global resize offsets (``a_half //
    scale``) divide without truncation, i.e. s ≡ 0 (mod 2^depth).  16 for
    the depth-3/4 nets, 32 for depth 5, 128 for depth 7."""
    return max(16, 2 ** len(model.encoder_widths))


def spatial_halo(model: UNet) -> int:
    """Input-resolution halo rows that make a window's rows exact under
    spatially sharded inference (``infer.tiled.infer_sharded_halo``): the
    trunk's receptive-field radius in half-resolution rows (one 3×3 conv
    per ConvBlock, radius = level scale × dilation; encoder, bottleneck and
    the mirrored decoder, plus the head-resize matrix band (≤ 3) and
    dec_final's 3×3 (1)), doubled to input resolution and rounded up to
    ``spatial_align``."""
    d = len(model.encoder_widths)
    r = 0
    for k in range(d - 1):                       # encoder levels
        dil = (2 ** k) if model.apply_dilation else 1
        r += (2 ** k) * dil
    r += 2 ** (d - 1)                            # bottleneck
    r += sum(2 ** k for k in range(d - 1))       # decoder mirror
    r += 3 + 1                                   # head band + dec_final
    r *= 2                                       # half-res → input rows
    a = spatial_align(model)
    return -(-r // a) * a


def widths_from_params(params) -> tuple[tuple[int, ...], int, int]:
    """Recover ``(encoder_widths, in_ch, out_ch)`` from a variables
    ``params`` tree (HWIO kernels): each ``enc_k/conv_b`` output dim is a
    level width, ``enc_0/conv_a``'s input dim is ``in_ch·4`` and the head's
    output dim ``out_ch·4``.  Raises ``ValueError`` for other trees."""
    try:
        ks = sorted((k for k in params if k.startswith("enc_")),
                    key=lambda k: int(k.split("_")[1]))
        widths = tuple(int(params[k]["conv_b"]["kernel"].shape[-1])
                       for k in ks)
        folded_in = int(params["enc_0"]["conv_a"]["kernel"].shape[2])
        folded_out = int(params["head"]["kernel"].shape[-1])
    except (KeyError, TypeError, AttributeError, IndexError) as e:
        raise ValueError(f"not a UNet parameter tree: {e}") from None
    if not widths or folded_in % 4 or folded_out % 4:
        raise ValueError("not a UNet parameter tree (no encoder levels or "
                         "unfolded stem/head)")
    return widths, folded_in // 4, folded_out // 4


DEPTH_WIDTHS = {3: (1, 2, 4), 4: (1, 2, 8, 16), 5: (1, 2, 4, 8, 16),
                7: (1, 1, 2, 4, 8, 8, 16)}    # × base_width, per model_depth


def unet_from_config(cfg, *, device: str | torch.device = "cuda") -> UNet:
    """The UNet a ``pcss_unet_tpu_torch.config.Config`` describes (widths
    ``base_width`` × ``DEPTH_WIDTHS[model_depth]``, channels, dropout,
    activation, normalization, dilation, ``compute_dtype``), with torch's
    initial weights, in eval mode on ``device``."""
    mults = DEPTH_WIDTHS.get(cfg.model_depth)
    if mults is None:
        raise ValueError(f"unsupported model_depth: {cfg.model_depth}")
    model = UNet(in_ch=cfg.input_channels, out_ch=cfg.output_channels,
                 dropout_rate=cfg.dropout_rate,
                 encoder_widths=tuple(cfg.base_width * m for m in mults),
                 activation=cfg.activation, normalization=cfg.normalization,
                 apply_dilation=cfg.apply_dilation,
                 dtype=getattr(torch, cfg.compute_dtype))
    return model.eval().to(device)


def unet_for_variables(cfg_or_variables, variables: dict | None = None, *,
                       dtype: torch.dtype = torch.float32,
                       device: str | torch.device = "cuda",
                       fused_inference: bool = False,
                       int8_inference: bool = False,
                       activation: str | None = None,
                       normalization: str | None = None,
                       apply_dilation: bool | None = None) -> UNet:
    """Build the UNet a variables tree describes (widths and channels),
    load its weights, and return it in eval mode on ``device``, with the
    given deployment switches.

    ``unet_for_variables(cfg, variables, ...)`` is the CLIs' form, as in the
    reference (``pcss_unet_tpu/models/unet.py::unet_for_variables``): the
    checkpoint is the authority on the architecture, and where its widths
    or channels disagree with the config's ``base_width``/``model_depth``
    the model follows the checkpoint (logged); the config gives the options
    a checkpoint does not hold (``activation``, ``normalization``,
    ``apply_dilation``).  The keyword options override it; without either,
    LeakyReLU without dilation.  A BN-folded tree (no ``norm_*``) always
    builds ``normalization='none'``; otherwise the default is
    ``batch_norm``.  As in flax, parameters the model does not use (the
    running statistics beside a ``group_norm``) are ignored, and missing
    ones raise ``ValueError``."""
    from pcss_unet_tpu_torch.models.torch_import import from_flax_variables

    cfg = None if variables is None else cfg_or_variables
    if variables is None:
        variables = cfg_or_variables
    params = variables["params"]
    widths, in_ch, out_ch = widths_from_params(params)
    opts = {"activation": activation, "normalization": normalization,
            "apply_dilation": apply_dilation}
    defaults = {"activation": "leaky_relu", "normalization": "batch_norm",
                "apply_dilation": False}
    for k, v in opts.items():
        if v is None:
            opts[k] = getattr(cfg, k) if cfg is not None else defaults[k]
    if "norm_a" not in params["enc_0"]:
        opts["normalization"] = "none"
    if cfg is not None:
        cfg_widths = tuple(cfg.base_width * m
                           for m in DEPTH_WIDTHS.get(cfg.model_depth, ()))
        if (widths, in_ch, out_ch) != (cfg_widths, cfg.input_channels,
                                       cfg.output_channels):
            import logging
            logging.info("checkpoint architecture widths=%s in=%d out=%d "
                         "overrides config (base_width=%d, model_depth=%d)",
                         widths, in_ch, out_ch, cfg.base_width,
                         cfg.model_depth)
    model = UNet(in_ch=in_ch, out_ch=out_ch, encoder_widths=widths, dtype=dtype,
                 fused_inference=fused_inference, int8_inference=int8_inference,
                 **opts)
    state = from_flax_variables(variables)
    missing = sorted(set(model.state_dict()) - set(state))
    if missing:
        raise ValueError(f"variables lack {missing[:4]} for a "
                         f"{opts['normalization']} model")
    model.load_state_dict({k: state[k] for k in model.state_dict()})
    return model.eval().to(device)
