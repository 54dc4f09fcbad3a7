"""The train-mode tail of every ConvBlock convolution: BatchNorm on the
batch's statistics → LeakyReLU (or ReLU) → the working dtype → Dropout2d,
as one autograd op, ``bn_act_dropout_train`` (CUDA in ``csrc/bn_train.cu``).

It replaces no TPU kernel: the JAX package's training reaches no Pallas
kernel (XLA fuses the chain there).  It was added because the plain chain
(``models/unet.py::batch_norm_train``, the activation, the cast and
``torch.where``) runs as ~20 PyTorch launches a conv output, each a full
float32 pass, and autograd keeps three float32 copies of every element for
its backward.  The kernels are bound by bytes: 6 an element forward (x read
twice, the bf16 output written), 10 backward (x and the gradient read
twice, dx written), and the op saves only x (bf16), per-channel float32
vectors and the mask.

``models/unet.py::ConvBlock.forward_train`` routes a block here on the card
where the net computes in bfloat16 with ``batch_norm`` and ``leaky_relu`` or
``relu`` and no process group or row shard: the data-parallel and
row-sharded paths keep the plain chain, since their statistics and the
backward's sums are all-reduced over the group.

**Arithmetic** (the plain chain's, one rounding a step): mean E[x] and
biased variance max(0, E[x²] − E[x]²) over (N, H, W) in float32 (the
kernels add per-block float32 sums in float64), ``mul = rsqrt(var + eps) ·
γ``, ``y = (x − mean) · mul + β``, the activation, the cast to x's dtype,
and with a keep-mask [N, C, 1, 1] ``where(mask, a / keep, 0)``; the updated
running statistics ``momentum · r + (1 − momentum) · s`` are returned, not
written.  Backward: ``g_a`` the dropout's gradient, ``g_y = g_a`` where
y > 0 else ``g_a · slope``; dβ = Σ g_y, dγ = rstd · Σ g_y (x − mean),
``dx = mul · g_y − mul · mean(g_y) − B · (x − mean)``, ``B = mul · rstd² ·
mean(g_y (x − mean))``, 0 where E[x²] − E[x]² < 0 (the clamp passes no
gradient there).

**Layouts**: the kernels take both storages a convolution hands over, NCHW
contiguous and channels-last, chosen from the strides (``plan``), and
write their outputs in x's storage; the incoming gradient is brought to x's
storage first where it differs.

``bn_act_dropout_train`` counts its kernel launches (three a forward, three
a backward) in ``.launches``; a CPU tensor takes the plain versions,
``bn_act_dropout_plain`` and ``bn_act_dropout_backward_plain``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from pcss_unet_tpu_torch.ops.kernels import _build

PLANAR, ROWS = 0, 1         # the walk: NCHW contiguous, channels-last
THREADS = 256               # threads a block (csrc/bn_train.cu kThreads)
MIN_SPAN = 16384            # values of a channel a block walks at least
TARGET_BLOCKS = 1024        # blocks a walk aims at, beyond MIN_SPAN
STATS_ROWS = ("mean", "mul", "rstd", "live", "running_mean", "running_var")


def _act(y: torch.Tensor, slope: float) -> torch.Tensor:
    return F.leaky_relu(y, slope) if slope else F.relu(y)


def _dropout(a: torch.Tensor, mask: torch.Tensor | None, keep: float) -> torch.Tensor:
    return a if mask is None else torch.where(mask, a / keep, torch.zeros_like(a))


def bn_act_dropout_plain(x, weight, bias, running_mean, running_var, mask,
                         keep: float, slope: float, eps: float, momentum: float):
    """The chain in plain PyTorch, in float32 (float64 for float64 x), the
    output in x's dtype: → (output, stats [6, C]: mean, mul, rstd, live (1
    where E[x²] − E[x]² ≥ 0), the updated running mean and variance)."""
    dtype = torch.promote_types(torch.float32, x.dtype)
    xf = x.to(dtype)
    mean = xf.mean(dim=(0, 2, 3))
    ex2 = (xf * xf).mean(dim=(0, 2, 3))
    raw = ex2 - mean * mean
    var = torch.clamp(raw, min=0.0)
    rstd = torch.rsqrt(var + eps)
    mul = rstd * weight.to(dtype)
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bias.to(dtype)[:, None, None]
    out = _dropout(_act(y, slope).to(x.dtype), mask, keep)
    new = [momentum * r + (1.0 - momentum) * s.to(r.dtype)
           for r, s in ((running_mean, mean), (running_var, var))]
    live = (raw >= 0).to(dtype)
    return out, torch.stack([mean, mul, rstd, live] + [t.to(dtype) for t in new])


def bn_act_dropout_backward_plain(g, x, bias, stats, mask, keep: float,
                                  slope: float):
    """The backward in plain PyTorch from the forward's ``stats``: →
    (dx in x's dtype, dγ, dβ in the stats' dtype)."""
    mean, mul, rstd, live = (stats[i][:, None, None] for i in range(4))
    xc = x.to(stats.dtype) - mean
    y = xc * mul + bias.to(stats.dtype)[:, None, None]
    ga = _dropout(g, mask, keep).to(stats.dtype)
    gy = torch.where(y > 0, ga, ga * slope if slope else torch.zeros_like(ga))
    count = x.numel() // x.shape[1]
    s1 = gy.sum(dim=(0, 2, 3))
    s2 = (gy * xc).sum(dim=(0, 2, 3))
    a = mul * (s1 / count)[:, None, None]
    b = live * mul * rstd * rstd * (s2 / count)[:, None, None]
    dx = (mul * gy - a - b * xc).to(x.dtype)
    return dx, s2 * rstd[:, 0, 0], s1


def plan(x: torch.Tensor, *others: torch.Tensor) -> tuple[int, int, int, int]:
    """→ (layout, vec, span, parts): how the kernels walk x (``PLANAR`` for
    NCHW contiguous, ``ROWS`` for channels-last; a tensor that is both takes
    ``PLANAR``), 8 values a thread where the walked extent allows it and x
    and ``others`` are 16-byte aligned (else 1), and the span of each block
    (values of a channel, or rows) and their count, about ``TARGET_BLOCKS``
    blocks of at least ``MIN_SPAN`` values."""
    n, c, h, w = x.shape
    hw = h * w
    if x.is_contiguous():
        layout, inner = PLANAR, hw
    elif x.is_contiguous(memory_format=torch.channels_last):
        layout, inner = ROWS, c
    else:
        raise ValueError(f"strides {x.stride()} of {tuple(x.shape)}: the kernels take "
                         "NCHW contiguous or channels-last storage")
    vec = 8 if inner % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, *others)) else 1
    per_block = max(MIN_SPAN, math.ceil(x.numel() / TARGET_BLOCKS))
    extent = n * hw
    if layout == PLANAR:
        step = THREADS * vec
        span = min(math.ceil(per_block / step) * step, math.ceil(extent / vec) * vec)
    else:
        groups = c // vec
        rb = THREADS // min(groups, THREADS)
        span = min(math.ceil(max(1, per_block // c) / rb) * rb, extent)
    return layout, vec, span, math.ceil(extent / span)


def _check(x, *vectors):
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"the kernels take bf16 [N, C, H, W], got {x.dtype} "
                         f"{tuple(x.shape)}")
    _build.check_device(x, *vectors)
    _build.check_extent(x)
    for v in vectors:
        if v is not None and (v.dtype != torch.float32 or v.shape != (x.shape[1],)
                              or not v.is_contiguous()):
            raise ValueError(f"per-channel operand {v.dtype} {tuple(v.shape)}: the "
                             f"kernels take contiguous float32 [{x.shape[1]}]")


def _mask_bytes(mask, x):
    """The keep-mask [N, C, 1, 1] as contiguous uint8 [N, C] (None: none)."""
    if mask is None:
        return None
    n, c = x.shape[:2]
    if mask.dtype != torch.bool or mask.shape != (n, c, 1, 1):
        raise ValueError(f"mask {mask.dtype} {tuple(mask.shape)}: the kernels take "
                         f"bool [{n}, {c}, 1, 1]")
    _build.check_device(x, mask)
    return mask.reshape(n, c).contiguous().view(torch.uint8)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _scalars(keep: float, slope: float) -> tuple[float, float]:
    """(RN(1 / keep) in float32, as PyTorch's CUDA division by a scalar
    multiplies by it; the slope)."""
    return float(np.float32(1.0) / np.float32(keep)), float(slope)


def _launch_forward(x, weight, bias, running_mean, running_var, mask, keep,
                    slope, eps, momentum, stream):
    """The forward's C entry: → (output in x's storage, stats [6, C])."""
    _check(x, weight, bias, running_mean, running_var)
    m = _mask_bytes(mask, x)
    out = torch.empty_like(x)
    layout, vec, span, parts = plan(x, out)
    n, c, h, w = x.shape
    stats = torch.empty((len(STATS_ROWS), c), dtype=torch.float32, device=x.device)
    part = torch.empty((c, parts, 2), dtype=torch.float32, device=x.device)
    _build.call("pcss_bn_train_forward", x.data_ptr(), out.data_ptr(), _ptr(m),
                weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
                running_var.data_ptr(), stats.data_ptr(), part.data_ptr(), n, c,
                h * w, layout, vec, span, parts, float(eps),
                float(np.float32(momentum)), float(np.float32(1.0 - momentum)),
                *_scalars(keep, slope), stream)
    return out, stats


def _launch_backward(g, x, bias, stats, mask, keep, slope, stream):
    """The backward's C entry: → (dx in x's storage, dγ, dβ)."""
    _check(x, bias)
    m = _mask_bytes(mask, x)
    if g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(f"gradient {g.dtype} {tuple(g.shape)} for x {x.dtype} "
                         f"{tuple(x.shape)}")
    fmt = torch.contiguous_format if x.is_contiguous() else torch.channels_last
    g = g.contiguous(memory_format=fmt)
    dx = torch.empty_like(x)
    layout, vec, span, parts = plan(x, g, dx)
    n, c, h, w = x.shape
    grads = torch.empty((4, c), dtype=torch.float32, device=x.device)
    part = torch.empty((c, parts, 2), dtype=torch.float32, device=x.device)
    _build.call("pcss_bn_train_backward", x.data_ptr(), g.data_ptr(), dx.data_ptr(),
                _ptr(m), bias.data_ptr(), stats.data_ptr(), grads.data_ptr(),
                part.data_ptr(), n, c, h * w, layout, vec, span, parts,
                *_scalars(keep, slope), stream)
    return dx, grads[0], grads[1]


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


@_build.on_device
def _forward(x, weight, bias, running_mean, running_var, mask, keep, slope, eps,
             momentum):
    if x.device.type == "cpu":
        return bn_act_dropout_plain(x, weight, bias, running_mean, running_var,
                                    mask, keep, slope, eps, momentum)
    out = _launch_forward(x, weight, bias, running_mean, running_var, mask, keep,
                          slope, eps, momentum, _stream(x))
    bn_act_dropout_train.launches += 3
    return out


@_build.on_device
def _backward(x, g, bias, stats, mask, keep, slope):
    if x.device.type == "cpu":
        return bn_act_dropout_backward_plain(g, x, bias, stats, mask, keep, slope)
    grads = _launch_backward(g, x, bias, stats, mask, keep, slope, _stream(x))
    bn_act_dropout_train.launches += 3
    return grads


class BnActDropoutTrain(torch.autograd.Function):
    """``apply(x, weight, bias, running_mean, running_var, mask, keep,
    slope, eps, momentum)`` → (output, new running mean, new running var);
    the backward gives x, weight and bias their gradients.  Saved: x, the
    stats [6, C], β and the mask."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, mask, keep,
                slope, eps, momentum):
        out, stats = _forward(x, weight, bias, running_mean, running_var, mask,
                              keep, slope, eps, momentum)
        ctx.save_for_backward(x, bias, stats, mask)
        ctx.keep, ctx.slope = keep, slope
        new_mean = stats[4].to(running_mean.dtype)
        new_var = stats[5].to(running_var.dtype)
        ctx.mark_non_differentiable(new_mean, new_var)
        return out, new_mean, new_var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, bias, stats, mask = ctx.saved_tensors
        dx, dw, db = _backward(x, g, bias, stats, mask, ctx.keep, ctx.slope)
        return (dx, dw, db) + (None,) * 7


def bn_act_dropout_train(x, weight, bias, running_mean, running_var, mask,
                         keep: float, slope: float, eps: float, momentum: float):
    """The train-mode BatchNorm → activation (LeakyReLU of ``slope``, ReLU
    for 0) → x's dtype → Dropout2d (``mask`` bool [N, C, 1, 1] kept with
    probability ``keep``; None: none) on NCHW x, with its gradient:
    → (output in x's storage, updated running mean, updated running
    variance).  On the card x is bf16 and the per-channel operands float32;
    the kernels' launches are counted in ``.launches``."""
    return BnActDropoutTrain.apply(x, weight, bias, running_mean, running_var,
                                   mask, keep, slope, eps, momentum)


bn_act_dropout_train.launches = 0
