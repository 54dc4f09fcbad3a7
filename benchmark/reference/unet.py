"""Plain reference of the shadow U-Net's deployment forward (Datta et al.,
*Neural Shadow Mapping*, SIGGRAPH 2022; the architecture of
github.com/SDU-Gary/PCSS-Unet ``Unetmodel.py``), in plain PyTorch.

It imports nothing of the program under test and takes nothing the program
made: it folds BatchNorm into the convolutions itself, quantizes the int8
blocks' weights itself, picks their band heights itself, and computes the
resize matrices itself, from the raw seeded weights and frames that the
benchmark hands to both.

What it computes, on NCHW float32 tensors (TF32 off, so a float32 product is
a float32 product):

- the frame scrubbed (NaN -> 0, +Inf -> 1, -Inf -> 0), standardized with
  ``(x - mean) * (1 / (std + 1e-8))``, pixel-unshuffled by 2 (channel
  ``c*4 + dy*2 + dx``);
- encoder ConvBlocks with 2x2 average pools, the bottleneck, and per
  decoder level an align-corners 2x upsample, a ConvBlock and the additive
  skip; the head's up-2x-then-back resize pair as one matrix per axis,
  ``dec_final``, the 1x1 head conv, pixel shuffle, sigmoid;
- the mask as uint8 codes, ``round(clip(mask, 0, 1) * 255)`` half to even.

A ConvBlock is ``leaky(W_b * leaky(W_a (*) x + b_a) + b_b)`` (slope 0.2) with
BatchNorm folded in.  Blocks that the deployment's int8 gate takes (input
width >= 256 and ``cin * cout < 2**18`` or ``cin >= 1024``) run the
published int8 scheme: per band of ``k_rows`` rows, one activation scale
``max|x| / 127 + 1e-12`` over the band and its halo rows (per ``c_chunk``
input channels where the 3x3 weights are too large for one chunk), weights
per output channel, exact integer sums, dequantize, bias, LeakyReLU; then a
second scale over the band's hidden values for the 1x1.

``cast`` is the working precision, applied where the deployment stores a
tensor: the entered frame, each block's hidden and output values, pools,
resizes and the head's logits (``bf16`` for the configuration's bfloat16).
``qmax`` is the integer range of the int8 blocks (127).  A lower precision
(``fp8`` and ``qmax=7``) gives the control that the comparison must reject.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SLOPE = 0.2
BN_EPS = 1e-5


# ----------------------------------------------------------------- precisions

def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back (the configuration's working precision)."""
    return x.to(torch.bfloat16).float()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per tensor (amax -> 448) and back:
    the precision below bfloat16 that a later change could be tempted by."""
    amax = x.abs().amax().float()
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


CASTS = {"bf16": bf16, "fp8": fp8, "fp32": lambda x: x.float()}


# ------------------------------------------------------------------- weights

def fold(weights: dict, name: str, conv: str, norm: str):
    """BatchNorm folded into the conv before it, in float64:
    ``W * s``, ``(b - mean) * s + beta`` with ``s = gamma / sqrt(var + eps)``;
    stored as float32."""
    g = lambda k: weights[f"{name}.{k}"].double()  # noqa: E731
    s = g(f"{norm}.weight") / torch.sqrt(g(f"{norm}.running_var") + BN_EPS)
    w = g(f"{conv}.weight") * s[:, None, None, None]
    b = (g(f"{conv}.bias") - g(f"{norm}.running_mean")) * s + g(f"{norm}.bias")
    return w.float(), b.float()


def int8_gate(cin: int, cout: int) -> bool:
    """The deployment's int8 gate on a block's widths."""
    return cin >= 256 and (cin * cout < 2 ** 18 or cin >= 1024)


def pick_k_rows_int8(h: int, w: int, c: int, cout: int):
    """Band height of the whole-block int8 scheme (a frozen copy of the
    published picker), or None."""
    if c % 128 or cout % 64:
        return None
    budget = 14 * 1024 * 1024
    wgt = 9 * c * c + c * cout
    if wgt > 5 * 1024 * 1024:
        return None
    for k in (8, 4, 2):
        if h % k or (k * w) % 32:
            continue
        need = (2 * k * w * c * 2 + 2 * 2 * w * c * 2 + (k + 2) * w * c
                + 2 * k * w * c + k * w * c * 4 + k * w * c * 2 + k * w * c
                + k * w * cout * 4 + 2 * k * w * cout * 2 + wgt)
        if need <= budget:
            return k
    return None


def pick_kchunked(h: int, w: int, c: int, cout: int):
    """(k_rows, c_chunk) of the channel-chunked int8 scheme (a frozen copy
    of the published picker), or None."""
    if c % 256 or cout % 64:
        return None
    budget = 14 * 1024 * 1024
    for cc in (256, 128):
        if c % cc:
            continue
        for k in (4, 2):
            if h % k or (k * w) % 32:
                continue
            need = (2 * k * w * cc * 2 + 2 * 2 * w * cc * 2 + (k + 2) * w * cc
                    + 2 * k * w * cc + 2 * 9 * cc * c + k * w * c * 4
                    + k * w * c * 4 + k * w * c + c * cout + k * w * cout * 4
                    + 2 * k * w * cout * 2)
            if need <= budget:
                return k, cc
    return None


def route(cin: int, cout: int, h: int, w: int, int8: bool):
    """("int8", k_rows, c_chunk, hidden_bf16) for a block the int8 scheme
    takes, else ("float",)."""
    if int8 and int8_gate(cin, cout):
        k = pick_k_rows_int8(h, w, cin, cout)
        if k:
            return ("int8", k, cin, True)
        kc = pick_kchunked(h, w, cin, cout)
        if kc:
            return ("int8", kc[0], kc[1], False)
    return ("float",)


# --------------------------------------------------------------- primitives

def interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] align-corners linear interpolation, float64."""
    m = np.zeros((n_out, n_in))
    if n_out == 1:
        m[0, 0] = 1.0
        return m
    for i in range(n_out):
        c = i * (n_in - 1) / (n_out - 1)
        lo = min(int(math.floor(c)), n_in - 1)
        hi = min(lo + 1, n_in - 1)
        f = c - lo
        m[i, lo] += 1.0 - f
        m[i, hi] += f
    return m


def chain(sizes) -> np.ndarray:
    m = np.eye(sizes[0])
    for a, b in zip(sizes[:-1], sizes[1:]):
        m = interp_matrix(a, b) @ m
    return m


def resize(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray, cast) -> torch.Tensor:
    """Apply [out, in] matrices on H and W of NCHW ``x``, each product in
    float32 on the working-precision matrix, the result stored."""
    th = cast(torch.as_tensor(mh, dtype=torch.float32, device=x.device))
    tw = cast(torch.as_tensor(mw, dtype=torch.float32, device=x.device))
    x = cast(torch.einsum("oh,nchw->ncow", th, x))
    return cast(torch.einsum("ow,nchw->ncho", tw, x))


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * SLOPE)


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def int_conv(q: torch.Tensor, wq: torch.Tensor, padding) -> torch.Tensor:
    """Exact integer convolution of integer-valued float tensors: float32
    convolutions over 64-channel slices (every partial sum below 2**24, so
    exact), summed in float64.  Returns float64."""
    acc = None
    for c0 in range(0, q.shape[1], 64):
        part = F.conv2d(q[:, c0:c0 + 64], wq[:, c0:c0 + 64], padding=padding).double()
        acc = part if acc is None else acc + part
    return acc


def quant(v: torch.Tensor, scale: torch.Tensor, qmax: int) -> torch.Tensor:
    return torch.clamp(torch.round(v / scale), -qmax, qmax)


def int8_block(x, wa, ba, wb, bb, k_rows, c_chunk, hidden_bf16, cast, qmax):
    """The int8 ConvBlock on NCHW ``x`` (values already in the working
    precision), band by band."""
    n, c, h, w = x.shape
    nb = h // k_rows
    sa = true_div(wa.abs().amax(dim=(1, 2, 3)), float(qmax)) + 1e-12
    wq = torch.clamp(torch.round(wa / sa[:, None, None, None]), -qmax, qmax)
    sb = true_div(wb.abs().amax(dim=(1, 2, 3)), float(qmax)) + 1e-12
    wbq = torch.clamp(torch.round(wb / sb[:, None, None, None]), -qmax, qmax)[:, :, 0, 0]
    xp = F.pad(x, (0, 0, 1, 1))                                   # halo rows
    ext = xp.unfold(2, k_rows + 2, k_rows)                        # [n,c,nb,w,k+2]
    ext = ext.permute(0, 2, 1, 4, 3).reshape(n * nb, c, k_rows + 2, w)
    f = None
    for c0 in range(0, c, c_chunk):
        e = ext[:, c0:c0 + c_chunk]
        a = true_div(e.abs().amax(dim=(1, 2, 3)), float(qmax)) + 1e-12
        acc = int_conv(quant(e, a[:, None, None, None], qmax),
                       wq[:, c0:c0 + c_chunk], (0, 1)).float()
        part = acc * (a[:, None] * sa[None, :])[:, :, None, None]
        f = part if f is None else f + part
    hid = leaky(f + ba[None, :, None, None])                      # [n*nb, cm, k, w]
    if hidden_bf16:
        hid = cast(hid)
    a2 = true_div(hid.abs().amax(dim=(1, 2, 3)), float(qmax)) + 1e-12
    q2 = quant(hid, a2[:, None, None, None], qmax)
    acc2 = torch.einsum("om,bmhw->bohw", wbq, q2)                 # exact < 2**24
    out = acc2 * (a2[:, None] * sb[None, :])[:, :, None, None] + bb[None, :, None, None]
    out = leaky(out)
    cout = out.shape[1]
    return out.reshape(n, nb, cout, k_rows, w).permute(0, 2, 1, 3, 4).reshape(n, cout, h, w)


def float_block(x, wa, ba, wb, bb, cast):
    """The ConvBlock with weights and stored values in the working
    precision, float32 sums."""
    hid = F.conv2d(x, cast(wa), padding=1) + ba[None, :, None, None]
    hid = cast(leaky(hid))
    out = F.conv2d(hid, cast(wb)) + bb[None, :, None, None]
    return leaky(out)


def pool2x(x: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    return x.reshape(n, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))


def unshuffle(x: torch.Tensor) -> torch.Tensor:
    """NHWC [n, h, w, c] -> NCHW [n, 4c, h/2, w/2], channel c*4 + dy*2 + dx."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 5, 2, 4, 1, 3)
    return x.reshape(n, c * 4, h // 2, w // 2)


def shuffle(x: torch.Tensor) -> torch.Tensor:
    """NCHW [n, 4c, h, w] -> NHWC [n, 2h, 2w, c] (inverse of ``unshuffle``)."""
    n, c4, h, w = x.shape
    x = x.reshape(n, c4 // 4, 2, 2, h, w).permute(0, 4, 2, 5, 3, 1)
    return x.reshape(n, h * 2, w * 2, c4 // 4)


# ------------------------------------------------------------------ forward

def widths_of(weights: dict) -> tuple[int, ...]:
    out, i = [], 0
    while f"enc_{i}.conv_b.weight" in weights:
        out.append(weights[f"enc_{i}.conv_b.weight"].shape[0])
        i += 1
    return tuple(out)


@torch.no_grad()
def mask(weights: dict, frames: torch.Tensor, means, stds, *, int8: bool,
         precision: str = "bf16", qmax: int = 127) -> torch.Tensor:
    """Frames [n, h, w, 4] float32 (h, w multiples of 2**depth) -> the
    sigmoid mask [n, h, w, 1] float32."""
    cast = CASTS[precision]
    dev = frames.device
    widths = widths_of(weights)
    depth = len(widths)
    means = torch.as_tensor(np.asarray(means), dtype=torch.float32, device=dev)
    stds = torch.as_tensor(np.asarray(stds), dtype=torch.float32, device=dev)
    x = torch.nan_to_num(frames.float(), nan=0.0, posinf=1.0, neginf=0.0)
    x = cast((x - means) * (1.0 / (stds + 1e-8)))
    x = unshuffle(x)

    def block(x, name):
        wa, ba = fold(weights, name, "conv_a", "norm_a")
        wb, bb = fold(weights, name, "conv_b", "norm_b")
        n, c, h, w = x.shape
        r = route(c, wb.shape[0], h, w, int8)
        if r[0] == "int8":
            return cast(int8_block(x, wa, ba, wb, bb, r[1], r[2], r[3], cast, qmax))
        return cast(float_block(x, wa, ba, wb, bb, cast))

    skips = []
    for i in range(depth - 1):
        x = block(x, f"enc_{i}")
        skips.append(x)
        x = cast(pool2x(x))
    x = block(x, f"enc_{depth - 1}")
    for i, skip in enumerate(reversed(skips)):
        h, w = x.shape[2:]
        x = resize(x, interp_matrix(h, 2 * h), interp_matrix(w, 2 * w), cast)
        x = cast(block(x, f"dec_{i}") + skip)
    h, w = x.shape[2:]
    x = resize(x, chain((h, 2 * h, h)), chain((w, 2 * w, w)), cast)
    x = block(x, "dec_final")
    hw, hb = weights["head.weight"], weights["head.bias"]
    x = cast(F.conv2d(x, cast(hw)) + hb[None, :, None, None])
    return torch.sigmoid(shuffle(x))


def to_u8(m: torch.Tensor) -> torch.Tensor:
    """Mask -> uint8 codes: clip to [0, 1], NaN -> 0, round(x * 255) half to
    even."""
    m = torch.clamp(m.float(), 0.0, 1.0)
    m = torch.where(torch.isnan(m), torch.zeros_like(m), m)
    return torch.round(m * 255.0).to(torch.uint8)
