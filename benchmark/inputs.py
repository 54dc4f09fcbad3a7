"""Inputs made from the seed: network weights and renderer frames.

Everything is drawn on the run's device by one ``torch.Generator`` in a few
large calls, so set-up does not pay for thousands of small host draws, and
the same seed gives the same weights and frames.  The weights are a flat
dict of the shadow U-Net's parameter names (the reference's names:
``enc_0.conv_a.weight`` OIHW, ``enc_0.norm_a.running_mean`` ...), which
both the program (the engine through ``engine_variables``, the train state
by its state dict) and the plain reference (``benchmark/reference``) read.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def unet_layout(widths, in_ch: int = 4, out_ch: int = 1):
    """[(block, cin, cout)] of the ConvBlocks in forward order, and the
    head's (cin, cout): encoder levels, decoder levels, ``dec_final``."""
    blocks, prev = [], in_ch * 4
    for i, w in enumerate(widths):
        blocks.append((f"enc_{i}", prev, w))
        prev = w
    for i, w in enumerate(reversed(widths[:-1])):
        blocks.append((f"dec_{i}", prev, w))
        prev = w
    blocks.append(("dec_final", prev, in_ch * 4))
    return blocks, (in_ch * 4, out_ch * 4)


def _shapes(widths, in_ch, out_ch):
    blocks, (hc, ho) = unet_layout(widths, in_ch, out_ch)
    convs, norms = [], []
    for name, cin, cout in blocks:
        convs.append((f"{name}.conv_a", (cin, cin, 3, 3)))
        convs.append((f"{name}.conv_b", (cout, cin, 1, 1)))
        norms += [(f"{name}.norm_a", cin), (f"{name}.norm_b", cout)]
    convs.append(("head", (ho, hc, 1, 1)))
    return convs, norms


def _split(flat: torch.Tensor, sizes):
    return list(torch.split(flat, sizes))


def unet_weights(widths, gen: torch.Generator, device, *, style: str,
                 in_ch: int = 4, out_ch: int = 1) -> dict[str, torch.Tensor]:
    """Seeded float32 weights on ``device``.

    ``style="deploy"``: He-normal kernels (std sqrt(2 / fan_in)), biases of
    std 0.01, BatchNorm affine parameters and running statistics drawn away
    from the identity, so that folding them does real work (a trained
    deployment net's shape; no trained checkpoint of these widths exists).
    ``style="train"``: what a training run starts from: torch's own
    ``nn.Conv2d`` initialisation (uniform in +-1/sqrt(fan_in) for kernels
    and biases) and BatchNorm at the identity."""
    convs, norms = _shapes(widths, in_ch, out_ch)
    wsz = [math.prod(s) for _, s in convs]
    bsz = [s[0] for _, s in convs]
    fan = [s[1] * s[2] * s[3] for _, s in convs]
    out: dict[str, torch.Tensor] = {}
    if style == "deploy":
        ws = _split(torch.randn(sum(wsz), generator=gen, device=device), wsz)
        bs = _split(torch.randn(sum(bsz), generator=gen, device=device), bsz)
        for (name, shape), w, b, f in zip(convs, ws, bs, fan):
            out[f"{name}.weight"] = w.view(shape) * math.sqrt(2.0 / f)
            out[f"{name}.bias"] = b * 0.01
    elif style == "train":
        ws = _split(torch.rand(sum(wsz), generator=gen, device=device), wsz)
        bs = _split(torch.rand(sum(bsz), generator=gen, device=device), bsz)
        for (name, shape), w, b, f in zip(convs, ws, bs, fan):
            bound = 1.0 / math.sqrt(f)
            out[f"{name}.weight"] = (w.view(shape) * 2 - 1) * bound
            out[f"{name}.bias"] = (b * 2 - 1) * bound
    else:
        raise ValueError(f"unknown weight style {style!r}")
    nsz = [c for _, c in norms]
    total = sum(nsz)
    if style == "deploy":
        u = torch.rand(2 * total, generator=gen, device=device)
        g = torch.randn(2 * total, generator=gen, device=device)
        cols = zip(_split(0.5 + u[:total], nsz), _split(0.1 * g[:total], nsz),
                   _split(0.1 * g[total:], nsz), _split(0.5 + u[total:], nsz))
    else:
        ones = torch.ones(total, device=device)
        zeros = torch.zeros(total, device=device)
        cols = zip(_split(ones, nsz), _split(zeros, nsz), _split(zeros, nsz),
                   _split(ones, nsz))
    for (name, _), (scale, bias, mean, var) in zip(norms, cols):
        out[f"{name}.weight"] = scale
        out[f"{name}.bias"] = bias
        out[f"{name}.running_mean"] = mean
        out[f"{name}.running_var"] = var
    return out


def vgg_weights(gen: torch.Generator, device, convs) -> dict:
    """Seeded VGG-19 tower weights (no ImageNet weights are available
    offline): normal kernels of std sqrt(1 / fan_in), zero biases, drawn in
    one call on ``device``.  ``convs``: [(index, cin, cout)].  →
    ``{"conv_<i>": {"weight": OIHW, "bias"}}`` on ``device``."""
    sizes = [9 * cin * cout for _, cin, cout in convs]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (idx, cin, cout), w in zip(convs, _split(flat, sizes)):
        k = (w.view(cout, cin, 3, 3) * math.sqrt(1.0 / (9 * cin)))
        out[f"conv_{idx}"] = {"weight": k, "bias": torch.zeros(cout, device=device)}
    return out


def engine_variables(weights: dict[str, torch.Tensor], widths) -> dict:
    """The flat weights as the inference engine takes them: the JAX
    layout (``{"params", "batch_stats"}``, HWIO kernels, numpy leaves),
    copied to the host in one transfer."""
    names = list(weights)
    flat = torch.cat([weights[n].reshape(-1) for n in names]).cpu().numpy()
    host, i = {}, 0
    for n in names:
        k = weights[n].numel()
        host[n] = flat[i:i + k].reshape(tuple(weights[n].shape))
        i += k
    blocks, _ = unet_layout(widths)
    params, stats = {}, {}
    for name, _, _ in blocks:
        params[name], stats[name] = {}, {}
        for conv in ("conv_a", "conv_b"):
            params[name][conv] = {
                "kernel": np.ascontiguousarray(host[f"{name}.{conv}.weight"].transpose(2, 3, 1, 0)),
                "bias": host[f"{name}.{conv}.bias"]}
        for norm in ("norm_a", "norm_b"):
            params[name][norm] = {"scale": host[f"{name}.{norm}.weight"],
                                  "bias": host[f"{name}.{norm}.bias"]}
            stats[name][norm] = {"mean": host[f"{name}.{norm}.running_mean"],
                                 "var": host[f"{name}.{norm}.running_var"]}
    params["head"] = {"kernel": np.ascontiguousarray(host["head.weight"].transpose(2, 3, 1, 0)),
                      "bias": host["head.bias"]}
    return {"params": params, "batch_stats": stats}


def gbuffer_frames(n: int, h: int, w: int, gen: torch.Generator, device,
                   first: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` renderer-plausible G-buffer frames [n, h, w, 4] and their
    learnable soft shadows [n, h, w, 1], float32 on ``device``.

    The frame of index i: smooth fields (``sin(x / (40 + i) + i) · cos(y /
    (60 + i))``), a little noise from ``gen``, a horizontal ramp and a
    constant channel; its shadow is a sigmoid of a smooth function of the
    channels.  A copy of the program's smoke test's ``gbuffer``
    (``chip_smoke.py``), drawn on the device."""
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    noise = torch.randn((n, 2, h, w), generator=gen, device=device)
    x = torch.empty((n, h, w, 4), device=device)
    for k in range(n):
        i = float(first + k)
        base = torch.sin(xx / (40 + i) + i) * torch.cos(yy / (60 + i))
        x[k, ..., 0] = base + 0.05 * noise[k, 0]
        x[k, ..., 1] = base * 0.5 + 0.3
        x[k, ..., 2] = xx / w + 0.02 * noise[k, 1]
        x[k, ..., 3] = 1.0
    y = torch.sigmoid(6.0 * (x[..., 0] - x[..., 2] + 0.25))[..., None]
    return x, y


def channel_stats(frames: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel mean and standard deviation of NHWC frames, in float64,
    as the ``stats`` step of the data pipeline writes them (the train
    split's standardization)."""
    f = frames.double().reshape(-1, frames.shape[-1])
    mean = f.mean(0)
    std = f.std(0, correction=0)
    both = torch.stack([mean, std]).cpu().numpy().astype(np.float32)
    return both[0], both[1]
