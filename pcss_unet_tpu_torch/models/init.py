"""Seeded variables for a UNet of any widths, for runs that need a network
of a given size and no trained checkpoint (the counterpart of the
reference's ``UNet.init``).

The tree has the JAX package's layout (``{'params', 'batch_stats'}``, numpy
float32 leaves, HWIO kernels, the reference's block names), so it goes
through ``fold_batchnorm``, ``from_flax_variables`` and the engines like a
loaded checkpoint.  Conv kernels are He-normal (std √(2 / fan_in)), biases
small; BatchNorm affine parameters and running statistics are drawn away
from the identity, so that folding them does real work.  The numbers come
from an explicit ``torch.Generator`` seeded with ``seed`` (the reference's
``jax.random`` gives other numbers from the same seed).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def seeded_variables(encoder_widths: Sequence[int] = (64, 128, 512, 1024), *,
                     in_ch: int = 4, out_ch: int = 1, seed: int = 0) -> dict:
    """Variables of the UNet with these widths (eval-ready, batch_norm)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return (torch.randn(shape, generator=gen) * std).numpy()

    def uniform(n, lo, hi):
        return (lo + (hi - lo) * torch.rand(n, generator=gen)).numpy()

    def conv(k, cin, cout):
        return {"kernel": normal((k, k, cin, cout), math.sqrt(2.0 / (k * k * cin))),
                "bias": normal((cout,), 0.01)}

    def norm(c):
        return ({"scale": uniform(c, 0.5, 1.5), "bias": normal((c,), 0.1)},
                {"mean": normal((c,), 0.1), "var": uniform(c, 0.5, 1.5)})

    params: dict = {}
    stats: dict = {}

    def block(name, cin, features):
        (pa, sa), (pb, sb) = norm(cin), norm(features)
        params[name] = {"conv_a": conv(3, cin, cin), "norm_a": pa,
                        "conv_b": conv(1, cin, features), "norm_b": pb}
        stats[name] = {"norm_a": sa, "norm_b": sb}

    widths = tuple(encoder_widths)
    prev = in_ch * 4
    for i, width in enumerate(widths):
        block(f"enc_{i}", prev, width)
        prev = width
    for i, width in enumerate(reversed(widths[:-1])):
        block(f"dec_{i}", prev, width)
        prev = width
    block("dec_final", prev, in_ch * 4)
    params["head"] = conv(1, in_ch * 4, out_ch * 4)
    return {"params": params, "batch_stats": stats}


def init_train_weights(model: torch.nn.Module,
                       generator: torch.Generator) -> torch.nn.Module:
    """Fresh trainable weights for ``model``, drawn from ``generator`` (on
    the CPU): each conv as torch's ``nn.Conv2d`` initializes it (Kaiming-
    uniform kernels with a = √5, uniform biases in ±1/√fan_in, the
    reference's own init), BatchNorm at identity (scale 1, bias 0, running
    mean 0, variance 1).  The reference's flax init draws other numbers."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                bound = 1.0 / math.sqrt(fan_in)     # kaiming_uniform(a=√5)
                m.weight.copy_((torch.rand(m.weight.shape, generator=generator)
                                * 2 - 1) * bound)
                m.bias.copy_((torch.rand(m.bias.shape, generator=generator)
                              * 2 - 1) * bound)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.reset_parameters()
    return model
