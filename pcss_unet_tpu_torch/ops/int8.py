"""Symmetric int8 quantization (port of ``pcss_unet_tpu/ops/int8.py``).

Activations get one per-tensor scale ``max|x|/127 + 1e-12``; conv weights
one scale per output channel.  Values round half to even
(``torch.round``) and clip to ±127, as ``jnp.round`` does in the
reference.
"""

from __future__ import annotations

import torch


def div_ieee(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as a true division on every device.  PyTorch divides a CUDA
    tensor by a Python scalar as a multiply by the scalar's reciprocal,
    which can differ in the last bit and move an int8 rounding tie.  The
    divisor is filled on the device: a tensor made from a host number would
    be a copy that makes the host wait for the device."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def quantize_tensor_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: → (q [int8], scale [] float32)."""
    scale = div_ieee(x.abs().max().float(), 127.0) + 1e-12
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_kernel_int8(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 for an HWIO conv kernel:
    → (q [kh,kw,Cin,Cout] int8, scales [Cout] float32)."""
    scales = div_ieee(kernel.abs().amax(dim=(0, 1, 2)).float(), 127.0) + 1e-12
    q = torch.clamp(torch.round(kernel.float() / scales), -127, 127).to(torch.int8)
    return q, scales
