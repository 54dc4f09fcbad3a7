"""K1 ``fused_scrub_standardize`` and K4 ``fused_mask_to_u8``: the passes
that bracket every inference call (port of
``pcss_unet_tpu/ops/pallas/fused.py``; CUDA in ``csrc/fused.cu``).

Each wrapper runs its CUDA kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor, and counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import torch

from pcss_unet_tpu_torch.ops.kernels import _build


def scrub_standardize_plain(x: torch.Tensor, means: torch.Tensor,
                            stds: torch.Tensor,
                            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """NaN→0, +Inf→1, −Inf→0, then ``(x − mean) · inv_std`` with
    ``inv_std = 1/(std + 1e-8)`` in float32 (a multiply, as the kernel)."""
    x = torch.nan_to_num(x.float(), nan=0.0, posinf=1.0, neginf=0.0)
    inv_std = 1.0 / (stds.float() + 1e-8)
    return ((x - means.float()) * inv_std).to(out_dtype)


def fused_scrub_standardize(x: torch.Tensor, means: torch.Tensor,
                            stds: torch.Tensor,
                            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x [N, H, W, C] float32 → scrubbed, standardized [N, H, W, C] in
    ``out_dtype`` (float32 or bfloat16)."""
    if x.dim() != 4 or means.shape != (x.shape[-1],) or stds.shape != means.shape:
        raise ValueError(f"need x [N,H,W,C] and means/stds [C]; got "
                         f"{tuple(x.shape)}, {tuple(means.shape)}, {tuple(stds.shape)}")
    if x.device.type == "cpu":
        return scrub_standardize_plain(x, means, stds, out_dtype)
    if x.dtype != torch.float32 or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel takes float32 in, float32/bfloat16 out; got "
                         f"{x.dtype} → {out_dtype}")
    _build.check_device(x, means, stds)
    x = _build.aligned(x)
    mean = means.float().contiguous()
    inv_std = (1.0 / (stds.float() + 1e-8)).contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    _build.call("pcss_scrub_standardize", x.data_ptr(), mean.data_ptr(),
                inv_std.data_ptr(), out.data_ptr(), x.numel(), x.shape[-1],
                int(out_dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    fused_scrub_standardize.launches += 1
    return out


fused_scrub_standardize.launches = 0


def mask_to_u8_plain(x: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 1], NaN→0, ``round(x·255)`` half to even, uint8."""
    x = torch.clamp(x.float(), 0.0, 1.0)
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return torch.round(x * 255.0).to(torch.uint8)


def fused_mask_to_u8(x: torch.Tensor) -> torch.Tensor:
    """Serving-path quantization: float mask [N, H, W, 1] → uint8 ×255."""
    if x.device.type == "cpu":
        return mask_to_u8_plain(x)
    if x.dtype != torch.float32:
        raise ValueError(f"kernel takes a float32 mask, got {x.dtype}")
    x = _build.aligned(x)
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    _build.call("pcss_mask_to_u8", x.data_ptr(), out.data_ptr(), x.numel(),
                torch.cuda.current_stream(x.device).cuda_stream)
    fused_mask_to_u8.launches += 1
    return out


fused_mask_to_u8.launches = 0
