"""K6 ``fused_block128_nhwc``: a whole folded ConvBlock on NHWC for the
128-channel stages (port of ``pcss_unet_tpu/ops/pallas/convblock128.py``;
CUDA in ``csrc/convblock128.cu``).

    out = leaky(cast(leaky(conv3×3_SAME(x, W1) + b1)) · W2 + b2)

on ``x [N, H, W, C]`` with ``C % 128 == 0``, ``Cin == Cmid`` and
``Cout ≤ Cmid``: products of the storage dtype's values summed in float32,
the hidden value rounded to x's dtype before the 1×1 (on the TPU; the
reference's interpret mode computes in float32, so the CPU tests compare at
float32, where both agree).  The output does not depend on the reference's
band height, so the port takes none; :func:`pick_k_rows_128` is copied
because the model's gate asks it whether the reference would take a stage.

On the card x is read in the storage it has: the NHWC model hands over an
NHWC view of channels-major storage, which the bf16 kernel stages in place
(:func:`_storage`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pcss_unet_tpu_torch.ops.kernels import _build

_MAX_SMEM = 232448   # bytes of shared memory one block can use on the H100
MAX_C = 384          # the widest C whose plan fits, on either card kernel
# storage modes of the bf16 kernel (csrc/convblock128.cu, enum Mode)
NHWC, CMAJOR_VEC, CMAJOR_SCALAR = 0, 1, 2


def pick_k_rows_128(h: int, w: int, c: int, cout: int) -> int | None:
    """The reference's band height for its TPU VMEM budget (a copy), or
    None if the shape doesn't meet its constraints."""
    if c % 128 or cout % 64:
        return None
    budget = 14 * 1024 * 1024
    for k in (8, 4, 2):
        if h % k or (k * w) % 16:
            continue
        bands = 3 * 2 * k * w * c * 2
        ext = (k + 2) * w * c * 2
        taps = 2 * k * w * c * 2
        acc = k * w * c * 4
        hbuf = k * w * c * 2
        acc2 = k * w * cout * 4
        out = 2 * k * w * cout * 2
        wgt = (9 * c * c + c * cout) * 2
        if bands + ext + taps + acc + hbuf + acc2 + out + wgt <= budget:
            return k
    return None


def pack_block128_params(params: dict, dtype: torch.dtype = torch.bfloat16,
                         device: str | torch.device = "cpu"):
    """Folded ConvBlock params (HWIO) → ``w1 [9, C, C]`` (tap dy·3+dx) and
    ``w2 [C, Cout]`` in ``dtype``, ``b1 [C]`` and ``b2 [Cout]`` float32."""
    ka = np.asarray(params["conv_a"]["kernel"], np.float32)      # [3,3,C,C]
    kb = np.asarray(params["conv_b"]["kernel"], np.float32)      # [1,1,C,Cout]

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)

    return (t(ka.reshape(9, ka.shape[2], ka.shape[3]), dtype),
            t(np.asarray(params["conv_a"]["bias"], np.float32), torch.float32),
            t(kb[0, 0], dtype),
            t(np.asarray(params["conv_b"]["bias"], np.float32), torch.float32))


def _leaky(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v >= 0, v, v * slope)


def block128_nhwc_plain(x, w1, b1, w2, b2, *,
                        negative_slope: float = 0.2) -> torch.Tensor:
    """Plain version of the kernel: same cast points, float32 sums."""
    dtype = x.dtype
    c, cmid = w1.shape[1], w1.shape[2]
    k = w1.to(dtype).float().reshape(3, 3, c, cmid).permute(3, 2, 0, 1)
    hid = F.conv2d(x.float().permute(0, 3, 1, 2), k, padding=1)
    hid = _leaky(hid + b1.float().reshape(1, cmid, 1, 1), negative_slope)
    hid = hid.to(dtype).float()
    out = torch.einsum("nmhw,mo->nhwo", hid, w2.to(dtype).float())
    return _leaky(out + b2.float(), negative_slope).to(dtype)


def smem_plan(c: int, cout: int) -> tuple[int, int]:
    """The bf16 kernel's shared-memory plan (a mirror of
    ``csrc/convblock128.cu::plan128``) as ``(kc, bytes)``: the input chunk
    ``kc`` (128 when the whole plan fits, else 64) and the bytes of region 0
    (the x stage ``[3][130][kc + 8]``, later the float32 output tile
    ``[min(Cout16, 128)][132]``), two weight slices ``[128][kc + 8]`` and
    the hidden tile ``[128][C + 8]``, all bf16 but the output tile."""
    out_tile = min(-(-cout // 16) * 16, 128) * 132 * 4
    hid = 128 * (c + 8) * 2
    for kc in (128, 64):
        nbytes = max(3 * 130 * (kc + 8) * 2, out_tile) + 2 * 128 * (kc + 8) * 2 + hid
        if nbytes <= _MAX_SMEM:
            break
    return kc, nbytes


def _storage(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The tensor the bf16 kernel reads and its storage mode.  Channels-major
    storage (the NHWC view of NCHW that the model hands over) goes in place:
    16-byte reads along W where ``W % 8 == 0`` and x is 16-byte aligned,
    else element by element.  Any other storage goes channels-last, copied
    only where it is not already contiguous and aligned."""
    if x.permute(0, 3, 1, 2).is_contiguous():
        vec = x.shape[2] % 8 == 0 and x.data_ptr() % 16 == 0
        return x, CMAJOR_VEC if vec else CMAJOR_SCALAR
    return _build.aligned(x), NHWC


def pack_tc_weights(w1: torch.Tensor, w2: torch.Tensor, kc: int):
    """``w1 [9, C, C]``, ``w2 [C, Cout]`` → the bf16 kernel's B slices, in
    the order it takes them: ``w1p [C/128, C/kc, 9, 128, kc]`` (hidden block,
    input chunk, tap; each slice [hidden][input]) and ``w2p [C/kc, Cout16,
    kc]`` ([output][hidden] per hidden chunk, rows past Cout zero)."""
    c, cout = w2.shape
    op = -(-cout // 16) * 16
    w1p = (w1.to(torch.bfloat16).permute(0, 2, 1)
           .reshape(9, c // 128, 128, c // kc, kc).permute(1, 3, 0, 2, 4))
    w2t = w2.to(torch.bfloat16).t()
    w2p = w2t.new_zeros((op, c))
    w2p[:cout] = w2t
    return (_build.aligned(w1p),
            _build.aligned(w2p.reshape(op, c // kc, kc).permute(1, 0, 2)))


def _launch(x, w1, b1, w2, b2, negative_slope: float, stream) -> torch.Tensor:
    """Check the card kernels' limits, lay out the operands and launch."""
    n, h, w, c = x.shape
    cout = w2.shape[1]
    if cout % 4 or c > MAX_C:
        raise ValueError(f"kernel takes Cout % 4 == 0 and C ≤ {MAX_C} (the "
                         f"hidden tile [128, C] stays in shared memory); got "
                         f"C={c}, Cout={cout}")
    b1f = b1.float().reshape(-1).contiguous()
    b2f = b2.float().reshape(-1).contiguous()
    if x.dtype == torch.bfloat16:
        x, mode = _storage(x)
        w1k, w2k = pack_tc_weights(w1, w2, smem_plan(c, cout)[0])
    else:
        # CUDA-core kernel: channels-last float32, weights as given
        x, mode = x.contiguous(), NHWC
        w1k = _build.aligned(w1.to(x.dtype))                      # [9, C, C]
        w2k = _build.aligned(w2.to(x.dtype))                      # [C, Cout]
    if mode == NHWC:
        out = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    else:
        out = torch.empty((n, cout, h, w), dtype=x.dtype,
                          device=x.device).permute(0, 2, 3, 1)
    _build.check_extent(x, out)
    _build.call("pcss_block128_nhwc", x.data_ptr(), w1k.data_ptr(),
                b1f.data_ptr(), w2k.data_ptr(), b2f.data_ptr(), out.data_ptr(),
                n, c, cout, h, w, float(negative_slope),
                int(x.dtype == torch.bfloat16), mode, stream)
    return out


@_build.on_device
def fused_block128_nhwc(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor, *,
                        negative_slope: float = 0.2) -> torch.Tensor:
    """x [N,H,W,C] bf16/f32, w1 [9,C,C] (tap dy·3+dx), b1 [C] f32,
    w2 [C,Cout], b2 [Cout] f32 → [N,H,W,Cout] in x's dtype; weights are
    used in x's dtype.

    The CPU takes the plain version, for any ``C % 128 == 0``.  On the card
    both kernels take ``C ≤ 384`` (``MAX_C``) and ``Cout % 4 == 0``, and
    raise ``ValueError`` otherwise.  bfloat16 runs the tensor-core kernel on
    x's storage as it is (no copy of an NHWC view of channels-major storage,
    nor of a contiguous aligned NHWC tensor) and returns the output in the
    same storage order; float32 runs the CUDA-core kernel on a channels-last
    copy (tensor cores would mean TF32) and returns channels-last."""
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, C], got {tuple(x.shape)}")
    n, h, w, c = x.shape
    cout = w2.shape[1] if w2.dim() == 2 else -1
    if (c % 128 or tuple(w1.shape) != (9, c, c) or tuple(w2.shape) != (c, cout)
            or cout > c or b1.numel() != c or b2.numel() != cout):
        raise ValueError(f"bad shapes: x {tuple(x.shape)} (C % 128 == 0), "
                         f"w1 {tuple(w1.shape)} (9, C, C), w2 "
                         f"{tuple(w2.shape)} (C, Cout ≤ C), b1 "
                         f"{tuple(b1.shape)}, b2 {tuple(b2.shape)}")
    if x.device.type == "cpu":
        return block128_nhwc_plain(x, w1, b1, w2, b2,
                                   negative_slope=negative_slope)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel takes bfloat16 or float32, got {x.dtype}")
    _build.check_device(x, w1, b1, w2, b2)
    out = _launch(x, w1, b1, w2, b2, negative_slope,
                  torch.cuda.current_stream(x.device).cuda_stream)
    fused_block128_nhwc.launches += 1
    return out


fused_block128_nhwc.launches = 0
