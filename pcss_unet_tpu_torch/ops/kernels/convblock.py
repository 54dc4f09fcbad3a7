"""K2 ``fused_conv_block_chw``: a whole folded ConvBlock on the
channels-major layout (port of ``pcss_unet_tpu/ops/pallas/convblock.py``;
CUDA in ``csrc/convblock.cu``).

    out = leaky(W2 · cast(leaky(conv3×3_SAME(x, W1) + b1)) + b2)
    then + residual (float32), then columns ≥ true_w zeroed, then cast

on ``x [N, Cin, H, Wp]`` with ``Wp % 128 == 0`` and zero pad columns.  The
reference's tap strategies (``stack``, ``acc_shift``, ``chunk128``,
``loop``, ``rowpack``) only reorder the float32 sum; the wrapper validates
the name and one kernel serves them all.  The output does not depend on the
reference's band height ``k_rows``, so the port takes none.

K2′ ``fused_conv_block_nhwc`` is the reference's NHWC wrapper around the
same kernel: pad W to the lane multiple and H to the band multiple, go
channels-major, run K2, come back and crop.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pcss_unet_tpu_torch.ops.kernels import _build

TAP_STRATEGIES = ("stack", "acc_shift", "chunk128", "loop", "rowpack")


def pack_convblock_params(params: dict, dtype: torch.dtype = torch.bfloat16,
                          device: str | torch.device = "cpu"):
    """Folded ConvBlock params (HWIO, numpy or tensors) → kernel operands
    ``w1 [9, Cmid, Cin]`` (tap dy·3+dx) and ``w2 [Cout, Cmid]`` in
    ``dtype``, ``b1 [Cmid, 1]`` and ``b2 [Cout, 1]`` in float32."""
    ka = np.asarray(params["conv_a"]["kernel"], np.float32)      # HWIO
    kb = np.asarray(params["conv_b"]["kernel"], np.float32)
    w1 = ka.transpose(0, 1, 3, 2).reshape(9, ka.shape[3], ka.shape[2])
    b1 = np.asarray(params["conv_a"]["bias"], np.float32)[:, None]
    b2 = np.asarray(params["conv_b"]["bias"], np.float32)[:, None]

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)

    return t(w1, dtype), t(b1, torch.float32), t(kb[0, 0].T, dtype), t(b2, torch.float32)


def _leaky(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v >= 0, v, v * slope)


def conv_block_chw_plain(x, w1, b1, w2, b2, *, negative_slope: float = 0.2,
                         true_w: int | None = None,
                         residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the kernel: same cast points, float32 sums."""
    dtype = x.dtype
    n, cin, h, wp = x.shape
    cmid, cout = w1.shape[1], w2.shape[0]
    k = w1.to(dtype).float().reshape(3, 3, cmid, cin).permute(2, 3, 0, 1)
    hid = F.conv2d(x.float(), k, padding=1) + b1.float().reshape(1, cmid, 1, 1)
    hid = _leaky(hid, negative_slope).to(dtype).float()
    out = torch.einsum("om,nmhw->nohw", w2.to(dtype).float(), hid)
    out = _leaky(out + b2.float().reshape(1, cout, 1, 1), negative_slope)
    if residual is not None:
        out = out + residual.float()
    if true_w is not None:
        out[..., true_w:] = 0.0
    return out.to(dtype)


@_build.on_device
def fused_conv_block_chw(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor, *,
                         negative_slope: float = 0.2, taps: str = "stack",
                         true_w: int | None = None,
                         residual: torch.Tensor | None = None) -> torch.Tensor:
    """x [N, Cin, H, Wp] → [N, Cout, H, Wp] in x's dtype.

    w1 [9, Cmid, Cin] (tap dy·3+dx), b1 [Cmid, 1], w2 [Cout, Cmid],
    b2 [Cout, 1]; weights are used in x's dtype.  ``true_w`` zeroes the
    output columns ≥ true_w (the next block's zero-pad contract);
    ``residual [N, Cout, H, Wp]`` is added in float32 before that.

    On the card the dtype picks the kernel: bfloat16 runs the tensor-core
    kernel on the bf16 weights as given, float32 the CUDA-core kernel on
    float32 copies transposed for it (tensor cores would mean TF32).  Both
    card kernels take Cin, Cmid, Cout ≤ 128 and Cmid, Cout % 4 == 0 and
    raise ``ValueError`` otherwise; the CPU's plain version takes any
    channel counts, as the reference does."""
    if taps not in TAP_STRATEGIES:
        raise ValueError(f"unknown tap strategy {taps!r}; expected one of "
                         f"{TAP_STRATEGIES}")
    if x.dim() != 4:
        raise ValueError(f"x must be [N, Cin, H, Wp], got {tuple(x.shape)}")
    n, cin, h, wp = x.shape
    cmid, cout = w1.shape[1], w2.shape[0]
    if (wp % 128 or tuple(w1.shape) != (9, cmid, cin)
            or tuple(w2.shape) != (cout, cmid) or b1.numel() != cmid
            or b2.numel() != cout):
        raise ValueError(f"bad shapes: x {tuple(x.shape)} (Wp % 128 == 0), "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}, "
                         f"b1 {tuple(b1.shape)}, b2 {tuple(b2.shape)}")
    if residual is not None and tuple(residual.shape) != (n, cout, h, wp):
        raise ValueError(f"residual must be {(n, cout, h, wp)}, got "
                         f"{tuple(residual.shape)}")
    if true_w is not None and not 0 < true_w <= wp:
        raise ValueError(f"true_w must be in (0, {wp}], got {true_w}")
    if x.device.type == "cpu":
        return conv_block_chw_plain(x, w1, b1, w2, b2,
                                    negative_slope=negative_slope,
                                    true_w=true_w, residual=residual)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel takes bfloat16 or float32, got {x.dtype}")
    _build.check_device(x, w1, b1, w2, b2, residual)
    if max(cin, cmid, cout) > 128 or cmid % 4 or cout % 4:
        raise ValueError(f"kernel takes Cin, Cmid, Cout <= 128 and Cmid, Cout "
                         f"% 4 == 0; got {cin}, {cmid}, {cout}")
    x = _build.aligned(x)
    if x.dtype == torch.bfloat16:
        # tensor-core kernel: the packed bf16 weights as they are
        w1k, w2k = _build.aligned(w1.to(x.dtype)), _build.aligned(w2.to(x.dtype))
    else:
        # CUDA-core kernel: float32 weights transposed for its float4 reads
        w1k = w1.float().permute(0, 2, 1).contiguous()   # [9, Cin, Cmid]
        w2k = w2.float().t().contiguous()                 # [Cmid, Cout]
    b1f = b1.float().reshape(-1).contiguous()
    b2f = b2.float().reshape(-1).contiguous()
    res = None if residual is None else _build.aligned(residual.to(x.dtype))
    out = torch.empty((n, cout, h, wp), dtype=x.dtype, device=x.device)
    _build.check_extent(x, out, residual)
    _build.call("pcss_convblock_chw", x.data_ptr(), w1k.data_ptr(),
                b1f.data_ptr(), w2k.data_ptr(), b2f.data_ptr(),
                None if res is None else res.data_ptr(), out.data_ptr(),
                n, cin, cmid, cout, h, wp, wp if true_w is None else true_w,
                float(negative_slope), int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    fused_conv_block_chw.launches += 1
    return out


fused_conv_block_chw.launches = 0


# ------------------------------------------------- K2′: the NHWC wrapper


def _pick_k_rows(cin: int, cmid: int, cout: int, wp: int, itemsize: int = 2,
                 acc_shift: bool = False, has_residual: bool = False) -> int:
    """The reference's band height for its TPU VMEM budget (a copy).  The
    NHWC wrapper pads H to a multiple of it; the output does not depend on
    it (the pad rows are zero, as SAME padding reads them)."""
    budget = 14 * 1024 * 1024
    n_acc = 3 if acc_shift else 1
    for k in (32, 16, 8, 4, 2, 1):
        band = 3 * 2 * cin * k * wp * itemsize
        ext = cin * (k + 2) * wp * itemsize
        mid = cmid * k * wp * (n_acc * 4 + itemsize)
        out = cout * k * wp * (4 + 2 * itemsize)
        if has_residual:
            out += cout * k * wp * 2 * itemsize
        if band + ext + mid + out <= budget:
            return k
    return 1


def _nhwc_call(x, w1, w2, k_rows, taps, block):
    """Pad W to the lane multiple and H to the band multiple, go
    channels-major, run ``block`` on that, come back and crop.  The permutes
    are views: a channels-major caller's tensor reaches ``block`` with one
    padded copy and no transpose."""
    n, h, w, cin = x.shape
    wp = (w // 128 + 1) * 128
    if k_rows is None:
        k_rows = _pick_k_rows(cin, w1.shape[1], w2.shape[0], wp,
                              itemsize=x.element_size(),
                              acc_shift=taps == "acc_shift")
    hp = -(-h // k_rows) * k_rows
    xc = F.pad(x.permute(0, 3, 1, 2), (0, wp - w, 0, hp - h))
    return block(xc).permute(0, 2, 3, 1)[:, :h, :w]


def conv_block_nhwc_plain(x, w1, b1, w2, b2, *, k_rows: int | None = None,
                          negative_slope: float = 0.2) -> torch.Tensor:
    """Plain version of the NHWC wrapper: the same padding around
    :func:`conv_block_chw_plain`."""
    return _nhwc_call(x, w1, w2, k_rows, "stack", lambda xc: conv_block_chw_plain(
        xc, w1, b1, w2, b2, negative_slope=negative_slope))


def fused_conv_block_nhwc(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor, *,
                          k_rows: int | None = None,
                          negative_slope: float = 0.2,
                          taps: str = "stack") -> torch.Tensor:
    """NHWC wrapper of K2: x [N,H,W,Cin] → [N,H,W,Cout] (a view of the
    kernel's channels-major output).  Operands as
    :func:`fused_conv_block_chw`; ``k_rows=None`` takes the reference's
    pick."""
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, Cin], got {tuple(x.shape)}")
    out = _nhwc_call(x, w1, w2, k_rows, taps, lambda xc: fused_conv_block_chw(
        xc, w1, b1, w2, b2, negative_slope=negative_slope, taps=taps))
    if x.device.type != "cpu":
        fused_conv_block_nhwc.launches += 1
    return out


fused_conv_block_nhwc.launches = 0
