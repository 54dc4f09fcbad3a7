"""K2 ``fused_conv_block_chw`` and K2' ``fused_conv_block_nhwc`` (one CUDA
kernel): a 3x3 conv, LeakyReLU, a 1x1 conv, LeakyReLU, in the input's
type with float32 sums.  Operations over the frame's true columns."""

from benchmark.peaks import BF16_FLOPS, HBM_BYTES
from benchmark.roofline import esize, numel

NAMES = ("convblock_chw_tc_kernel", "convblock_chw_kernel")
# where the program's forwards look up the kernel's wrapper
WRAPPERS = (
    ("pcss_unet_tpu_torch.infer.chw_engine", "fused_conv_block_chw"),
    ("pcss_unet_tpu_torch.models.unet", "fused_conv_block_nhwc"),
)


def bound_s(call) -> float:
    x, w1, b1, w2, b2 = call["args"][:5]
    kw = call["kwargs"]
    cmid, cin = w1["shape"][1], w1["shape"][2]
    cout = w2["shape"][0]
    e = esize(x)
    if kw.get("true_w") is not None:             # channels-major [N, C, H, Wp]
        n, _, h, wp = x["shape"]
        px, stored = n * h * kw["true_w"], n * h * wp
        res = kw.get("residual")
        extra = 0 if not isinstance(res, dict) else px * cout * e
    else:                                        # NHWC [N, H, W, C]
        n, h, w, _ = x["shape"]
        px = stored = n * h * w
        extra = 0
    macs = px * (9 * cin * cmid + cmid * cout)
    nbytes = (px * cin * e + stored * cout * e + extra
              + (numel(w1) + numel(w2)) * e + 4 * (numel(b1) + numel(b2)))
    return max(2 * macs / BF16_FLOPS, nbytes / HBM_BYTES)
