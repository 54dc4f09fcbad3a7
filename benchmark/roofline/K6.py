"""K6 ``fused_block128_nhwc``: a whole folded ConvBlock with 128 input
channels in bf16 on the tensor cores, NHWC."""

from benchmark.peaks import BF16_FLOPS, HBM_BYTES
from benchmark.roofline import esize, numel

NAMES = ("block128_tc_kernel", "block128_f32_kernel")
# where the program's forwards look up the kernel's wrapper
WRAPPERS = (
    ("pcss_unet_tpu_torch.ops.kernels.deploy", "fused_block128_nhwc"),
)


def bound_s(call) -> float:
    x, w1, b1, w2, b2 = call["args"][:5]
    n, h, w, c = x["shape"]
    cmid, cout = w1["shape"][2], w2["shape"][1]
    px = n * h * w
    e = esize(x)
    macs = px * (9 * c * cmid + cmid * cout)
    nbytes = (px * c * e + px * cout * e + (numel(w1) + numel(w2)) * e
              + 4 * (numel(b1) + numel(b2)))
    return max(2 * macs / BF16_FLOPS, nbytes / HBM_BYTES)
