"""K5 ``fused_block_int8_kchunked``: a whole folded ConvBlock in int8 (a 3x3 and a 1x1 on the
int8 tensor cores, per-band activation scales), NHWC."""

from benchmark.peaks import HBM_BYTES, INT8_OPS
from benchmark.roofline import esize, numel

NAMES = ("rowmax_kernel", "int8_taps_kernel")
# where the program's forwards look up the kernel's wrapper
WRAPPERS = (
    ("pcss_unet_tpu_torch.ops.kernels.deploy", "fused_block_int8_kchunked"),
)


def bound_s(call) -> float:
    x, w1q, s1, b1, w2q, s2, b2 = call["args"][:7]
    n, h, w, c = x["shape"]
    cmid, cout = w1q["shape"][2], w2q["shape"][1]
    px = n * h * w
    macs = px * (9 * c * cmid + cmid * cout)
    nbytes = (px * c * esize(x) + px * cout * esize(x) + numel(w1q) + numel(w2q)
              + 4 * (numel(s1) + numel(b1) + numel(s2) + numel(b2)))
    return max(2 * macs / INT8_OPS, nbytes / HBM_BYTES)
