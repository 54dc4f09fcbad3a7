"""K1 ``fused_scrub_standardize``: the frame in (float32), the forward"s
first input out.  Bytes only (a handful of operations a value)."""

from benchmark.peaks import HBM_BYTES
from benchmark.roofline import numel

NAMES = ("scrub_vec_kernel", "scrub_general_kernel")
# where the program's forwards look up the kernel's wrapper
WRAPPERS = (
    ("pcss_unet_tpu_torch.infer.frame", "fused_scrub_standardize"),
)


def bound_s(call) -> float:
    x = call["args"][0]
    out_dtype = call["kwargs"].get("out_dtype") or "torch.bfloat16"
    osize = 4 if "float32" in str(out_dtype) else 2
    return numel(x) * (4 + osize) / HBM_BYTES
