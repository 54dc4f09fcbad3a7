"""K4 ``fused_mask_to_u8``: the float32 mask in, uint8 codes out."""

from benchmark.peaks import HBM_BYTES
from benchmark.roofline import numel

NAMES = ("mask_to_u8_kernel",)
# where the program's forwards look up the kernel's wrapper
WRAPPERS = (
    ("pcss_unet_tpu_torch.infer.frame", "fused_mask_to_u8"),
)


def bound_s(call) -> float:
    return numel(call["args"][0]) * (4 + 1) / HBM_BYTES
