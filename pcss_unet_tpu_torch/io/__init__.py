"""EXR and PNG IO (port of ``pcss_unet_tpu/io``)."""

from pcss_unet_tpu_torch.io.exr import read_exr, read_exr_stack, write_exr
from pcss_unet_tpu_torch.io.png import read_label_png, write_mask_png

__all__ = ["read_exr", "read_exr_stack", "write_exr", "read_label_png",
           "write_mask_png"]
