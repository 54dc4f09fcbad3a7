"""Inference: the frame engine, the channels-major deployment forward and
halo-tiled inference."""

from pcss_unet_tpu_torch.infer.frame import (InferenceEngine, load_variables,
                                             pad_to_multiple)
from pcss_unet_tpu_torch.infer.tiled import infer_tiled

__all__ = ["InferenceEngine", "infer_tiled", "load_variables",
           "pad_to_multiple"]
