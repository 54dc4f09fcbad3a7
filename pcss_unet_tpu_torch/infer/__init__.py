"""Inference: the frame engine, the channels-major deployment forward,
spatially sharded and halo-tiled inference, the streaming server and the export of the plain
graph."""

from pcss_unet_tpu_torch.infer.export import (export_inference, load_exported,
                                              save_exported)
from pcss_unet_tpu_torch.infer.frame import (InferenceEngine, load_variables,
                                             pad_to_multiple)
from pcss_unet_tpu_torch.infer.server import ServerStats, ShadowServer
from pcss_unet_tpu_torch.infer.tiled import (infer_sharded,
                                             infer_sharded_halo, infer_tiled)

__all__ = ["InferenceEngine", "ServerStats", "ShadowServer", "export_inference",
           "infer_sharded", "infer_sharded_halo", "infer_tiled", "load_exported", "load_variables", "pad_to_multiple",
           "save_exported"]
