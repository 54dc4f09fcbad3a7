"""Meshes and data parallelism (port of ``pcss_unet_tpu/parallel``)."""

from pcss_unet_tpu_torch.parallel.mesh import (Mesh, batch_sharding,
                                               make_mesh, replicate_sharding,
                                               shard_train_inputs)

__all__ = ["Mesh", "batch_sharding", "make_mesh", "replicate_sharding",
           "shard_train_inputs"]
