"""Device meshes (port of ``pcss_unet_tpu/parallel/mesh.py``).

Axes, as in the reference:

- ``data``: batch-dimension data parallelism.  In torch that is one process
  per rank joined by ``torch.distributed`` (``parallel/dp.py``,
  ``train/step.py``'s group step), so a training mesh's data axis lists the
  ranks' devices.
- ``spatial``: height-dimension partitioning of full frames.  The sharded
  inference (``infer/tiled.py::infer_sharded_halo``) runs one window of the
  frame per spatial index on that index's device, from one process.

A ``Mesh`` is a (data, spatial) grid of ``torch.device``s.  A device may
appear more than once: a 1×N mesh of one card runs the N windows one after
another on it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    """``devices[d][s]``: the device of data index d, spatial index s."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "spatial": len(self.devices[0])}


def _default_devices() -> list[torch.device]:
    """The visible cards, else the CPU."""
    n = torch.cuda.device_count()
    return ([torch.device("cuda", i) for i in range(n)] if n
            else [torch.device("cpu")])


def make_mesh(data_parallel: int = -1, spatial_parallel: int = 1,
              devices=None) -> Mesh:
    """A (data_parallel × spatial_parallel) grid of the first devices of
    ``devices`` (default: the visible cards); ``data_parallel = -1`` takes
    every device the spatial axis leaves.  Raises ``ValueError`` where the
    devices are too few or do not divide."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else _default_devices())]
    n = len(devices)
    if data_parallel == -1:
        if n % spatial_parallel:
            raise ValueError(
                f"{n} devices not divisible by spatial_parallel={spatial_parallel}")
        data_parallel = n // spatial_parallel
    use = data_parallel * spatial_parallel
    if use > n:
        raise ValueError(f"mesh {data_parallel}x{spatial_parallel} needs "
                         f"{use} devices, have {n}")
    grid = [tuple(devices[d * spatial_parallel:(d + 1) * spatial_parallel])
            for d in range(data_parallel)]
    return Mesh(tuple(grid))


def batch_sharding(mesh: Mesh):
    """→ ``split(x)``: a host batch [B, ...] as one block of B / data rows
    per data index, on that index's first device (the ranks' rows of the
    batch, in rank order); B must divide by the data axis."""
    n = mesh.shape["data"]

    def split(x) -> list[torch.Tensor]:
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not divide over "
                             f"data={n}")
        return [part.to(row[0]) for part, row in zip(x.chunk(n), mesh.devices)]
    return split


def replicate_sharding(mesh: Mesh):
    """→ ``copy(x)``: x on every distinct device of the mesh, by device."""
    def copy(x) -> dict[torch.device, torch.Tensor]:
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        return {d: x.to(d) for row in mesh.devices for d in row}
    return copy


def shard_train_inputs(mesh: Mesh, x, y):
    """A host batch's inputs and labels split over the data axis."""
    split = batch_sharding(mesh)
    return split(x), split(y)
