"""Process groups for data parallelism (port of
``pcss_unet_tpu/utils/distributed.py``).

torch has no single controller: data parallelism is one process per rank,
joined by ``torch.distributed``.  ``initialize_multihost()`` joins a group
from its arguments or, where they are absent, from a launcher's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``:
torchrun's names); ``host_shard_args()`` then gives the loaders this
process's shard.  The train CLI's ``--multihost`` does both.

The backend follows from where the ranks' tensors are: ``nccl`` where each
rank has a card of its own, ``gloo`` on the CPU and where ranks share a card
(NCCL refuses two ranks on one card).  On CUDA tensors gloo takes only
``all_reduce`` and ``broadcast``, so the port's collectives are those two.

``all_reduce_sum`` is the differentiable all-reduce the synchronised
BatchNorm and the global loss terms use: its backward all-reduces the
gradient, so a loss that every rank computes from the same global value,
with the gradients summed over ranks and divided by the world size after,
gets the whole batch's gradient.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as dist

TIMEOUT = timedelta(minutes=30)


def backend_for(devices) -> str:
    """The backend for ranks on ``devices`` (one ``torch.device`` per
    rank): ``nccl`` iff every rank has a card of its own."""
    devices = [torch.device(d) for d in devices]
    own_cards = (all(d.type == "cuda" for d in devices)
                 and len(set(devices)) == len(devices))
    return "nccl" if own_cards else "gloo"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         backend: str = "gloo") -> None:
    """``init_process_group`` from the arguments, each one that is None read
    from the environment: ``coordinator_address`` as ``host:port``
    (``MASTER_ADDR``:``MASTER_PORT``), ``num_processes`` (``WORLD_SIZE``),
    ``process_id`` (``RANK``)."""
    env = os.environ
    needed = ((["MASTER_ADDR", "MASTER_PORT"] if coordinator_address is None else [])
              + (["WORLD_SIZE"] if num_processes is None else [])
              + (["RANK"] if process_id is None else []))
    missing = [k for k in needed if k not in env]
    if missing:
        raise ValueError(f"initialize_multihost: no argument for, and no "
                         f"{', '.join(missing)} in the environment (a "
                         "launcher such as torchrun sets them)")
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    n_local = torch.cuda.device_count()
    logging.info("multihost initialized: process %d/%d, %d local / %d "
                 "global devices", dist.get_rank(), dist.get_world_size(),
                 n_local, n_local * dist.get_world_size())


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK``, else the rank)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def host_shard_args() -> dict:
    """→ {'shard_index', 'shard_count'} for per-process data sharding."""
    return {"shard_index": dist.get_rank(), "shard_count": dist.get_world_size()}


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Σ over the group's ranks of ``t``, differentiable (see the module
    docstring); a new tensor, ``t`` is not written."""
    return _AllReduceSum.apply(t, group)


def rank_slice(group, rows: int) -> slice:
    """This rank's rows of a global batch of ``rows × world`` rows made of
    the ranks' equal shards in rank order."""
    r = dist.get_rank(group)
    return slice(r * rows, (r + 1) * rows)
