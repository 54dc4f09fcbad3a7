"""Process groups for data and spatial parallelism (port of
``pcss_unet_tpu/utils/distributed.py``).

torch has no single controller: parallel training is one process per rank,
joined by ``torch.distributed``.  ``initialize_multihost()`` joins a group
from its arguments or, where they are absent, from a launcher's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``:
torchrun's names); ``host_shard_args()`` then gives the loaders this
process's shard.  The train CLI's ``--multihost`` does both.

A group of ``D·S`` ranks is a (data × spatial) grid, as the reference's
``make_mesh`` lays its devices out: rank r is cell (d, s) = (r // S, r % S)
(``grid_coords``).  The S ranks of one data index d hold the row shards of
the same samples; ``spatial_group`` joins them, and ``halo_exchange`` moves
the rows each shard needs from its neighbours over it (``gather_rows``
puts a frame back together).  With S = 1 the data index is the rank.

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


def host_shard_args(spatial: int = 1) -> dict:
    """→ {'shard_index', 'shard_count'} for per-process data sharding: the
    data index and the data axis's length of a grid with ``spatial`` row
    shards (the S ranks of a data index read the same samples)."""
    return {"shard_index": dist.get_rank() // spatial,
            "shard_count": dist.get_world_size() // spatial}


def grid_coords(group, spatial: int) -> tuple[int, int]:
    """This rank's cell (d, s) in a group laid out as a (data × ``spatial``)
    grid: (rank // spatial, rank % spatial)."""
    return divmod(dist.get_rank(group), spatial)


def spatial_group(group, spatial: int):
    """The process group of the ``spatial`` ranks that share this rank's
    data index in ``group`` (a grid, see the module docstring).  Where the
    grid has one data index that is ``group`` itself; otherwise one new
    group per data index, created in data order, so every process of the
    default group must call this, as every one calls ``new_group``."""
    world = dist.get_world_size(group)
    if world % spatial:
        raise ValueError(f"a group of {world} ranks is no grid with "
                         f"spatial={spatial} (not a multiple)")
    if world == spatial:
        return group
    ranks = dist.get_process_group_ranks(group)
    d = grid_coords(group, spatial)[0]
    mine = None
    for i in range(world // spatial):
        g = dist.new_group(ranks[i * spatial:(i + 1) * spatial],
                           backend=dist.get_backend(group))
        if i == d:
            mine = g
    return mine


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


def rank_slice(group, rows: int, spatial: int = 1) -> slice:
    """This rank's rows of a global batch of ``rows × D`` rows made of the
    data indices' equal shards in data order (D: the data axis of
    ``group``, a grid with ``spatial`` row shards per data index)."""
    d = grid_coords(group, spatial)[0]
    return slice(d * rows, (d + 1) * rows)


class _HaloExchange(torch.autograd.Function):
    """See ``halo_exchange``.  Transport: one all-reduce of a zero-filled
    buffer with a slot per shard, each shard writing its own edge rows
    (x + 0 is exact); the backward sends the halo rows' gradients back the
    same way and adds them into the edge rows they came from."""

    @staticmethod
    def _swap(group, index, count, first, last, mine):
        """All-reduce a buffer with, per shard, a slot for ``first`` (what
        goes to the shard above) and one for ``last`` (to the shard below);
        this shard fills the slots ``mine`` names: {(shard, 0 or 1):
        tensor}.  → the buffer, viewed [count, 2 slots] of flat parts."""
        n0, n1 = first.numel(), last.numel()
        buf = first.new_zeros((count, n0 + n1))
        for (k, slot), t in mine.items():
            if 0 <= k < count:
                (buf[k, :n0] if slot == 0 else buf[k, n0:]).copy_(t.reshape(-1))
        dist.all_reduce(buf, group=group)
        return buf[:, :n0], buf[:, n0:]

    @staticmethod
    def forward(ctx, x, above, below, dim, index, count, group):
        h = x.shape[dim]
        if above > h or below > h:
            raise ValueError(f"a halo of {above} / {below} rows does not fit "
                             f"in the neighbouring shard's {h} rows")
        ctx.args = (above, below, dim, index, count, group, h)
        # a shard's top `below` rows go to the shard above it (its halo
        # below), its bottom `above` rows to the shard below
        top, bot = x.narrow(dim, 0, below), x.narrow(dim, h - above, above)
        to_above, to_below = _HaloExchange._swap(
            group, index, count, top, bot, {(index, 0): top, (index, 1): bot})
        up = (to_below[index - 1] if index > 0
              else torch.zeros_like(to_below[0])).view_as(bot)
        down = (to_above[index + 1] if index < count - 1
                else torch.zeros_like(to_above[0])).view_as(top)
        return torch.cat([up, x, down], dim)

    @staticmethod
    def backward(ctx, grad):
        above, below, dim, index, count, group, h = ctx.args
        grad = grad.contiguous()
        g_up = grad.narrow(dim, 0, above)
        g_down = grad.narrow(dim, above + h, below)
        # the halo above came from shard index-1's bottom rows, the halo
        # below from shard index+1's top rows: their gradients go back there
        g_top, g_bot = _HaloExchange._swap(
            group, index, count, g_down, g_up,
            {(index + 1, 0): g_down, (index - 1, 1): g_up})
        gx = grad.narrow(dim, above, h).clone()
        gx.narrow(dim, 0, below).add_(g_top[index].view_as(g_down))
        gx.narrow(dim, h - above, above).add_(g_bot[index].view_as(g_up))
        return gx, None, None, None, None, None, None


def halo_exchange(x: torch.Tensor, above: int, below: int, rows,
                  dim: int = 2) -> torch.Tensor:
    """``x`` (this rank's row shard of a frame, rows on ``dim``) with the
    ``above`` rows of the shard above and the ``below`` rows of the shard
    below concatenated on: zeros beyond the frame's first and last row
    (SAME padding).  ``rows``: the row split (``parallel/spatial.py::
    RowShard``: its group, this shard's index, the shard count).
    Differentiable: the backward adds the halo rows' gradients into the
    neighbours' edge rows.  Every shard of the group calls it with the same
    sizes, the frame's edge shards included.  Raises ``ValueError`` where a
    halo is taller than a shard."""
    if above == 0 and below == 0:
        return x
    return _HaloExchange.apply(x, above, below, dim % x.dim(), rows.index,
                               rows.count, rows.group)


def gather_rows(x: torch.Tensor, rows, dim: int = 1) -> torch.Tensor:
    """The whole frame on every shard of ``rows.group``: each shard's ``x``
    (its rows on ``dim``) concatenated in shard order, from one all-reduce
    of a zero-filled buffer with a slot per shard, as ``halo_exchange``
    moves its rows.  Not differentiable."""
    buf = x.new_zeros((rows.count, *x.shape))
    buf[rows.index].copy_(x)
    dist.all_reduce(buf, group=rows.group)
    return torch.cat(buf.unbind(0), dim)
