"""Rank layout and the two collectives of tensor parallelism.

The counterpart of llama_cu_awq_tpu/parallel/mesh.py. Where JAX runs one
program over a Mesh of devices (shard_map), the port runs one process per
shard: a rank of torch.distributed. The world's ranks are laid out as a
(dp, tp) grid, rank r at row r // tp, column r % tp, so a tp group is a
row of tp consecutive ranks (on one host, ranks are its cards in order)
and a dp group a column. `TPGroup` is what a rank's forward and engines
take: its place in its tp row, the row's process group and backend, and
the device it computes on.

`make_replica_groups` lays the world out for `serve --dp N --tp M`
instead: N replicas of M ranks whose rank 0 is one and the same process,
the server, which holds shard 0 of every replica (the JAX server holds
every replica in one process too, llama_cu_awq_tpu/serve.py:621-651).

Every collective of the TP forward goes through all_reduce_sum or
all_gather_last. Under the batch-sharded forward (parallel/tp.py, given
a Mesh) a rank computes its dp row's slots, local_rows takes
them from the global batch every process holds, and all_gather_batch
gathers the rows' results over the dp group: the caller's step, never a
captured one (the JAX forward's out-spec P("dp", ...) leaves the global
logits to the caller too). While a thread has `split_at_collectives(split)` open
(engine/graphs.py, capturing a step's CUDA graph), a collective that
thread calls does not run: it hands split() a function that runs it on
the very tensors it was given, and the graph replays that function
between the segments it captured before and after the call. Every
other thread's collectives, and all of them outside a capture, run at
once. COLLECTIVES counts the collectives run, by kind, and
COLLECTIVE_SECONDS the host seconds they took.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

DP_AXIS = "dp"
TP_AXIS = "tp"


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """One rank's view of its tensor-parallel group."""

    rank: int           # index in the group, 0..size-1: the shard it holds
    size: int           # ranks in the group (the tp degree)
    group: object       # the torch.distributed ProcessGroup, None at size 1
    backend: str        # "nccl" (a card per rank) or "gloo"
    device: torch.device
    ranks: tuple = (0,)  # the group's global ranks, in shard order

    @property
    def src(self) -> int:
        """Global rank of the group's rank 0 (the broadcasts' source)."""
        return self.ranks[0]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (dp, tp) grid of global ranks and this process's groups."""

    ranks: np.ndarray   # (dp, tp) global ranks
    tp_group: TPGroup   # this rank's row
    dp_group: object    # this rank's column (a ProcessGroup), None at dp 1
    dp_index: int       # this rank's row

    @property
    def shape(self) -> dict:
        return {DP_AXIS: self.ranks.shape[0], TP_AXIS: self.ranks.shape[1]}


def make_mesh(tp: int | None = None, dp: int | None = None,
              device=None) -> Mesh:
    """Lay out the world's ranks as a (dp, tp) grid (defaults: tp = the
    world, dp = 1; raises ValueError where dp * tp is not the world size)
    and make its process groups. Every rank calls it with the same
    arguments, since torch.distributed.new_group is collective. device:
    this rank's device (default: cuda:<rank mod the host's cards> with
    the nccl backend, else the CPU)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if tp is None and dp is None:
        tp, dp = world, 1
    elif tp is None:
        tp = world // dp
    elif dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"dp*tp = {dp}*{tp} != {world} ranks")
    grid = np.arange(world).reshape(dp, tp)
    backend = dist.get_backend() if dist.is_initialized() else "none"
    if device is None:
        device = (torch.device("cuda", rank % torch.cuda.device_count())
                  if backend == "nccl" else torch.device("cpu"))
    row, col = divmod(rank, tp)
    tp_pg = dp_pg = None
    # new_group is collective over the world: every rank makes every group
    for r in range(dp):
        g = dist.new_group(grid[r].tolist()) if tp > 1 else None
        if r == row:
            tp_pg = g
    for c in range(tp):
        g = dist.new_group(grid[:, c].tolist()) if dp > 1 else None
        if c == col:
            dp_pg = g
    group = TPGroup(col, tp, tp_pg, backend, torch.device(device),
                    tuple(grid[row].tolist()))
    return Mesh(grid, group, dp_pg, row)


def replica_ranks(dp: int, tp: int) -> list[tuple]:
    """The global ranks of each replica's group under `serve --dp N --tp
    M`, in shard order: replica r is (0, 1 + r*(M-1), ..., (r+1)*(M-1)),
    so the world has 1 + N*(M-1) ranks and global rank 0 is shard 0 of
    every replica."""
    return [(0, *range(1 + r * (tp - 1), 1 + (r + 1) * (tp - 1)))
            for r in range(dp)]


def default_replica_devices(dp: int, tp: int, backend: str) -> list[str]:
    """Replica r's shard c computes on entry r*M + c: cuda:r*M + c under
    nccl (the JAX server's devices[i*tp:(i+1)*tp]), else the CPU."""
    return [f"cuda:{i}" if backend == "nccl" else "cpu"
            for i in range(dp * tp)]


def make_replica_groups(dp: int, tp: int, devices=None) -> dict:
    """This process's TPGroups under `serve --dp N --tp M`, by replica:
    rank 0 gets one per replica (shard 0 of each), any other rank the one
    it holds a shard of. Every rank calls it with the same arguments,
    since torch.distributed.new_group is collective: every rank makes
    every group, in replica order. devices: a list of dp*tp devices,
    replica r's shard c at r*M + c (default: default_replica_devices).
    Raises ValueError where the world is not 1 + N*(M-1) ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if world != 1 + dp * (tp - 1):
        raise ValueError(f"--dp {dp} --tp {tp} takes 1 + {dp}*({tp}-1) = "
                         f"{1 + dp * (tp - 1)} ranks, the world has {world}")
    backend = dist.get_backend() if dist.is_initialized() else "none"
    if devices is None:
        devices = default_replica_devices(dp, tp, backend)
    out = {}
    for r, ranks in enumerate(replica_ranks(dp, tp)):
        g = dist.new_group(list(ranks)) if tp > 1 else None
        if rank in ranks:
            c = ranks.index(rank)
            out[r] = TPGroup(c, tp, g, backend,
                             torch.device(devices[r * tp + c]), ranks)
    return out


# the collectives run, by kind, and the host seconds they took (a gloo
# collective on CUDA tensors waits for the work queued before it, so its
# seconds hold that wait unless `sync_timing` is on)
COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "dp_gather": 0}
COLLECTIVE_SECONDS = {"all_reduce": 0.0, "all_gather": 0.0,
                      "dp_gather": 0.0}
_TIMING = {"sync": False}
_SPLIT = threading.local()


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0
        COLLECTIVE_SECONDS[k] = 0.0


@contextlib.contextmanager
def sync_timing():
    """A measurement's switch: each collective synchronizes its device
    before and after, so COLLECTIVE_SECONDS holds the collectives' own
    time (it stalls the host at every collective)."""
    _TIMING["sync"] = True
    try:
        yield
    finally:
        _TIMING["sync"] = False


@contextlib.contextmanager
def split_at_collectives(split: Callable[[Callable[[], None]], None]):
    """While open, a collective called from this thread does not run:
    split(run) receives a function that runs it (see the module
    docstring)."""
    prev = getattr(_SPLIT, "split", None)
    _SPLIT.split = split
    try:
        yield
    finally:
        _SPLIT.split = prev


def _collective(kind: str, run: Callable[[], None],
                device: torch.device) -> None:
    """run() now, counted and timed, or handed to this thread's split."""

    def counted():
        if _TIMING["sync"] and device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        run()
        if _TIMING["sync"] and device.type == "cuda":
            torch.cuda.synchronize(device)
        COLLECTIVES[kind] += 1
        COLLECTIVE_SECONDS[kind] += time.perf_counter() - t0

    split = getattr(_SPLIT, "split", None)
    if split is None:
        counted()
    else:
        split(counted)


# Both collectives are synchronous calls (async_op=False): when one
# returns, the next work queued on the current stream is ordered after
# its result, under gloo (which copies a CUDA tensor to the host, reduces
# there, copies back and makes the current stream wait for that copy) and
# under nccl (whose stream the current stream waits for). A graph's next
# segment, replayed on the current stream, reads the result so.

def all_reduce_sum(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """x summed over the group, in place (the JAX forward's psum). Every
    rank receives the same bits."""
    if tp.size > 1:
        _collective("all_reduce", lambda: dist.all_reduce(
            x, op=dist.ReduceOp.SUM, group=tp.group), x.device)
    return x


def all_gather_last(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """The ranks' x side by side along the last dim, in rank order (the
    JAX forward's tiled all_gather of the vocab-sharded logits). gloo
    takes CUDA tensors here too (checked on the H100: PERF.md §6). Under
    a split capture `parts` and the contiguous x are made in the segment
    before the gather and the cat in the one after, and the gather holds
    both."""
    if tp.size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    xc = x.contiguous()
    _collective("all_gather", lambda: dist.all_gather(
        parts, xc, group=tp.group), x.device)
    return torch.cat(parts, dim=-1)


def local_rows(x, mesh: Mesh):
    """This rank's dp row of a global batch (the leading axis of a tensor
    or an array that every process holds): rows dp_index * B / dp up to
    (dp_index + 1) * B / dp. What the JAX put_global hands each process
    of a batch sharded over P("dp", ...). Raises ValueError where dp does
    not divide B."""
    dp, n = mesh.ranks.shape[0], len(x)
    if n % dp:
        raise ValueError(f"a batch of {n} does not split over dp={dp} rows")
    b = n // dp
    return x[mesh.dp_index * b:(mesh.dp_index + 1) * b]


def all_gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The dp rows' x stacked along the leading axis in dp_index order,
    so rows come back in global slot order (every rank of a dp group
    gives the same shape). Counted as "dp_gather"; never inside a split
    capture, since a batch-sharded step leaves its gather to the
    caller."""
    if mesh.dp_group is None:
        return x
    if getattr(_SPLIT, "split", None) is not None:
        raise RuntimeError("all_gather_batch inside a captured step: "
                           "gather the rows after the step")
    parts = [torch.empty_like(x) for _ in range(mesh.ranks.shape[0])]
    xc = x.contiguous()
    _collective("dp_gather", lambda: dist.all_gather(
        parts, xc, group=mesh.dp_group), x.device)
    return torch.cat(parts, dim=0)
