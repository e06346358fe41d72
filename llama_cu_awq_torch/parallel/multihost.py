"""Joining the ranks of a tensor-parallel run.

The counterpart of llama_cu_awq_tpu/parallel/multihost.py. There, every
host runs the same program, jax.distributed.initialize joins them, and
one Mesh spans the slice. Here every rank is a process of its own that
joins the group with torch.distributed.init_process_group, then lays the
world out with mesh.make_mesh.

The backend is the caller's choice, never found by trying one: "nccl"
where each rank has a card of its own (the CLI and the server on N
cards), "gloo" where ranks share one card (chip_smoke.py's two ranks on
one H100, whose collectives pass through the host) or run on the CPU
(the tests, `--device cpu --tp N`).

The JAX module's put_global and place_params_global have no counterpart:
they place one host array as a global jax.Array over many processes.
A rank here reads the checkpoint itself and builds only its own shard
(parallel/tp.py tp_params_from_checkpoint), so nothing is placed across
processes.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from llama_cu_awq_torch.parallel.mesh import make_mesh


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str = "nccl", timeout=None) -> None:
    """Join the process group (a no-op for one process, as the JAX
    function is). coordinator_address: torch.distributed's init method,
    "tcp://host:port" or "file:///path"; num_processes and process_id the
    world size and this rank. A mismatch, or a rank that stops answering,
    raises rather than hangs once `timeout` (a datetime.timedelta;
    torch.distributed's default where None) has passed."""
    if num_processes == 1:
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id, **kw)


def pod_mesh(tp: int | None = None):
    """(dp, tp) mesh over every rank: tp defaults to the ranks of one host
    (its cards under nccl), dp to the number of hosts."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        tp = min(world, cards) or world
    return make_mesh(tp=tp, dp=world // tp)


def is_coordinator() -> bool:
    """True on rank 0 (the one that prints and serves), and without a
    process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def replica_shard(rank: int, tp: int) -> tuple[int, int]:
    """(replica, shard) of global rank `rank` >= 1 under `serve --dp N
    --tp M`: ranks 1..M-1 are replica 0's shards 1..M-1, the next M-1
    replica 1's, and so on (mesh.replica_ranks); rank 0 holds shard 0 of
    every replica."""
    if rank < 1 or tp < 2:
        raise ValueError(f"rank {rank} at --tp {tp} holds no one replica")
    return (rank - 1) // (tp - 1), 1 + (rank - 1) % (tp - 1)


def run_ranks(n: int, leader, follower, extra: tuple) -> int:
    """Run rank 0 here, leader(init_method), and ranks 1..n-1 as spawned
    processes, each follower(rank, n, init_method, *extra). The ranks join
    through a file in a fresh temporary directory. A rank that fails makes
    the others fail or time out; the processes are stopped either way.
    Returns 0 where every rank exited with 0, else the first other code
    in rank order (a negative one: that rank was killed by the signal)."""
    tmp = tempfile.mkdtemp(prefix="llama_tp_")
    init = "file://" + os.path.join(tmp, "init")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=follower, args=(r, n, init, *extra))
             for r in range(1, n)]
    try:
        for p in procs:
            p.start()
        rc = leader(init)
        for p in procs:
            p.join()
        return next((c for c in [rc] + [p.exitcode for p in procs] if c),
                    0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
