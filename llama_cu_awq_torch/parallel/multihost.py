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

Several hosts: run_host_ranks runs P processes (one a host, --pid p)
of M local ranks each as one world of P*M ranks joined through a
coordinator's tcp://host:port; process p is global rank p*M and spawns
p*M+1 .. p*M+M-1, so pod_mesh(tp=M) makes each host's ranks a tp row and
the hosts' ranks of one column a dp group (the JAX layout: dp over the
hosts, tp within one). HostBarrier joins processes that each run a
world of their own (tools/bench_scaling.py --nprocs, a replica a host).

What stands in for the JAX module's put_global and place_params_global,
which place host data that every process holds as a global jax.Array:
- put_global of a batch sharded over P("dp", ...): mesh.local_rows, a
  rank's dp row of the global array every process holds (the
  batch-sharded forward takes it itself, parallel/tp.py);
- place_params_global: every rank builds its own shard of the weights
  from what it read or made itself (parallel/tp.py
  tp_params_from_checkpoint, tp_synthetic_params, shard_params, with its
  tp column as the shard), so no weight crosses a process.
"""

from __future__ import annotations

import datetime
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


def pod_mesh(tp: int | None = None, device=None):
    """(dp, tp) mesh over every rank: tp defaults to the ranks of one host
    (its cards under nccl), dp to the number of hosts. device: this
    rank's (make_mesh's default where None)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        tp = min(world, cards) or world
    return make_mesh(tp=tp, dp=world // tp, device=device)


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


# the longest a rank waits for its peers at the join and in a collective
JOIN_TIMEOUT = datetime.timedelta(seconds=900)


def host_cards(pid: int, local: int) -> int:
    """The first card of process pid's `local` ranks on its machine, for
    processes that each run a world of their own: (pid * local) mod the
    cards where the ranks fit from there, else 0. Processes sharing a
    machine with enough cards take cards of their own; on hosts of
    `local` cards each starts at 0. Worlds may share a card; the ranks of
    one world take world_cards."""
    cards = torch.cuda.device_count()
    first = pid * local % cards if cards else 0
    return first if first + local <= cards else 0


def world_cards(device: str, pid: int, local: int,
                sharing: int) -> tuple[str, int]:
    """(backend, first card) of process pid's `local` ranks in one world
    (run_host_ranks) where `sharing` processes share each machine (1:
    every process a host of its own): nccl from card (pid % sharing) *
    local where the machine has a card for each of its sharing * local
    ranks, else gloo with every rank of the machine on card 0 (NCCL
    refuses two ranks of one world on one card). Every process makes the
    same choice where the machines hold as many cards, as one world
    needs."""
    if device == "cpu":
        return "gloo", 0
    if torch.cuda.device_count() >= sharing * local:
        return "nccl", pid % sharing * local
    return "gloo", 0


def host_backend(device: str, local: int, first: int = 0) -> str:
    """The collectives' backend for `local` ranks from card `first`:
    nccl where each has a card of its own, else gloo (ranks sharing a
    card, or the CPU)."""
    if device == "cpu" or torch.cuda.device_count() < first + local:
        return "gloo"
    return "nccl"


def rank_device(local_rank: int, device: str, backend: str,
                first: int = 0) -> torch.device:
    """A rank's device: the CPU, cuda:first+local_rank under nccl, else
    cuda:first (every rank of the host shares it)."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", first + (local_rank if backend == "nccl"
                                         else 0))


def _run_local(first: int, local: int, world: int, init: str, leader,
               follower, extra: tuple) -> int:
    """Rank `first` here, leader(init), and ranks first+1 .. first+local-1
    as spawned processes, follower(rank, world, init, *extra); each is
    stopped when the call ends, whatever happens. Returns 0 where every
    rank exited with 0, else the first other code in rank order (a
    negative one: that rank was killed by the signal)."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=follower, args=(r, world, init, *extra))
             for r in range(first + 1, first + local)]
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


def run_ranks(n: int, leader, follower, extra: tuple) -> int:
    """Run rank 0 here, leader(init_method), and ranks 1..n-1 as spawned
    processes, each follower(rank, n, init_method, *extra). The ranks join
    through a file in a fresh temporary directory. A rank that fails makes
    the others fail or time out; the processes are stopped either way.
    Returns _run_local's code."""
    tmp = tempfile.mkdtemp(prefix="llama_tp_")
    try:
        return _run_local(0, n, n, "file://" + os.path.join(tmp, "init"),
                          leader, follower, extra)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_host_ranks(coordinator: str, nprocs: int, pid: int, local: int,
                   leader, follower, extra: tuple) -> int:
    """This host's ranks of a world of nprocs hosts x `local` ranks: run
    global rank pid*local here, leader(init_method), and spawn ranks
    pid*local+1 .. pid*local+local-1, each follower(rank, world,
    init_method, *extra). Every rank of every host joins through the
    coordinator ("host:port", tcp://, where process 0's rank 0 listens),
    with JOIN_TIMEOUT as its timeout (init_multihost's): a rank that
    fails makes its peers fail at their next collective, or at the join
    within the timeout, and this host's processes are stopped either way.
    Returns _run_local's code."""
    if not 0 <= pid < nprocs:
        raise ValueError(f"--pid {pid} is not one of {nprocs} processes")
    return _run_local(pid * local, local, nprocs * local,
                      f"tcp://{coordinator}", leader, follower, extra)


class HostBarrier:
    """A barrier of nprocs processes, one a host, through a TCPStore at
    the coordinator ("host:port"; process 0 serves it): for processes
    that each run a world of their own, so none holds a default process
    group for the hosts. wait(name) returns once every process reached
    it, or raises after `timeout`; every process calls close() last."""

    def __init__(self, coordinator: str, nprocs: int, pid: int,
                 timeout=JOIN_TIMEOUT):
        host, port = coordinator.rsplit(":", 1)
        self.nprocs, self.pid = nprocs, pid
        self.store = dist.TCPStore(host, int(port), nprocs, pid == 0,
                                   timeout=timeout)

    def wait(self, name: str) -> None:
        self.store.set(f"{name}/{self.pid}", "1")
        self.store.wait([f"{name}/{p}" for p in range(self.nprocs)])

    def close(self) -> None:
        """Process 0 returns once every other process has called close(),
        so its store outlives their last wait."""
        if self.pid:
            self.store.set(f"closed/{self.pid}", "1")
        else:
            self.store.wait([f"closed/{p}" for p in range(1, self.nprocs)])
        self.store = None
