"""One host's process of a data-parallel x tensor-parallel decode run.

The counterpart of the repository's tools/multihost_worker.py. P
processes, one a host, each of M ranks (--tp M), join one world of P*M
ranks through a coordinator (parallel/multihost.py run_host_ranks:
process p is global rank p*M and spawns the host's other ranks), and
pod_mesh(tp=M) lays it out as dp = P rows (the hosts) of tp = M ranks.
Every rank holds its tp column's shard of the same weights, built from
what it read or made itself: --config tiny is the JAX worker's TINY
model from random_checkpoint(cfg, seed=5), which every rank makes;
--config 7b is Llama-2 7B at its full 32 layers from the port's
tp_synthetic_params(cfg, M, column, seed=0), made on the rank's device.
Every process holds the same global inputs (the JAX worker's
build_model_inputs); each rank runs its dp row's slots through the
batch-sharded TP forward (parallel/tp.py, given the Mesh) for
--steps teacher-forced T=1 steps at a window of 32 with its cache
carried, its batch-sharded cache holding its row's slots and its
column's kv heads. After each step the rows' logits are gathered over
the dp group (all_gather_batch); the checksum is the sum of the last
step's global logits, so it is the same on every host. Each host's rank
0 prints "CHECKSUM %.6f" and "MULTIHOST OK"; --role single prints the
one-process oracle's checksum (the single-device forward on the same
weights and inputs).

    # on host p of P (process 0's host is HOST0), M ranks a host:
    python -m llama_cu_awq_torch.tools.multihost_worker --nprocs P \\
        --pid p --tp M --host HOST0 --port 29400 --separate-hosts \\
        [--config 7b]
    # two processes on one machine, the CPU (the tests):
    python -m llama_cu_awq_torch.tools.multihost_worker --nprocs 2 \\
        --pid 0 --tp 2 --device cpu --port 29400 &
    python -m llama_cu_awq_torch.tools.multihost_worker --nprocs 2 \\
        --pid 1 --tp 2 --device cpu --port 29400
    python -m llama_cu_awq_torch.tools.multihost_worker --role single \\
        --device cpu

The processes are taken to share one machine unless --separate-hosts
says each runs on a host of its own. The collectives run over nccl
where a machine has a card for each of its ranks (parallel/multihost.py
world_cards: M a host from card 0 with --separate-hosts, else P*M, each
process's from card pid*M), else over gloo with every rank of the
machine on card 0 (ranks sharing it, whose collectives pass through the
host) or on the CPU (--device cpu). --dump
DIR writes each rank's logits by step, kernel launches, collectives and
step times to DIR/rank{R}.pt.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

TINY = dict(dim=256, hidden_dim=512, n_layers=2, n_heads=2, n_kv_heads=2,
            vocab_size=1024, seq_len=64)
WINDOW = 32  # the cache rows and the attention window of every step


def build_model_inputs(n_steps: int, batch: int) -> np.ndarray:
    """The teacher-forced tokens (n_steps, batch), the same everywhere."""
    rng = np.random.default_rng(99)
    return rng.integers(4, 900, size=(n_steps, batch)).astype(np.int32)


def model_config(name: str):
    from llama_cu_awq_torch.config import LLAMA2_7B, ModelConfig

    return LLAMA2_7B if name == "7b" else ModelConfig(**TINY)


def run_single(args) -> float:
    """The one-process oracle: the same model and inputs through the
    single-device forward. Returns the last step's logits summed."""
    import torch

    from llama_cu_awq_torch.device import resolve_device
    from llama_cu_awq_torch.io.checkpoint import random_checkpoint
    from llama_cu_awq_torch.models import (forward, init_kv_cache,
                                           params_from_checkpoint,
                                           synthetic_params)

    dev = resolve_device(args.device)
    cfg = model_config(args.config)
    params = (synthetic_params(cfg, seed=0, device=dev)
              if args.config == "7b" else
              params_from_checkpoint(random_checkpoint(cfg, seed=5),
                                     device=dev))
    cache = init_kv_cache(cfg, args.batch, WINDOW, device=dev)
    toks = torch.from_numpy(build_model_inputs(args.steps, args.batch))
    ck = 0.0
    for i in range(args.steps):
        logits, cache = forward(
            params, cfg, toks[i][:, None].to(dev),
            torch.full((args.batch,), i, dtype=torch.int32, device=dev),
            cache, attn_len=WINDOW)
        ck = float(logits.float().sum())
    return ck


def _shard(args, cfg, mesh, device):
    """This rank's shard of the weights (its tp column)."""
    from llama_cu_awq_torch.io.checkpoint import random_checkpoint
    from llama_cu_awq_torch.parallel.tp import (tp_params_from_checkpoint,
                                                tp_synthetic_params)

    tp = mesh.tp_group
    if args.config == "7b":
        return tp_synthetic_params(cfg, tp.size, tp.rank, seed=0,
                                   device=device)
    return tp_params_from_checkpoint(random_checkpoint(cfg, seed=5),
                                     tp.size, tp.rank, device=device)


def host_rank(rank: int, world: int, init: str, args) -> float:
    """Global rank `rank`: join, build the shard and the batch-sharded
    cache, run the decode steps. Returns the checksum."""
    import torch
    import torch.distributed as dist

    from llama_cu_awq_torch.ops.cuda import (LAUNCHES, VARIANT_LAUNCHES,
                                             reset_launches)
    from llama_cu_awq_torch.parallel.mesh import (COLLECTIVE_SECONDS,
                                                  COLLECTIVES,
                                                  all_gather_batch,
                                                  reset_collectives)
    from llama_cu_awq_torch.parallel.multihost import (JOIN_TIMEOUT,
                                                       init_multihost,
                                                       pod_mesh, rank_device,
                                                       world_cards)
    from llama_cu_awq_torch.parallel.tp import (make_tp_forward,
                                                tp_init_kv_cache)

    pid, local = divmod(rank, args.tp)
    backend, first = world_cards(args.device, pid, args.tp,
                                 1 if args.separate_hosts else args.nprocs)
    device = rank_device(local, args.device, backend, first)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # ranks sharing the cores would oversubscribe them many times over
        torch.set_num_threads(1)
    init_multihost(init, world, rank, backend=backend, timeout=JOIN_TIMEOUT)
    try:
        mesh = pod_mesh(tp=args.tp, device=device)
        if mesh.shape["dp"] != args.nprocs:
            raise ValueError(f"{world} ranks at --tp {args.tp} make "
                             f"{mesh.shape['dp']} rows, not --nprocs "
                             f"{args.nprocs}")
        cfg = model_config(args.config)
        params = _shard(args, cfg, mesh, device)
        cache = tp_init_kv_cache(cfg, args.batch, WINDOW, mesh,
                                 device=device)
        fwd = make_tp_forward(cfg, mesh, attn_len=WINDOW)
        toks = torch.from_numpy(build_model_inputs(args.steps, args.batch))
        rows, step_s, ck = [], [], 0.0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        reset_launches()
        reset_collectives()
        for i in range(args.steps):
            t0 = time.perf_counter()
            logits, cache = fwd(
                params, toks[i][:, None].to(device),
                torch.full((args.batch,), i, dtype=torch.int32,
                           device=device), cache)
            logits = logits.float()
            ck = float(all_gather_batch(logits, mesh).sum())
            step_s.append(time.perf_counter() - t0)
            rows.append(logits.cpu())
        if args.dump:
            torch.save({
                "rank": rank, "dp_index": mesh.dp_index,
                "tp_rank": mesh.tp_group.rank, "device": str(device),
                "backend": backend, "logits": torch.stack(rows),
                "checksum": ck, "step_s": step_s,
                "kernels": dict(LAUNCHES),
                "variants": dict(VARIANT_LAUNCHES),
                "collectives": dict(COLLECTIVES),
                "collective_s": dict(COLLECTIVE_SECONDS)},
                os.path.join(args.dump, f"rank{rank}.pt"))
        return ck
    finally:
        dist.destroy_process_group()


def _follower(rank: int, world: int, init: str, args) -> None:
    """A host's ranks after its first (spawned processes): they print
    nothing."""
    import signal

    signal.signal(signal.SIGINT, signal.SIG_IGN)
    sys.stdout = open(os.devnull, "w")  # noqa: SIM115 (the process's)
    host_rank(rank, world, init, args)


def run_worker(args) -> int:
    """This host's ranks (run_host_ranks); its first prints the checksum.
    Returns the ranks' exit code."""
    from llama_cu_awq_torch.parallel.multihost import run_host_ranks

    def leader(init):
        ck = host_rank(args.pid * args.tp, args.nprocs * args.tp, init, args)
        print(f"CHECKSUM {ck:.6f}", flush=True)
        return 0

    rc = run_host_ranks(f"{args.host}:{args.port}", args.nprocs, args.pid,
                        args.tp, leader, _follower, (args,))
    if rc == 0:
        print("MULTIHOST OK", flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m llama_cu_awq_torch.tools.multihost_worker",
        description="one host's process of a dp x tp decode run")
    ap.add_argument("--role", choices=["worker", "single"], default="worker")
    ap.add_argument("--nprocs", type=int, default=2,
                    help="processes, one a host (the dp degree)")
    ap.add_argument("--pid", type=int, default=0, help="this host's index")
    ap.add_argument("--tp", type=int, default=2, help="ranks a host")
    ap.add_argument("--host", default="localhost",
                    help="process 0's host, where the ranks join")
    ap.add_argument("--port", type=int, default=29400)
    ap.add_argument("--separate-hosts", action="store_true",
                    help="each process runs on a host of its own (default: "
                         "the processes share one machine and its cards)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--config", choices=["tiny", "7b"], default="tiny")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dump", default=None, metavar="DIR",
                    help="write each rank's logits and counts to DIR")
    args = ap.parse_args(argv)
    if args.role == "single":
        print(f"CHECKSUM {run_single(args):.6f}", flush=True)
        print("MULTIHOST OK", flush=True)
        return 0
    if args.separate_hosts and args.host in ("localhost", "127.0.0.1"):
        ap.error("--separate-hosts needs process 0's host name, not a "
                 "loopback address")
    if args.batch % args.nprocs:
        ap.error(f"--batch {args.batch} does not split over --nprocs "
                 f"{args.nprocs} hosts")
    return run_worker(args)


if __name__ == "__main__":
    # through the package's name, so the spawned ranks find _follower
    from llama_cu_awq_torch.tools.multihost_worker import main as _main

    sys.exit(_main())
