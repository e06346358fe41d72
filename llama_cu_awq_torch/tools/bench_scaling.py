"""Scaling efficiency: continuous-batching aggregate tok/s at tp=1 against
tensor-parallel widths.

The counterpart of the repository's tools/bench_scaling.py (BASELINE
config 5: 13B tensor-sharded, 32 concurrent requests, efficiency >= 80 %).
Efficiency(N) = tok_s(tp=N) / (N * tok_s(tp=1)).

    python -m llama_cu_awq_torch.tools.bench_scaling --config 13b \\
        --tps 1,4 --slots 32 --kv-quant          # 4 cards, nccl
    python -m llama_cu_awq_torch.tools.bench_scaling --config tiny \\
        --tps 1,2                                # plumbing on one card
    python -m llama_cu_awq_torch.tools.bench_scaling --smoke   # the CPU

Each width is one point, measured by the bench's own batch mode
(llama_cu_awq_torch.bench run_args with --mode batch --tp N --spec none,
the tool's --config shapes in place of the bench's): BatchEngine over
synthetic weights (seed 0) serving --requests greedy requests on --slots,
the best of --repeats runs after a warm-up, then three requests replayed
against plain decode (the bench's batch gate). Every point runs on CUDA
graphs; a tp=N point runs N ranks (the bench's run_ranks: this process
is rank 0), their graphs split at the collectives (engine/graphs.py). The
collectives follow the bench's rule (tp_backend): nccl with rank r on
cuda:K+r where K+N cards are visible, else gloo with every rank on
cuda:K (K = 0 in one process),
whose collectives pass through the host: such a point checks the path,
it is no TP speed, and the log says so. The JAX tool skips a width above
its local devices instead; the port runs it, since the one-card run is
how the TP path is checked on one card.

--smoke is --device cpu --config tiny --tps 1,2 over gloo, with 4 slots,
8 requests of 16 steps, max_seq 64, chunks of 4 and one repeat.

Several hosts, one process each:

    python -m llama_cu_awq_torch.tools.bench_scaling --config 13b \\
        --tps 1,4 --slots 32 --nprocs 2 --pid $I --coordinator host0:29400

Each process runs its own BatchEngine replica of every width over its
host's ranks (a tp=M point: M local ranks, the bench's run_ranks, as a
single-host point), so no rank crosses a host and the hosts' aggregate
is the sum of their lines. The processes meet at a barrier before every
width (parallel/multihost.py HostBarrier, a TCPStore at --coordinator,
served by process 0), so their points run at the same time; each line
carries _proc{pid}, and each efficiency line is beside that process's
own tp=1 point. A point's ranks start at card (pid * M) mod the cards
where they fit, else 0 (parallel/multihost.py host_cards), so processes
that share a machine with enough cards take their own; the bench's rule
then picks nccl or gloo from there. The JAX tool builds
each width's mesh over jax.devices()[:tp], which after
jax.distributed.initialize are process 0's devices on every process,
where its docstring means each host's local chips (ROADMAP.md, known
defects in the reference): the port takes the local ones.

The JAX tool's --virtual (a 1-2-4-8 sweep on 8 virtual CPU devices of
one JAX process) has no counterpart: a PyTorch rank is a process, and
ranks sharing one CPU's cores measure the host, not the sharding.

Prints one JSON line per measured point, then one efficiency line per
width beside tp=1.
"""

from __future__ import annotations

import argparse
import json
import sys

from llama_cu_awq_torch import bench as tb


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def model_config(name: str):
    """The JAX tool's configurations: 7b and 13b, 13b-mini, and a tiny
    model of 2 heads of 128 (bench.py's tiny has 4 of 64)."""
    from llama_cu_awq_torch.config import ModelConfig

    if name == "13b-mini":
        # 13B's proportions (hidden/dim about 2.75, MHA) at 8 heads of 128
        return ModelConfig(dim=1024, hidden_dim=2816, n_layers=2, n_heads=8,
                           n_kv_heads=8, vocab_size=2048, seq_len=512)
    if name == "tiny":
        return ModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=2,
                           n_kv_heads=2, vocab_size=512, seq_len=512)
    return tb.model_config(name)


def bench_args(args, tp: int):
    """The bench's --mode batch arguments for one width."""
    argv = ["--mode", "batch", "--config", "7b", "--tp", str(tp),
            "--slots", str(args.slots), "--requests", str(args.requests),
            "--steps", str(args.steps), "--prompt-len", str(args.prompt_len),
            "--max-seq", str(args.max_seq),
            "--chunk-size", str(args.chunk_size),
            "--repeats", str(args.repeats), "--device", args.device,
            "--spec", "none"]
    if args.kv_quant:
        argv.append("--kv-quant")
    if args.attn_impl:
        argv += ["--attn-impl", args.attn_impl]
    targs = tb.parse_args(argv)
    targs.config = args.config
    targs.model_cfg = model_config(args.config)
    if args.nprocs > 1 and args.device == "cuda":
        from llama_cu_awq_torch.parallel.multihost import host_cards

        targs.device = f"cuda:{host_cards(args.pid, tp)}"
    return targs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m llama_cu_awq_torch.tools.bench_scaling",
        description="aggregate tok/s at tp=1 against tensor-parallel widths")
    ap.add_argument("--config", default="7b",
                    choices=["7b", "13b", "13b-mini", "tiny"])
    ap.add_argument("--tps", default="1",
                    help="comma-separated tensor-parallel widths, e.g. 1,4")
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--chunk-size", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--attn-impl", default=None,
                    choices=["batched", "fused_step"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--nprocs", type=int, default=1,
                    help="multi-host: process count (one per host)")
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--coordinator", default=None,
                    help="multi-host: host:port of process 0")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model on the CPU, tp 1 and 2 over gloo")
    args = ap.parse_args(argv)

    if args.smoke:
        args.device, args.config = "cpu", "tiny"
        args.tps, args.slots, args.requests = "1,2", 4, 8
        args.steps, args.max_seq, args.repeats = 16, 64, 1
        args.chunk_size = 4
    tps = [int(t) for t in args.tps.split(",")]
    hosts = None
    if args.nprocs > 1:
        if not args.coordinator:
            ap.error("--nprocs N takes --coordinator host:port")
        from llama_cu_awq_torch.parallel.multihost import HostBarrier

        hosts = HostBarrier(args.coordinator, args.nprocs, args.pid)
    results = {}
    for tp in tps:
        log(f"tp={tp} ...")
        if hosts is not None:
            hosts.wait(f"tp{tp}")
        tok_s = tb.run_args(bench_args(args, tp))["value"]
        results[tp] = tok_s
        print(json.dumps({
            "metric": f"scaling_tok_s_{args.config}_tp{tp}"
                      + (f"_proc{args.pid}" if args.nprocs > 1 else ""),
            "value": tok_s, "unit": "tok/s",
            "devices": tp * args.nprocs}), flush=True)
    if hosts is not None:
        hosts.close()
    if 1 in results:
        for tp, v in sorted(results.items()):
            if tp == 1:
                continue
            print(json.dumps({
                "metric": f"scaling_efficiency_{args.config}_tp{tp}",
                "value": round(v / (tp * results[1]), 4),
                "unit": "fraction", "target": 0.8}), flush=True)
    return 0


if __name__ == "__main__":
    # through the package's name, as the bench's --tp ranks are spawned
    from llama_cu_awq_torch.tools.bench_scaling import main as _main

    sys.exit(_main())
