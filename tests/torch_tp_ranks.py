"""Rank processes for tests/test_torch_tp.py: the port's tensor-parallel
runs on the CPU, one spawned process per rank over gloo.

Imports torch, numpy and the port only (a spawned rank imports this
module, not the test module, so it never loads JAX). spawn_ranks starts
the ranks, joins them through a file under a test's tmp_path (no port
number, so parallel test workers never collide) and returns rank 0's
results: a dict from job name to what the job returned.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import os
import pickle

import numpy as np
import torch

# a failing rank makes the others fail here rather than hang
TIMEOUT = datetime.timedelta(seconds=180)


@contextlib.contextmanager
def exact_staging():
    """The plain w4 matmuls with x (and the SwiGLU u) kept in f32 instead
    of being staged to bf16 as the kernels stage them: a TP forward and a
    single-device forward then differ by the order of their f32 sums
    alone (with the bf16 staging, a sum one f32 ulp apart can round an
    element of x one bf16 ulp apart, which moves the whole row)."""
    from llama_cu_awq_torch.ops.cuda import int4_matmul as im

    def fused(x, qt, *, prescale=None, silu_u=None, residual=None,
              emit_ss_eps=None, out_dtype=torch.bfloat16):
        lead, m = im._rows(x, qt.n_in)
        xf = x.float()
        if prescale is not None:
            xf = xf * prescale[0].float() * prescale[1].float()
        elif silu_u is not None:
            xf = xf * torch.sigmoid(xf) * silu_u.float()
        out = (xf.reshape(m, qt.n_in) @ qt.dequantize_t().T).reshape(
            *lead, qt.n_out)
        if residual is not None:
            out = out + residual.float()
        out = out.to(out_dtype)
        ss = None
        if emit_ss_eps is not None:
            of = out.float()
            ss = torch.rsqrt((of * of).mean(dim=-1, keepdim=True)
                             + emit_ss_eps)
        return out, ss

    saved = im.int4_matmul_fused_plain
    im.int4_matmul_fused_plain = fused
    try:
        yield
    finally:
        im.int4_matmul_fused_plain = saved


@contextlib.contextmanager
def counting(calls: dict):
    """Count forward's calls of the two attention kernels' wrappers (on
    the CPU their plain versions run, which the launch counters do not
    count)."""
    from llama_cu_awq_torch.models import llama as tl

    saved = tl.pfa.prefill_attention, tl.attention_step

    def wrap(name, fn):
        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return call

    tl.pfa.prefill_attention = wrap("prefill_attention", saved[0])
    tl.attention_step = wrap("attention_step", saved[1])
    try:
        yield
    finally:
        tl.pfa.prefill_attention, tl.attention_step = saved


ACT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CACHE = {"plain": dict(), "int8": dict(quantized=True),
         "int4": dict(quantized=True, kv_bits=4)}


def forward_job(job, ckpt, tp=None, rank=0):
    """Logits of one forward case (see test_torch_tp.FORWARD_CASES), on
    one rank's shard under tp, else single-device, on job["device"] (the
    CPU by default). Returns (logits as f32 numpy, the attention kernels'
    call counts)."""
    from llama_cu_awq_torch.models import llama as tl
    from llama_cu_awq_torch.parallel.tp import (make_shard_forward,
                                                make_tp_forward,
                                                tp_init_kv_cache,
                                                tp_params_from_checkpoint)

    cfg, act = ckpt.config, ACT[job["act"]]
    dev = torch.device(job.get("device", "cpu"))
    if tp is None:
        params = tl.params_from_checkpoint(ckpt, device=dev,
                                           param_dtype=act)
        cache = tl.init_kv_cache(cfg, 1, job["max_seq"], dtype=act,
                                 device=dev, **CACHE[job["cache"]])
    else:
        params = tp_params_from_checkpoint(ckpt, tp.size, rank,
                                           device=dev, param_dtype=act)
        cache = tp_init_kv_cache(cfg, 1, job["max_seq"], tp.size,
                                 dtype=act, device=dev,
                                 **CACHE[job["cache"]])
    if tp is None:
        fwd = functools.partial(tl.forward, params, cfg, cache=cache,
                                attn_len=job["max_seq"], act_dtype=act)
    else:
        fwd = functools.partial(make_shard_forward(cfg, tp), params,
                                cache=cache, attn_len=job["max_seq"],
                                act_dtype=act)
    toks = job["tokens"]
    calls: dict = {}
    with counting(calls), (exact_staging() if job.get("exact")
                           else contextlib.nullcontext()):
        def ids(xs):
            return torch.tensor([xs], device=dev)

        def at(p):
            return torch.tensor([p], dtype=torch.int32, device=dev)

        if job["mode"] == "steps":  # T=1 steps, one token at a time
            out = [fwd(ids([t]), at(i), attn_impl=job.get("attn_impl"))[0][0]
                   for i, t in enumerate(toks)]
            logits = torch.stack(out)
        elif job["mode"] == "block" and tp is not None \
                and job.get("attn_impl") is None:
            # one T-token block, every row, through the bound TP forward
            logits = make_tp_forward(cfg, tp, attn_len=job["max_seq"],
                                     act_dtype=act, logits_all=True)(
                params, ids(toks), at(0), cache)[0][0]
        elif job["mode"] == "block":
            logits = fwd(ids(toks), at(0), attn_impl=job.get("attn_impl"),
                         logits_all=True)[0][0]
        else:  # "prompt_step": toks[:-1] as a block, then one step
            fwd(ids(toks[:-1]), at(0), no_logits=True)
            logits = fwd(ids(toks[-1:]), at(len(toks) - 1),
                         attn_impl=job["attn_impl"])[0]
    return logits.float().cpu().numpy(), calls


def _agree(tp, tokens: list[int]) -> int:
    """max - min over the ranks of each token, summed: 0 when every rank
    drew the same stream."""
    import torch.distributed as dist

    t = torch.tensor(tokens, dtype=torch.int64)
    hi, lo = t.clone(), t.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=tp.group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=tp.group)
    return int((hi - lo).abs().sum())


def _stale(eng, job) -> None:
    """With job["stale"], the engine's bodies run through _StaleSet (each
    key replays its first body, as a graph replays what it captured); an
    engine made with capture=True on the CPU has no graphs of its own."""
    if job.get("stale"):
        from torch_graph_standins import _StaleSet

        assert eng._graphs is None
        eng._graphs = _StaleSet()


def engine_job(job, ckpt, tp, rank):
    """A TP InferenceEngine's greedy stream, and the ranks' agreement."""
    from llama_cu_awq_torch.engine import InferenceEngine
    from llama_cu_awq_torch.parallel.tp import tp_params_from_checkpoint

    act = ACT[job["act"]]
    params = tp_params_from_checkpoint(ckpt, tp.size, rank, device="cpu",
                                       param_dtype=act)
    eng = InferenceEngine(params, ckpt.config, None, temperature=0.0,
                          max_seq=job["max_seq"], device="cpu",
                          act_dtype=act, tp=tp,
                          capture=bool(job.get("stale")),
                          **job.get("kw", {}))
    _stale(eng, job)
    toks, _, _ = eng.generate_benchmark(job["prompt"], job["steps"])
    return toks, _agree(tp, toks)


def batch_job(job, ckpt, tp, rank):
    """A TP BatchEngine: rank 0 serves the requests and returns their
    streams; the other ranks follow."""
    from llama_cu_awq_torch.engine import BatchEngine
    from llama_cu_awq_torch.parallel.tp import tp_params_from_checkpoint

    params = tp_params_from_checkpoint(ckpt, tp.size, rank, device="cpu")
    be = BatchEngine(params, ckpt.config, None, device="cpu", tp=tp,
                     capture=bool(job.get("stale")), **job["kw"])
    _stale(be, job)
    if rank:
        be.follow()
        return None
    try:
        streams = []
        for _ in range(job.get("rounds", 1)):
            be.reset()
            rids = [be.submit(p, max_new=job["max_new"])
                    for p in job["prompts"]]
            out = be.run()
            streams.append([out[r] for r in rids])
            be._sent_t -= 120  # an idle minute: idle() sends its no-op
            be.idle()
        stats = be.stats()
        return streams, stats.get("prefix_cache")
    finally:
        be.stop_followers()


def split_job_(job, ckpt, tp, rank):
    """engine/graphs.py's split capture over this group's gloo
    collectives (tests/torch_graph_standins.py split_job)."""
    from torch_graph_standins import split_job

    return split_job(tp)


def _cache_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        a.cache.k + a.cache.v + a.cache.k_scale + a.cache.v_scale,
        b.cache.k + b.cache.v + b.cache.k_scale + b.cache.v_scale))


def _all_ranks(tp, ok: bool) -> bool:
    """ok on every rank of the group."""
    import torch.distributed as dist

    t = torch.tensor([int(ok)])
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=tp.group)
    return bool(t.item())


def graphs_job(job, ckpt, tp, rank):
    """On the card: a TP InferenceEngine (greedy decode after a short and
    a 140-token prompt, twice, then the perplexity of the longer prompt;
    the spec verify with spec="ngram") and a TP BatchEngine (two rounds,
    block prefill, and spec blocks), each made with capture=True and with
    capture=False: the streams and whole caches equal bit for bit on every
    rank. Returns the streams, the equalities, and the segments of each
    graph key by its kind and T."""
    from llama_cu_awq_torch.engine import BatchEngine, InferenceEngine
    from llama_cu_awq_torch.engine.perplexity import token_perplexity
    from llama_cu_awq_torch.parallel.tp import tp_params_from_checkpoint

    cfg = ckpt.config
    params = tp_params_from_checkpoint(ckpt, tp.size, rank, device="cuda")
    long = [1] + [(3 * i) % 500 + 4 for i in range(139)]
    res = {"segments": {}}

    def segments(eng, name):
        for k, g in eng._graphs.graphs.items():
            kind = k[0] if isinstance(k[0], str) else k[0][0]
            res["segments"][f"{name}/{kind}/T{k[1]}"] = g.segments

    for spec in (None, "ngram"):
        name = "engine" if spec is None else "engine_spec"
        runs = {}
        engs = {}
        for capture in (True, False):
            eng = InferenceEngine(params, cfg, None, temperature=0.0,
                                  max_seq=256, attn_impl="fused_step",
                                  spec=spec, spec_k=4, tp=tp,
                                  capture=capture)
            out = []
            for _ in range(2):
                for prompt in ([1, 7, 42, 3, 200, 99, 5, 17], long):
                    eng.reset()
                    out.append(eng.generate_benchmark(
                        prompt, len(prompt) + 23)[0])
            if spec is None:
                out.append([token_perplexity(eng, long)])
            runs[capture], engs[capture] = out, eng
        assert engs[True]._graphs is not None and engs[False]._graphs is None
        segments(engs[True], name)
        res[name] = dict(streams=runs[True],
                         equal=_all_ranks(tp, runs[True] == runs[False]
                                          and _cache_equal(*engs.values())))
        del engs
    for spec in (None, "ngram"):
        name = "batch" if spec is None else "batch_spec"
        got = {}
        engs = {}
        for capture in (True, False):
            be = BatchEngine(params, cfg, None, n_slots=2, max_seq=256,
                             chunk_size=4, temperature=0.0, spec=spec,
                             spec_k=4, tp=tp, capture=capture)
            engs[capture] = be
            if rank:
                be.follow()
                continue
            try:
                streams = []
                for _ in range(2):
                    be.reset()
                    rids = [be.submit(p, max_new=8) for p in
                            ([1, 5, 9, 11], long, [1, 300, 2, 77, 8, 8, 8])]
                    out = be.run()
                    streams.append([out[r] for r in rids])
                got[capture] = streams
            finally:
                be.stop_followers()
        segments(engs[True], name)
        res[name] = dict(streams=got.get(True),
                         equal=_all_ranks(tp, got.get(True) == got.get(False)
                                          and _cache_equal(*engs.values())))
        del engs
    return res


def mesh_job(job, ckpt, tp, rank):
    """make_mesh over the whole world, and what each group sums."""
    import torch.distributed as dist

    from llama_cu_awq_torch.parallel import is_coordinator, make_mesh

    m = make_mesh(tp=job["tp"], dp=job["dp"])
    x = torch.tensor([float(dist.get_rank())])
    dist.all_reduce(x, group=m.tp_group.group)
    y = torch.tensor([float(dist.get_rank())])
    if m.dp_group is not None:
        dist.all_reduce(y, group=m.dp_group)
    row = dict(rank=dist.get_rank(), shape=m.shape, tp_rank=m.tp_group.rank,
               tp_ranks=m.tp_group.ranks, dp_index=m.dp_index,
               tp_sum=float(x), dp_sum=float(y),
               coordinator=is_coordinator())
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, row)
    return rows


def _every_rank(obj) -> list:
    """obj from every rank of the world, in rank order."""
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def dp_forward_job(job, ckpt, tp, rank):
    """The batch-sharded TP forward over make_mesh(tp=job["tp"],
    dp=job["dp"]) (parallel/tp.py, given the Mesh): job["steps"] T=1
    steps of the global (B, 1) tokens at positions step + job["offsets"],
    the cache carried. Returns every rank's (dp_index, tp_rank, its rows'
    logits by step, its cache as numpy, the last step's logits gathered
    over dp), on device (the CPU by default, where the job runs on the
    card)."""
    from llama_cu_awq_torch.parallel import all_gather_batch, make_mesh
    from llama_cu_awq_torch.parallel.tp import (make_tp_forward,
                                                tp_init_kv_cache,
                                                tp_params_from_checkpoint)

    cfg, act = ckpt.config, ACT[job["act"]]
    dev = torch.device(job.get("device", "cpu"))
    mesh = make_mesh(tp=job["tp"], dp=job["dp"], device=dev)
    params = tp_params_from_checkpoint(ckpt, job["tp"], mesh.tp_group.rank,
                                       device=dev, param_dtype=act)
    cache = tp_init_kv_cache(cfg, len(job["offsets"]), job["max_seq"], mesh,
                             dtype=act, device=dev, **CACHE[job["cache"]])
    fwd = make_tp_forward(cfg, mesh, attn_len=job["max_seq"], act_dtype=act)
    offsets = torch.tensor(job["offsets"], dtype=torch.int32)
    rows = []
    for i, step in enumerate(job["tokens"]):
        logits, cache = fwd(params, torch.tensor(step, device=dev)[:, None],
                            (offsets + i).to(dev), cache)
        rows.append(logits.float().cpu().numpy())
    gathered = all_gather_batch(logits, mesh).float().cpu().numpy()

    def host(xs):
        return [x.float().cpu().numpy() for x in xs]

    return _every_rank(dict(
        dp_index=mesh.dp_index, tp_rank=mesh.tp_group.rank,
        logits=np.stack(rows), gathered=gathered,
        cache=dict(k=host(cache.k), v=host(cache.v),
                   k_scale=host(cache.k_scale), v_scale=host(cache.v_scale))))


def dp_gather_job(job, ckpt, tp, rank):
    """all_gather_batch over make_mesh(tp=2, dp=2): every rank gives two
    rows that no other rank gives, so the gather must return its
    column's rows in dp_index order."""
    from llama_cu_awq_torch.parallel import all_gather_batch, make_mesh

    mesh = make_mesh(tp=2, dp=2)
    c, r = mesh.tp_group.rank, mesh.dp_index
    x = 100 * r + 10 * c + torch.arange(6, dtype=torch.float32).reshape(2, 3)
    return _every_rank(dict(dp_index=r, tp_rank=c, x=x.numpy(),
                            gathered=all_gather_batch(x, mesh).numpy()))


JOBS = {"forward": forward_job, "engine": engine_job, "batch": batch_job,
        "mesh": mesh_job, "split": split_job_, "graphs": graphs_job,
        "dp_forward": dp_forward_job, "dp_gather": dp_gather_job}


def _rank_main(rank: int, n: int, init: str, path: str, jobs, out: str):
    torch.set_num_threads(1)
    if any(j.get("device", "cpu") != "cpu" for j in jobs):
        torch.cuda.set_device(0)  # the ranks share the card
    from llama_cu_awq_torch.io.checkpoint import load_checkpoint
    from llama_cu_awq_torch.parallel import init_multihost, make_mesh

    init_multihost(init, n, rank, backend="gloo", timeout=TIMEOUT)
    try:
        tp = make_mesh(tp=n, dp=1).tp_group
        results = {}
        ckpts = {}
        for job in jobs:
            p = job.get("bin", path)
            if p not in ckpts:
                ckpts[p] = load_checkpoint(p)
            ckpt = ckpts[p]
            results[job["name"]] = JOBS[job["kind"]](job, ckpt, tp, rank)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(n: int, tmp_path, path: str, jobs) -> dict:
    """Run `jobs` on n gloo ranks; rank 0's results."""
    import torch.multiprocessing as mp

    init = f"file://{tmp_path}/init_{n}"
    out = os.path.join(str(tmp_path), f"results_{n}.pkl")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, init, path, jobs, out))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
        codes = [p.exitcode for p in procs]
        if codes != [0] * n:
            raise AssertionError(f"ranks exited with {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    with open(out, "rb") as f:
        return pickle.load(f)
