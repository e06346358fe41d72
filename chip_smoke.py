#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llama_cu_awq_torch) on one NVIDIA card.

    python3 chip_smoke.py    # needs one card

Phases (any failure raises, so the script exits non-zero; none is caught):
  1. the card: nvidia-smi name and power limit, torch, CUDA, driver and
     nvcc versions;
  2. build every kernel from llama_cu_awq_torch/csrc (one nvcc per source,
     all at once) and print the build seconds;
  3. kernels at Llama-2 7B shapes: each kernel and variant against its
     plain PyTorch version on the same inputs on the card, within the
     stated tolerance, timed with CUDA events (median after warm-up, L2
     flushed before every timed launch) beside its bound;
     The prefill kernels (prefill_attention at T=128 over a 2048-row
     window at positions 0, 1024 and 1920; the int4 GEMM at m=128, with
     F.linear on the dequantized bf16 weight as a second yardstick, and
     its rows at m=65 and 100 held bit for bit to the 128-row call) join
     them, with the GEMV-against-GEMM sweep over m that sets GEMM_MIN_M,
     the sweep of the GEMM's split count behind gemm_splits, and
     check-only rows at 13B's shapes (the four GEMM rows at m=128 and
     prefill_attention MHA bf16, one synthetic layer); the lm_head
     (the tile kernel dense_gemm.cu) at m=1, m=8 (the serving step) and
     m=128 (a prefill block), bf16 and int8; decode attention (the split
     kernels) at position 1500 and at B=8 over positions 960-1100; the
     w4 GEMV at m=1, m=8 (the serving step) and m=16 (the bench's 16
     slots, launched by phase 14's run (c)), and each row of an m=8
     call of the GEMV, down_qkv and ffn_chain held bit for bit to the
     m=1 call on that row;
  4. end to end: synthetic 7B w4-g128 weights on the card, 256 greedy
     decode steps through InferenceEngine.generate_benchmark, then short
     runs through the options that reach the other kernels (fused_step
     attention, int8 KV, int8 and w4 lm_head), each with the launch
     counters set to 0 just before and read just after; a profile of one
     16-token decode chunk (host wall time, device time per operation,
     device idle share); then one full 7B forward step through the
     kernels and through the plain versions;
  5. prefill end to end: a 1920-token prompt (15 blocks of 128) through
     generate_benchmark (time to first token) and _prefill (prefill
     tokens/s; the lm_head runs once a prompt, on its last block), a
     256-token prompt with int8 KV, a 256-token prompt with the int8
     lm_head (its tile kernel at 128 rows), a profile of one 128-token
     block (with the busy share of the GEMM's and prefill_attention's
     kernels), the
     perplexity of a 1023-token sequence through the kernels and through
     the plain versions (|delta ln ppl| <= 0.01; the head on each block),
     and
     one full 7B 128-token block at position 1024, kernels against plain
     versions, for bf16 and int8 KV;
  6. the int4 KV cache, batched attention and speculative decoding end to
     end: the 1920-token prompt with kv_bits=4 (prefill through plain
     split-plane attention) and 32 decode steps through attention_step_kv4
     at the 2048 bucket (time to first token, decode tokens/s, cache
     bytes); 32 steps each of attn_impl="batched" over bf16 and int8 KV
     and 16 of "batched_static" after a 1024-token prompt; 256 greedy
     steps with spec="ngram" on a repetitive prompt beside the plain
     stream, its verifies replayed from graphs against an engine made
     with capture=False in turns (tok/s, equal streams, spec stats,
     caches and launches), replayed step by step through plain decode;
     and one 7B
     forward step at position 1500 through attention_step_kv4 and through
     batched_decode_attention, kernels against plain versions;
  7. continuous batching and serving: the down_qkv chain kernel at m=1 and
     m=8 against its plain version and bit for bit against the standalone
     GEMV pair it replaces; 32 batch-1 decode steps at the 2048 bucket
     (fused_step, bf16 KV) with LLAMA_TPU_DOWN_QKV=1 and without it, in
     turns (equal streams, 31 chain launches a step); BatchEngine with 8
     slots serving 16 greedy requests of 32 tokens with prompts of 20 to
     1000 tokens,
     without and with the switch, on an engine that replays its chunk
     steps and slot-prefill blocks from CUDA graphs against one made with
     capture=False, in turns after the graph engine's untimed run
     (aggregate tokens/s, latency, launches per kernel variant, graph
     count, capture seconds and pool bytes; streams, caches and launches
     equal, the m=8 chain launched); profiles of one 8-step chunk of 8
     slots at positions around 1000, each way, without and with the
     chain; a check that dispatching a chunk on captured graphs does not
     synchronize with the one in flight; profiles of run()'s one-chunk
     lookahead each way and of a loop of synchronous steps from graphs
     over the same 4 chunks (run() also queues a fifth, which it
     discards: the lookahead's cost at the end of a drain); run()'s host
     time from graphs split into dispatch, fetch and the slot
     scheduler's calls, with the native and with the Python scheduler;
     the HTTP server (spec="ngram", a toy tokenizer) answering 8
     concurrent completions, 4 of them streamed, on a graph engine and on
     an eager one (equal streams, caches and launches), two replayed
     step by step through the single-sequence engine (each token within
     0.1 of the replayed argmax); and one 7B step at B=8 with the chain,
     kernels against plain versions;
  8. the retired chain experiment (tools/experiments/int4_chain.py), from
     llama_cu_awq_torch/experiments: ffn_chain (with the next layer's qkv)
     at m=1 and m=8, and mono_layer at m=1 over bf16 and int8 KV at
     position 1500 and at m=8 over bf16 KV at positions 960-1100, each
     against its plain version and against the launch sequence it
     replaces (composed_ms beside ms), bit for bit (mono's attention
     stage runs attention_step's split items); then e2e chain_step_7b:
     after a 1024-token prompt, 32 greedy decode steps at the 2048 bucket
     (a) through forward(attn_impl="fused_step"), (b) through
     attention_step and ffn_chain in each layer and (c) through
     mono_layer in each layer, in turns, for bf16 and int8 KV (decode
     tokens/s, launches per kernel a step; equal streams), with a
     profile of one step each; and one 7B step at B=8 through (a), (b)
     and (c) from the same random cache, (b)'s and (c)'s logits
     bit-equal to (a)'s.
  9. (run after phase 5) the engine's CUDA graphs
     (llama_cu_awq_torch/engine/graphs.py): every
     InferenceEngine path above already replays them (decode steps,
     forced prompt steps, prefill blocks, perplexity), with every launch
     count as before; this phase holds each against an engine made with
     capture=False, bit for bit (tokens and the whole cache) and launch
     for launch, in turns (eager, graph, graph, eager, after one untimed
     run each way): the main path (128 greedy steps, and once sampled at
     temperature 0.5, topp 0.6), fused_step over bf16 and int8 KV at the
     2048 bucket (64 steps after a 1024-token prompt) and the 1920-token
     prompt (time to first token); tok/s, TTFT, capture seconds and pool
     bytes per graph; profiles of one decode chunk and of one block at
     position 1024 each way; and the decode graph's design: a chunk of 16
     steps as 16 replays of the step graph against one graph of the
     whole chunk.
 10. (run last) --act-dtype float16 and float32: first an fp16 overflow
     sweep (the 8-token prompt's forward at depths 1-6 and 32 in fp16
     through the kernels and the plain versions, which must turn
     non-finite at the same depth, and the residual's largest |x| in
     f32: the synthetic weights' residual outgrows fp16 from the fourth
     layer, so the fp16 runs take F16_LAYERS = 2 layers at 7B's widths,
     the f32 runs all 32); then for each type the fp16 or f32 form of
     every kernel on its paths at 7B shapes against its plain version
     (the w4 down projection at m=1, 8 and 128 with an act residual and
     output, attention_step at position 1500, batched_decode_attention at
     B=8 over positions 960-1100, prefill_attention at T=128 and position
     1024, down_qkv at m=1; SDPA in the same type beside the attention
     rows), and end to end with the JAX CLI's embed and head type: 64
     greedy steps on the main path and a 1024-token prompt then 32
     fused_step steps at the 2048 bucket, each beside bf16 at the same
     depth (tok/s, time to first token, cache bytes), 16 batched steps, 8
     steps with the down_qkv chain, the perplexity of 1023 ids through the
     kernels and the plain versions (|delta ln ppl| <= 0.01), BatchEngine
     with 8 slots serving 8 requests through batched attention from
     graphs against capture=False (streams and caches equal), and one 7B
     step at position 1500, kernels against plain versions; last the AWQ
     ingest: one synthetic layer at 7B's widths through
     `python -m llama_cu_awq_torch.tools.pack_weights --model-dir`, the
     port's loader and the card, every projection bit-equal to the source
     tensors.
 11. (run last) the served head type and tensor parallelism. First the
     cost of the server's fp16 head (the checkpoint's fp16 embed and
     lm_head, as serve.main builds them at --tp 1; an fp16
     head takes the plain f32 product): the batch_engine workload (16
     greedy requests on 8 slots) and the serve_http one (8 completions
     through make_server, spec="ngram") on graph engines with the bf16
     head and with the fp16 head, in turns (tok/s or wall, graph pool
     bytes). Then 2 ranks, spawned processes sharing cuda:0 and joined
     over gloo, at Llama-2 7B's full widths and 32 layers, each holding
     its shard (parallel/tp.py shard_params) of the synthetic weights of
     seed 0: rank 0 times every kernel at its per-shard shapes against
     its plain version (the four w4 projections at m=1 and m=128, o and
     down as the f32 partials with no epilogue, the 16000-row head at m=1
     and m=128, attention_step over 16 heads at position 1500,
     prefill_attention at T=128 over 16 heads at position 1024; rows
     tagged tp2) while rank 1 waits; then the TP forward at T=1 (position
     1500, fused_step) and on a 128-token block (position 1024) against
     the single-device forward on the same weights and cache (2 % of the
     largest logit); a TP InferenceEngine (fused_step) made with
     capture=True, its CUDA graphs split at the collectives
     (engine/graphs.py), and one made with capture=False: 16 greedy
     steps from an 8-token prompt, the graph engine once untimed (the
     captures), then each way timed, the ranks' streams equal, the
     captured streams and whole caches equal to the eager ones bit for
     bit on both ranks, each token replayed through the single-device
     forward within that tolerance of its top logit; per way, an 8-step
     decode window twice: under torch.profiler (device operations and
     the host's launch calls a token), and with every collective between
     synchronizations (graph segments replayed, collectives and kernel
     launches a token; ms a token as collective ms and the rest); the
     graphs (segments a key, capture
     seconds, pool bytes); the perplexity of 255 ids each way (equal bit
     for bit) beside the single-device engine's (|delta ln ppl| <=
     0.01); a TP BatchEngine (rank 0 serves 4 greedy requests on 4
     slots, rank 1 follows) made each way: streams and caches equal bit
     for bit, each stream replayed the same way. Each rank's readings
     are gathered and printed by rank 0. Two ranks on one card with gloo
     through the host measure no tensor-parallel speed.
 12. (run last) `serve --dp 2 --tp 2` and the ppl matrix tool. Phase 4's
     seed-0 weights are written to a 7B `.bin` (full width, 32 layers)
     with the port's save_checkpoint, beside make_test_model's byte
     tokenizer at vocab 32000. serve.run_replicas, the server's own
     replica builder, runs 2 replicas of 2 ranks with every rank on
     cuda:0 over gloo (3 processes: this one holds shard 0 of both
     replicas and serves), every engine on CUDA graphs split at the
     collectives: 2 slots a replica, max_seq 512, spec="ngram";
     8 concurrent completions of 16 tokens, 4 of them streamed, prompts
     of 20-200 tokens, queued before the engine threads start (4 a
     replica); each reply held to the token ids its request was routed,
     each stream replayed through the single-device forward within 2 %
     of its top logit, every rank's exit code 0 (e2e dp2_tp2_serve_http:
     not a speed). Then the 8 rows of llama_cu_awq_torch/tools/ppl_matrix
     on 2 sequences of 128 letters from the seed, through its own
     functions, each under the launch counters (attention_step over the
     bf16, int8 and int4 caches, the int8 head's dense_gemv, the w4
     head's int4_matmul; the checkpoint's fp16 head of the other rows
     takes the plain f32 product, as the JAX tool's does): finite rows,
     each fused_step row within |delta ln ppl| <= 0.01 of its cache's
     einsum row, and `python -m llama_cu_awq_torch.tools.ppl_matrix
     --only "bf16 KV"` run once as a user runs it (beside the served
     run), its rows equal to these (e2e ppl_matrix_7b).
 13. (run last) the trainer, and a trained model through the kernels:
     llama_cu_awq_torch/tools/build_corpus --max-mb 1 over the installed
     packages' documentation; make_test_model's byte tokenizer at vocab 32000;
     tools/train_tiny at its full widths (dim 512, hidden 1536, 8 layers,
     batch 32 x 256) with 4 heads of 128 for 150 steps (the JAX default
     is 3000: the phase's one cut) in plain f32 on the card (step ms,
     tokens/s, peak memory, the logged losses; every loss finite, the
     last valid loss below the first and below ln 259, uniform over the
     ids the tokenizer emits; no inference kernel launched); one train
     step's loss and gradients from the trained params on the card against
     the CPU (rel 1e-4); pack_weights on its dump; then through the CLI in
     this process: 64 greedy tokens from 400 characters of valid.txt's
     first document, plain and --spec ngram, each held to an engine's
     tokens on the same weights and replayed through plain decode
     (replay_check; the acceptance rate on real text); tools/ppl_matrix's
     8 rows on valid.txt's first document through its own functions
     (finite; each fused_step row within 0.01 of its einsum row and
     launching its attention kernel); and the perplexity of the first 3
     documents (|delta ln ppl| <= 0.01 against --device cpu, run as its
     own process beside the card runs; within 0.25 of the float model's
     ln ppl through train_tiny's forward_loss); each run under the launch
     counters, with the launches per kernel table row over the phase.
 14. (run last) the bench, run as a user runs it: `python -m
     llama_cu_awq_torch.bench` as its own process at Llama-2 7B's full
     widths and 32 layers on seed-0 weights: (a) the default decode run
     at 1 repeat (plain, spec in a child process and a 3-repeat plain
     re-bracket; the spec stream equal to the plain one or replayed
     within 0.1), (b) --mode prefill of a
     1920-token prompt, (c) --mode batch with 16 slots (its default), 32
     requests (its default) of 64 steps (three streams replayed, the last
     from a reused slot), (d) --mode batch with 8 slots, 16 requests of
     64 steps and 1000-token prompts every 4th, (e) 256 fused_step
     decode steps after a 1024-token prompt, (f) 32 steps over the int4
     cache after 1920 tokens, (g) the int8 lm_head's plain leg, (h)
     --profile of (a)'s plain leg cut to 64 steps, then
     tools/trace_summary --families on its trace, (i) --tp 2 over gloo on
     cuda:0 (the path on split graphs, not a TP speed) and (j)
     tools/bench_scaling at tiny (tp 1, and tp 2 over gloo on cuda:0 on
     split graphs, each point through the bench's batch mode and its
     replay gate). Each exits 0; each result
     line's keys and metric name
     equal the repository's bench.py's for the same flags (BENCH_RUNS,
     its TPU-tuned defaults left out); each run's timed legs launched
     the kernels of their path (the bench's "launches" lines on stderr);
     (a), (b) and (c) are printed beside this script's own readings of
     the same workloads (e2e generate_benchmark, prefill, batch_engine),
     which are not a gate: host clocks move between processes.
 15. (run last) data-parallel x tensor-parallel across processes: (a)
     llama_cu_awq_torch/tools/multihost_worker --config 7b (full width,
     32 layers, each rank's shard of phase 4's seed-0 weights) as 2 host
     processes of 2 ranks each, all 4 on cuda:0 over gloo, joined
     through a localhost coordinator as one world (dp 2 rows of tp 2):
     a batch of 4 (2 slots a rank, its batch-sharded cache), 8
     teacher-forced T=1 steps at window 32, the rows gathered over dp
     after each step; both hosts' checksums equal, each rank's logits
     within 2 % of the largest logit of the single-device forward on the
     same weights and inputs in this process, 64 all-reduces, 1 logits
     gather and 1 dp gather a step on every rank, each rank's launches
     by kernel (e2e multihost_dp2_tp2: ms a step, not a dp or TP speed);
     (b) tools/bench_scaling --nprocs 2 --tps 1,2 at 7B as 2 processes
     meeting at a barrier before each width, each its own replica (tp 2:
     2 ranks of its own on cuda:0), 2 slots, 2 requests of 8 steps, each
     point through the bench's batch mode and its replay gate; then the
     kernel rows of (a)'s shapes: the four w4 projections at m=2 on the
     tp 2 shards and the 16000-row head at m=2, each against its plain
     version.
The kernel phase also times one PyTorch call that computes each row's
product where there is one (library_ms): F.linear, F.scaled_dot_product_
attention, torch._weight_int4pack_mm, torch._weight_int8pack_mm; the
port never calls them.
Prints the card line and a {"kernels": [...]} line, then
{"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# bf16 on the tensor cores, dense, same source: every operand of these
# kernels is bf16 or an int code that bf16 holds exactly, so this is the
# card's peak for their type
BF16_FLOPS = 989e12
L2_FLUSH_BYTES = 64 << 20  # > the 50 MB L2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def toolkit_versions() -> dict:
    """The driver's version (nvidia-smi) and nvcc's release line: CUDA
    graphs of programmatic dependent and cooperative launches need a
    recent CUDA 12 runtime and driver."""
    from llama_cu_awq_torch.ops.cuda import _build

    drv = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-2:]
    return {"driver": drv, "nvcc": " ".join(nvcc)}


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    tb, tf = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


class Timer:
    """Device time of one call: the L2 is flushed, the stream is held by a
    spin kernel while the host enqueues the call, and CUDA events around
    the call give its time on the card; the median over iters."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn, iters=15, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def check_close(name, got, want, rtol, atol, why):
    """|got - want| <= atol + rtol * |want| elementwise; returns the max
    absolute error and the tolerance."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if not bool(g.isfinite().all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {err.numel()} elements outside "
            f"rtol={rtol} atol={atol} (max abs err {float(err.max()):.3e})")
    print(json.dumps({"check": name, "max_abs_err": float(err.max()),
                      "rtol": rtol, "atol": atol, "why": why}), flush=True)
    return dict(max_abs_err=float(err.max()), rtol=rtol, atol=atol)


def int4_source(variant: str) -> str:
    """The source an int4 variant key's route names (gemv/... or gemm/...)."""
    kernel = "int4_gemm" if "/gemm/" in f"/{variant}" else "int4_gemv"
    return f"llama_cu_awq_torch/csrc/{kernel}.cu"


def random_qtensor(torch, QTensor, n_in, n_out, g):
    groups = -(-n_in // 128)
    qw = torch.randint(0, 256, (n_out, n_in // 2), dtype=torch.uint8,
                       device="cuda", generator=g).view(torch.int32)
    scales = (0.01 * (1 + 0.1 * torch.randn(n_out, groups, device="cuda",
                                            generator=g))).half()
    zeros = torch.randint(0, 16, (n_out, groups), dtype=torch.uint8,
                          device="cuda", generator=g)
    return QTensor(qw, scales, zeros, n_in, n_out)


def int4pack_library(torch, qt, x):
    """torch._weight_int4pack_mm on qt's weight, converted once here,
    outside the timed call: the library's w4-g128 matmul (bf16 x, nibbles
    packed two a byte, bf16 scale and offset per group and column, with
    w = (q - 8) * s + (8 - z) * s). Returns the call; it computes x @ W
    with the scales and offsets rounded to bf16, and none of the fused
    kernels' prologue or epilogue."""
    shifts = 4 * torch.arange(8, device="cuda", dtype=torch.int32)
    q = ((qt.qw[:, :, None] >> shifts) & 0xF).reshape(qt.n_out, -1)
    w_u8 = (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8)
    packed = torch._convert_weight_to_int4pack(w_u8, 8)
    s, z = qt.scales.float(), qt.zeros.float()
    sz = torch.stack([s, (8 - z) * s], -1).transpose(0, 1).contiguous()
    sz = sz.bfloat16()
    xb = x.bfloat16().contiguous()
    return lambda: torch._weight_int4pack_mm(xb, packed, 128, sz)


def linear_yardstick(torch, timer, qt, x):
    """F.linear of x on qt's weight dequantized to bf16 (converted once,
    outside the timed call): the card's tensor-core rate on the same
    product, a yardstick and not the same function (it reads no codes and
    rounds the weight to bf16)."""
    w = qt.dequantize_t().bfloat16()
    xb = x.bfloat16().contiguous()
    return timer(lambda: torch.nn.functional.linear(xb, w))


def sdpa_library(torch, q, k_rows, v_rows, mask=None, dtype=None):
    """F.scaled_dot_product_attention of q (B, H, D) over the given rows
    (B, rows, Hkv, D), in bf16 or dtype, laid out as it wants them outside
    the timed call (GQA through enable_gqa); no RoPE and no row
    quantize."""
    dt = dtype or torch.bfloat16
    qh = q.to(dt)[:, :, None, :].contiguous()
    kh = k_rows.to(dt).transpose(1, 2).contiguous()
    vh = v_rows.to(dt).transpose(1, 2).contiguous()
    gqa = kh.shape[1] != qh.shape[1]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=gqa)


INT4_TOL = dict(rtol=2e-2, atol=2e-3, why=(
    "the int4 bar of tests/test_pallas_int4.py:68; kernel and plain "
    "dequantize exactly alike, sum in f32 in another order, and a bf16 "
    "output or staged x may round one ulp apart"))
GEMV_TOL = dict(rtol=1e-3, atol=1e-4, why=(
    "operands widen exactly to f32; only the order of the f32 sums differs"))
ATTN_TOL = dict(rtol=2e-2, atol=2e-3, why=(
    "same splits as the plain version; f32 sums in another order can "
    "move p by one bf16 ulp before the PV product"))


def chain_tol(want):
    """ffn_chain's and mono_layer's bar against their plain versions:
    INT4_TOL per stage plus one bf16 ulp at the output's largest
    magnitude."""
    top = float(want.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return dict(rtol=INT4_TOL["rtol"], atol=INT4_TOL["atol"] + ulp, why=(
        "the int4 bar per stage, plus one bf16 ulp at the output's largest "
        "magnitude: kernel and plain sum each stage in another f32 order, "
        "so a bf16 row of one stage (x1, gate_up, the attention rows) may "
        "round one ulp apart, and out = down + x1 carries a flip of x1 "
        "unchanged"))


def launched_variant(fn):
    """Call fn, which launches one kernel once; return its result and
    the "kernel/variant" key its wrapper counted."""
    from llama_cu_awq_torch.ops.cuda import VARIANT_LAUNCHES, reset_launches

    reset_launches()
    out = fn()
    keys = list(VARIANT_LAUNCHES)
    if len(keys) != 1 or VARIANT_LAUNCHES[keys[0]] != 1:
        raise AssertionError(f"expected one launch, counted {keys}")
    return out, keys[0]


def kernel_phase(torch, timer, rows):
    """Every kernel and variant at 7B shapes. Each row names the run of
    e2e_phase or prefill_phase whose launches it reports (`path`), or None
    where no run launches its variant: GQA attention (7B is MHA) and
    int4_matmul on the qkv shape (the forward takes int4_matmul_fused
    there) are checks only."""
    from llama_cu_awq_torch.ops.cuda.attention_step import (
        attention_step, rope_rows)
    from llama_cu_awq_torch.ops.cuda.dense_gemv import dense_gemv
    from llama_cu_awq_torch.ops.cuda.int4_matmul import (int4_matmul,
                                                         int4_matmul_fused)
    from llama_cu_awq_torch.quant.int8 import quantize_dense_int8
    from llama_cu_awq_torch.quant.qtensor import QTensor

    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    dim, hid, vocab = 4096, 11008, 32000

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    # --- int4_matmul_fused, the four projections of a 7B layer, at a
    # decode step (m=1, the GEMV), a serving step of 8 slots (m=8, the
    # GEMV), one of the bench's 16 slots (m=16, the GEMV's two 8-row
    # passes; their launches are bench (c)'s, phase 14) and a prefill
    # block (m=128, the GEMM) ---
    cases = [
        ("qkv_prescale", dim, 3 * dim, "prescale"),
        ("o_residual_ss", dim, dim, "residual"),
        ("gate_up_prescale", dim, 2 * hid, "prescale"),
        ("down_silu_residual_ss", hid, dim, "silu"),
    ]
    for m, prefix, path in ((1, "", "main"), (8, "m8_", "batch_engine"),
                            (16, "m16_", "bench_c_batch"),
                            (128, "gemm_", "prefill")):
        for tag, n_in, n_out, kind in cases:
            tag = prefix + tag
            qt = random_qtensor(torch, QTensor, n_in, n_out, g)
            x = randn(m, n_in)
            if kind == "prescale":
                ss = torch.rand(m, 1, device="cuda", generator=g) + 0.5
                nw = torch.rand(n_in, device="cuda", generator=g) + 0.5
                kw = dict(prescale=(ss, nw))
                extra = [ss, nw]
            else:
                res = randn(m, n_out)
                kw = dict(residual=res, emit_ss_eps=1e-5)
                extra = [res]
                if kind == "silu":
                    kw["silu_u"] = randn(m, n_in)
                    extra.append(kw["silu_u"])
            (out, ss_k), variant = launched_variant(
                lambda: int4_matmul_fused(x, qt, **kw))
            ref, ss_p = int4_matmul_fused(x, qt, plain=True, **kw)
            torch.cuda.synchronize()
            chk = check_close(f"int4_matmul_fused/{tag}", out, ref,
                              **INT4_TOL)
            if ss_p is not None:
                check_close(f"int4_matmul_fused/{tag}/ss", ss_k, ss_p,
                            **INT4_TOL)
            b, src = bound_ms(
                nbytes(qt.qw, qt.scales, qt.zeros, x, out, ss_k, *extra),
                2 * m * n_in * n_out)
            row = dict(
                name=f"int4_matmul_fused/{tag}", kernel="int4_matmul_fused",
                route="cuda", source=int4_source(variant),
                replaces="llama_cu_awq_tpu/ops/pallas/int4_matmul.py:543",
                variant=variant, path=path, **chk,
                ms=timer(lambda: int4_matmul_fused(x, qt, **kw)),
                plain_ms=timer(lambda: int4_matmul_fused(x, qt, plain=True,
                                                         **kw)),
                bound_ms=b, bound_by=src,
                library_ms=timer(int4pack_library(torch, qt, x)))
            if m == 128:
                row["linear_ms"] = linear_yardstick(torch, timer, qt, x)
            rows.append(row)

    row_independence(torch, g)
    gemm_row_independence(torch, g)

    # --- int4_matmul: the w4 lm_head at m=1, 16- and 128-row blocks on
    # qkv (no 7B run launches int4_matmul at the qkv shape: the forward
    # takes int4_matmul_fused there) ---
    for tag, m, n_in, n_out, path in (
            ("m1_lm_head", 1, dim, vocab, "lm_head_w4"),
            ("m16_qkv", 16, dim, 3 * dim, None),
            ("gemm_m128_qkv", 128, dim, 3 * dim, None)):
        qt = random_qtensor(torch, QTensor, n_in, n_out, g)
        x = randn(m, n_in)
        out, variant = launched_variant(lambda: int4_matmul(x, qt))
        ref = int4_matmul(x, qt, plain=True)
        torch.cuda.synchronize()
        chk = check_close(f"int4_matmul/{tag}", out, ref, **INT4_TOL)
        b, src = bound_ms(nbytes(qt.qw, qt.scales, qt.zeros, x, out),
                          2 * m * n_in * n_out)
        lib = int4pack_library(torch, qt, x)
        lib_out = lib()
        torch.cuda.synchronize()
        print(json.dumps({"library_check": f"int4_matmul/{tag}",
                          "call": "torch._weight_int4pack_mm",
                          "max_abs_err_vs_plain": float(
                              (lib_out.float() - ref).abs().max()),
                          "max_abs_plain": float(ref.abs().max())}),
              flush=True)
        row = dict(
            name=f"int4_matmul/{tag}", kernel="int4_matmul", route="cuda",
            source=int4_source(variant),
            replaces="llama_cu_awq_tpu/ops/pallas/int4_matmul.py:281",
            variant=variant, path=path, **chk, ms=timer(lambda: int4_matmul(x, qt)),
            plain_ms=timer(lambda: int4_matmul(x, qt, plain=True)),
            bound_ms=b, bound_by=src, library_ms=timer(lib))
        if m == 128:
            row["linear_ms"] = linear_yardstick(torch, timer, qt, x)
        rows.append(row)

    # --- dense_gemv: the 7B lm_head, bf16 and int8 rows; m=8 the serving
    # step's head, m=128 a prefill block's (every row for perplexity) ---
    w = (randn(vocab, dim, dtype=torch.float32) * 0.02).bfloat16()
    w8 = quantize_dense_int8(w)
    x1, x8, x128 = randn(1, dim), randn(8, dim), randn(128, dim)
    for tag, x, args, path in (
            ("bf16", x1, (w,), "main"),
            ("int8", x1, (w8.w8, w8.scale), "lm_head_int8"),
            ("bf16_m8", x8, (w,), "batch_engine"),
            ("bf16_m128", x128, (w,), "prefill"),
            ("int8_m128", x128, (w8.w8, w8.scale), "prefill_lm_head_int8")):
        out, variant = launched_variant(lambda: dense_gemv(x, *args))
        ref = dense_gemv(x, *args, plain=True)
        torch.cuda.synchronize()
        chk = check_close(f"dense_gemv/{tag}", out, ref, **GEMV_TOL)
        b, src = bound_ms(nbytes(*args, x, out),
                          2 * x.shape[0] * dim * vocab)
        # the library's product: F.linear on the bf16 head, and
        # torch._weight_int8pack_mm (bf16 x, int8 rows, f32 row scales)
        # on the int8 one
        if args[0] is w:
            lib = timer(lambda: torch.nn.functional.linear(x, w))
        else:
            s8 = w8.scale.reshape(-1).contiguous()
            lib = timer(lambda: torch._weight_int8pack_mm(x, w8.w8, s8))
        rows.append(dict(
            name=f"dense_gemv/{tag}", kernel="dense_gemv", route="cuda",
            source="llama_cu_awq_torch/csrc/dense_gemm.cu",
            replaces="llama_cu_awq_tpu/ops/pallas/dense_gemv.py:147",
            variant=variant, path=path, **chk, ms=timer(lambda: dense_gemv(x, *args)),
            plain_ms=timer(lambda: dense_gemv(x, *args, plain=True)),
            bound_ms=b, bound_by=src, library_ms=lib))

    # --- attention_step: D=128, window 2048, pos 1500 ---
    S, D, H, pos_v = 2048, 128, 32, 1500
    pos = torch.tensor([pos_v], dtype=torch.int32, device="cuda")
    cos2, sinm = rope_rows(pos, D, 10000.0)
    for n_kv in (32, 8):
        qkv = randn(1, (H + 2 * n_kv) * D)
        for quant in (False, True):
            tag = f"{'mha' if n_kv == H else 'gqa'}{H}_{n_kv}_" + (
                "int8" if quant else "bf16")
            if quant:
                kc = torch.randint(-127, 128, (1, S, n_kv, D),
                                   dtype=torch.int8, device="cuda",
                                   generator=g)
                vc = torch.randint(-127, 128, (1, S, n_kv, D),
                                   dtype=torch.int8, device="cuda",
                                   generator=g)
                ks = torch.rand(1, S, n_kv, device="cuda", generator=g) * 0.02
                vs = torch.rand(1, S, n_kv, device="cuda", generator=g) * 0.02
            else:
                kc, vc = randn(1, S, n_kv, D), randn(1, S, n_kv, D)
                ks = vs = None
            args = (qkv, kc, vc, pos, cos2, sinm, ks, vs)
            outs, variant = launched_variant(
                lambda: attention_step(*args, n_heads=H))
            path = None
            if n_kv == H:
                path = "fused_step_int8kv" if quant else "fused_step_bf16"
            refs = attention_step(*args, n_heads=H, plain=True)
            torch.cuda.synchronize()
            chk = check_close(f"attention_step/{tag}", outs[0], refs[0],
                              **ATTN_TOL)
            for i, part in ((1, "k_new"), (2, "v_new"), (3, "k_s"),
                            (4, "v_s")):
                if refs[i] is not None and not torch.equal(outs[i], refs[i]):
                    raise AssertionError(
                        f"attention_step/{tag}: {part} differs from the "
                        f"plain version (must be bit-equal: same IEEE "
                        f"rope, division and round-half-even)")
            hist = pos_v * n_kv * D * kc.element_size() * 2
            hist += pos_v * n_kv * 4 * 2 if quant else 0
            b, src = bound_ms(hist + nbytes(qkv, cos2, sinm, *outs),
                              4 * (pos_v + 1) * H * D)
            # the window's pos + 1 keys (history and the current row)
            lib = None if quant else timer(sdpa_library(
                torch, qkv[:, :H * D].reshape(1, H, D), kc[:, :pos_v + 1],
                vc[:, :pos_v + 1]))
            rows.append(dict(
                name=f"attention_step/{tag}", kernel="attention_step",
                route="cuda",
                source="llama_cu_awq_torch/csrc/attention_step.cu",
                replaces="llama_cu_awq_tpu/ops/pallas/attention_step.py:425",
                variant=variant, path=path, **chk,
                ms=timer(lambda: attention_step(*args, n_heads=H)),
                plain_ms=timer(lambda: attention_step(*args, n_heads=H,
                                                      plain=True), iters=5),
                bound_ms=b, bound_by=src, library_ms=lib))
    attention_step_b8_row(torch, timer, rows, g)
    attention_step_kv4_rows(torch, timer, rows, g)
    batched_attention_rows(torch, timer, rows, g)
    prefill_attention_rows(torch, timer, rows, g)
    gemm_crossover(torch, timer, g)
    gemm_split_sweep(torch, timer, g)
    rows_13b(torch, timer, rows, g)
    for r in rows:
        print(json.dumps({"kernel_check": r["name"], "kernel_ms": r["ms"],
                          **{k: r[k] for k in (
                              "max_abs_err", "rtol", "atol", "plain_ms",
                              "library_ms", "bound_ms", "bound_by")},
                          **({"linear_ms": r["linear_ms"]}
                             if "linear_ms" in r else {})}),
              flush=True)


def row_independence(torch, g):
    """Each row of an m=8 call bit for bit against the m=1 call on that
    row alone, at 7B shapes: int4_matmul_fused on the four projections,
    down_qkv and ffn_chain (with the next qkv). The tile's sums depend on
    n_in alone (int4_gemv.cuh), so a row gives the same bits in whatever
    batch it is in; a BatchEngine slot's stream equals the single
    sequence's only because of it. Raises on a difference."""
    from llama_cu_awq_torch.experiments.int4_chain import ffn_chain
    from llama_cu_awq_torch.ops.cuda.down_qkv import down_qkv_fused
    from llama_cu_awq_torch.ops.cuda.int4_matmul import int4_matmul_fused
    from llama_cu_awq_torch.quant.qtensor import QTensor

    dim, hid, m = 4096, 11008, 8

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g).bfloat16()

    def check(name, fn):
        """fn(rows) runs the kernel on those rows of this case's inputs."""
        full = fn(slice(0, m))
        diff, equal = 0.0, True
        for i in range(m):
            for a, b in zip(full, fn(slice(i, i + 1))):
                if a is None:
                    continue
                a_i = a.reshape(m, -1)[i]
                diff = max(diff, float((a_i.float() - b.float().reshape(-1))
                                       .abs().max()))
                equal = equal and torch_equal(a_i, b)
        torch.cuda.synchronize()
        print(json.dumps({"check": f"row_independence/{name}", "rows": m,
                          "bit_equal": equal, "max_abs_err": diff,
                          "why": "every row of an m=8 call against the m=1 "
                                 "call on that row: the tile's sums depend "
                                 "on n_in alone (int4_gemv.cuh)"}),
              flush=True)
        if not equal:
            raise AssertionError(f"row_independence/{name}: a row of the "
                                 f"m={m} call differs from the m=1 call "
                                 f"(max abs err {diff})")

    for tag, n_in, n_out, kind in (
            ("qkv_prescale", dim, 3 * dim, "prescale"),
            ("o_residual_ss", dim, dim, "residual"),
            ("gate_up_prescale", dim, 2 * hid, "prescale"),
            ("down_silu_residual_ss", hid, dim, "silu")):
        qt = random_qtensor(torch, QTensor, n_in, n_out, g)
        x, res, u = randn(m, n_in), randn(m, n_out), randn(m, n_in)
        ss = torch.rand(m, 1, device="cuda", generator=g) + 0.5
        nw = torch.rand(n_in, device="cuda", generator=g) + 0.5

        def fused(r, qt=qt, x=x, res=res, u=u, ss=ss, nw=nw, kind=kind):
            if kind == "prescale":
                return int4_matmul_fused(x[r], qt, prescale=(ss[r], nw))
            return int4_matmul_fused(
                x[r], qt, residual=res[r], emit_ss_eps=1e-5,
                silu_u=u[r] if kind == "silu" else None)

        check(f"int4_matmul_fused/{tag}", fused)
    wd = random_qtensor(torch, QTensor, hid, dim, g)
    wq = random_qtensor(torch, QTensor, dim, 3 * dim, g)
    wo = random_qtensor(torch, QTensor, dim, dim, g)
    wgu = random_qtensor(torch, QTensor, dim, 2 * hid, g)
    nw = torch.rand(dim, device="cuda", generator=g) + 0.5
    gate, up = randn(m, 2 * hid).chunk(2, dim=-1)
    attn, res = randn(m, dim), randn(m, dim)
    check("down_qkv", lambda r: down_qkv_fused(
        gate[r], up[r], res[r], wd, wq, nw, eps=1e-5,
        out_dtype=torch.bfloat16))
    check("ffn_chain", lambda r: ffn_chain(
        attn[r], res[r], nw, wo, wgu, wd, eps=1e-5, wqkv_next=wq,
        attn_norm_next=nw))


def gemm_row_independence(torch, g):
    """The GEMM at 7B's four projections: the first 65 and 100 rows of a
    128-row call, each called alone, and a second 128-row call, bit for
    bit against the first 128-row call. Every sum's order depends on the
    weight's shape and the tile, never on m or a row's neighbours, and
    no atomics (int4_gemm.cu). Raises on a difference."""
    from llama_cu_awq_torch.ops.cuda.int4_matmul import int4_matmul_fused
    from llama_cu_awq_torch.quant.qtensor import QTensor

    dim, hid, m = 4096, 11008, 128

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g).bfloat16()

    for tag, n_in, n_out, kind in (
            ("qkv_prescale", dim, 3 * dim, "prescale"),
            ("o_residual_ss", dim, dim, "residual"),
            ("gate_up_prescale", dim, 2 * hid, "prescale"),
            ("down_silu_residual_ss", hid, dim, "silu")):
        qt = random_qtensor(torch, QTensor, n_in, n_out, g)
        x, res, u = randn(m, n_in), randn(m, n_out), randn(m, n_in)
        ss = torch.rand(m, 1, device="cuda", generator=g) + 0.5
        nw = torch.rand(n_in, device="cuda", generator=g) + 0.5

        def run(r, qt=qt, x=x, res=res, u=u, ss=ss, nw=nw, kind=kind):
            if kind == "prescale":
                return int4_matmul_fused(x[:r], qt, prescale=(ss[:r], nw))
            return int4_matmul_fused(
                x[:r], qt, residual=res[:r], emit_ss_eps=1e-5,
                silu_u=u[:r] if kind == "silu" else None)

        full = run(m)
        equal, diff = True, 0.0
        for r in (65, 100, m):
            for a, b in zip(full, run(r)):
                if a is None:
                    continue
                diff = max(diff, float((a[:r].float() - b.float())
                                       .abs().max()))
                equal = equal and torch_equal(a[:r], b)
        torch.cuda.synchronize()
        print(json.dumps({"check": f"row_independence/gemm_{tag}",
                          "rows": [65, 100, m], "bit_equal": equal,
                          "max_abs_err": diff,
                          "why": "the first 65 and 100 rows of a 128-row "
                                 "GEMM call called alone, and the call "
                                 "again: sums ordered by the weight's "
                                 "shape and the tile alone, no atomics"}),
              flush=True)
        if not equal:
            raise AssertionError(f"row_independence/gemm_{tag}: rows differ "
                                 f"between calls (max abs err {diff})")


B8_POSITIONS = (1024, 1000, 1100, 990, 1050, 1020, 1075, 960)


def attention_step_b8_inputs(torch, g):
    """attention_step's arguments at B=8, bf16 KV, 32 MHA heads of 128,
    positions 960-1100 over a 2048-row cache: BatchEngine's decode step at
    the 1024 and 2048 windows (attn_impl "auto")."""
    from llama_cu_awq_torch.ops.cuda.attention_step import rope_rows

    S, D, H = 2048, 128, 32
    pos = torch.tensor(B8_POSITIONS, dtype=torch.int32, device="cuda")
    cos2, sinm = rope_rows(pos, D, 10000.0)
    B = len(B8_POSITIONS)
    qkv, kc, vc = (torch.randn(*shape, device="cuda", generator=g).bfloat16()
                   for shape in ((B, 3 * H * D), (B, S, H, D), (B, S, H, D)))
    return (qkv, kc, vc, pos, cos2, sinm, None, None)


def attention_step_b8_row(torch, timer, rows, g):
    """attention_step at B=8 (attention_step_b8_inputs), the variant
    BatchEngine launches, against its plain version and SDPA over each
    slot's pos + 1 rows under a mask."""
    from llama_cu_awq_torch.ops.cuda.attention_step import attention_step

    H, D = 32, 128
    args = attention_step_b8_inputs(torch, g)
    qkv, kc, vc, pos = args[:4]
    B = qkv.shape[0]
    outs, variant = launched_variant(lambda: attention_step(*args,
                                                            n_heads=H))
    refs = attention_step(*args, n_heads=H, plain=True)
    torch.cuda.synchronize()
    name = "attention_step/mha32_32_bf16_b8"
    chk = check_close(name, outs[0], refs[0], **ATTN_TOL)
    for i, part in ((1, "k_new"), (2, "v_new")):
        if not torch.equal(outs[i], refs[i]):
            raise AssertionError(f"{name}: {part} differs from the plain "
                                 f"version (must be bit-equal)")
    hist = sum(B8_POSITIONS) * H * D * 2 * 2
    b, src = bound_ms(hist + nbytes(qkv, *args[4:6], *outs),
                      4 * sum(p + 1 for p in B8_POSITIONS) * H * D)
    top = max(B8_POSITIONS) + 1
    mask = (torch.arange(top, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]
    lib = timer(sdpa_library(torch, qkv[:, :H * D].reshape(B, H, D),
                             kc[:, :top], vc[:, :top], mask))
    rows.append(dict(
        name=name, kernel="attention_step", route="cuda",
        source="llama_cu_awq_torch/csrc/attention_step.cu",
        replaces="llama_cu_awq_tpu/ops/pallas/attention_step.py:425",
        variant=variant, path="batch_engine", **chk,
        ms=timer(lambda: attention_step(*args, n_heads=H)),
        plain_ms=timer(lambda: attention_step(*args, n_heads=H, plain=True),
                       iters=5),
        bound_ms=b, bound_by=src, library_ms=lib))


def attention_step_kv4_rows(torch, timer, rows, g):
    """attention_step over the int4 cache at 7B's head shape (and GQA
    32/8, check only): position 1500 over a 2048-row cache of random
    packed bytes (every code -8..7) and scales. No PyTorch call reads an
    int4-packed cache, so there is no library time."""
    from llama_cu_awq_torch.ops.cuda.attention_step import (
        attention_step, rope_rows)

    S, D, H, pos_v = 2048, 128, 32, 1500
    pos = torch.tensor([pos_v], dtype=torch.int32, device="cuda")
    cos2, sinm = rope_rows(pos, D, 10000.0)
    for n_kv in (32, 8):
        qkv = torch.randn(1, (H + 2 * n_kv) * D, device="cuda",
                          generator=g).bfloat16()
        kc, vc = (torch.randint(-128, 128, (1, S, n_kv, D // 2),
                                dtype=torch.int8, device="cuda", generator=g)
                  for _ in range(2))
        ks, vs = (torch.rand(1, S, n_kv, device="cuda", generator=g) * 0.2
                  for _ in range(2))
        tag = f"{'mha' if n_kv == H else 'gqa'}{H}_{n_kv}_int4"
        args = (qkv, kc, vc, pos, cos2, sinm, ks, vs)
        outs, variant = launched_variant(
            lambda: attention_step(*args, n_heads=H, kv_bits=4))
        refs = attention_step(*args, n_heads=H, kv_bits=4, plain=True)
        torch.cuda.synchronize()
        chk = check_close(f"attention_step/{tag}", outs[0], refs[0],
                          **ATTN_TOL)
        for i, part in ((1, "k_new"), (2, "v_new"), (3, "k_s"), (4, "v_s")):
            if not torch.equal(outs[i], refs[i]):
                raise AssertionError(
                    f"attention_step/{tag}: {part} differs from the plain "
                    f"version (must be bit-equal: same IEEE rope, scale, "
                    f"round-half-even, clip and packing)")
        hist = pos_v * n_kv * (D // 2 + 4) * 2
        b, src = bound_ms(hist + nbytes(qkv, cos2, sinm, *outs),
                          4 * (pos_v + 1) * H * D)
        rows.append(dict(
            name=f"attention_step/{tag}", kernel="attention_step_kv4",
            route="cuda", source="llama_cu_awq_torch/csrc/attention_step.cu",
            replaces="llama_cu_awq_tpu/ops/pallas/attention_step.py:569",
            variant=variant, path="kv4" if n_kv == H else None, **chk,
            ms=timer(lambda: attention_step(*args, n_heads=H, kv_bits=4)),
            plain_ms=timer(lambda: attention_step(
                *args, n_heads=H, kv_bits=4, plain=True), iters=5),
            bound_ms=b, bound_by=src, library_ms=None))


def batched_attention_rows(torch, timer, rows, g):
    """batched_decode_attention at 7B's head shape over a 2048-row cache
    that holds the current row: one slot at position 1500 (bf16 and int8
    early exit, bf16 static, the variants the batched runs launch), and 8
    slots at positions around 1024 (bf16 and int8, check only). The bound
    counts the rows each slot's answer depends on (rows <= pos[b]) for
    both variants: the static one reads the whole window by design. The
    bf16 rows are also timed against F.scaled_dot_product_attention over
    the same rows (a boolean mask for mixed positions)."""
    from llama_cu_awq_torch.ops.cuda.batched_attention import (
        batched_decode_attention)

    S, D, H = 2048, 128, 32
    cases = (
        ("b1_bf16", (1500,), False, True, "batched_bf16"),
        ("b1_int8", (1500,), True, True, "batched_int8kv"),
        ("b1_bf16_static", (1500,), False, False, "batched_static"),
        ("b8_bf16", (1024, 1000, 1100, 990, 1050, 1020, 1075, 960), False,
         True, None),
        ("b8_int8", (1024, 1000, 1100, 990, 1050, 1020, 1075, 960), True,
         True, None))
    for tag, positions, quant, early, path in cases:
        B = len(positions)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        q = torch.randn(B, H, D, device="cuda", generator=g)
        if quant:
            kc, vc = (torch.randint(-127, 128, (B, S, H, D), dtype=torch.int8,
                                    device="cuda", generator=g)
                      for _ in range(2))
            ks, vs = (torch.rand(B, S, H, device="cuda", generator=g) * 0.02
                      for _ in range(2))
        else:
            kc, vc = (torch.randn(B, S, H, D, device="cuda",
                                  generator=g).bfloat16() for _ in range(2))
            ks = vs = None
        args = (q, kc, vc, pos, ks, vs)
        kw = dict(attn_len=S, early_exit=early)
        out, variant = launched_variant(
            lambda: batched_decode_attention(*args, **kw))
        ref = batched_decode_attention(*args, plain=True, **kw)
        torch.cuda.synchronize()
        chk = check_close(f"batched_decode_attention/{tag}", out, ref,
                          **ATTN_TOL)
        n_rows = sum(p + 1 for p in positions)
        b, src = bound_ms(n_rows * H * (D * kc.element_size()
                                        + (4 if quant else 0)) * 2
                          + nbytes(q, pos, out), 4 * n_rows * H * D)
        lib = None
        if not quant:
            top = max(positions) + 1
            mask = None
            if B > 1:
                s_idx = torch.arange(top, device="cuda")
                mask = (s_idx[None, :] <= pos[:, None])[:, None, None, :]
            lib = timer(sdpa_library(torch, q, kc[:, :top], vc[:, :top],
                                     mask))
        rows.append(dict(
            name=f"batched_decode_attention/{tag}",
            kernel="batched_decode_attention", route="cuda",
            source="llama_cu_awq_torch/csrc/batched_attention.cu",
            replaces="llama_cu_awq_tpu/ops/pallas/batched_attention.py:179",
            variant=variant, path=path, **chk,
            ms=timer(lambda: batched_decode_attention(*args, **kw)),
            plain_ms=timer(lambda: batched_decode_attention(
                *args, plain=True, **kw), iters=5),
            bound_ms=b, bound_by=src, library_ms=lib))


def prefill_attention_rows(torch, timer, rows, g):
    """prefill_attention at 7B's head shape (and GQA 32/8, check only):
    128-token blocks at positions 0 (a prompt's first block), 1024 and
    1920 (a 2048-token prompt's last block) over a 2048-row cache. The
    bf16 rows are also timed against F.scaled_dot_product_attention over
    the keys the block sees, with the causal mask (GQA through
    enable_gqa)."""
    B, T, S, D, H = 1, 128, 2048, 128, 32
    for pos_v in (0, 1024, 1920):
        suffix = "" if pos_v == 1024 else f"_pos{pos_v}"
        for n_kv in (32, 8):
            for quant in (False, True):
                tag = (f"{'mha' if n_kv == H else 'gqa'}{H}_{n_kv}_"
                       f"{'int8' if quant else 'bf16'}{suffix}")
                path = (None if n_kv != H else
                        "prefill_int8kv" if quant else "prefill")
                prefill_attention_row(torch, timer, rows, g, tag, path, B,
                                      T, S, D, H, n_kv, pos_v, quant)


def prefill_attention_row(torch, timer, rows, g, tag, path, B, T, S, D, H,
                          n_kv, pos_v, quant):
    """One prefill_attention row: a block of T tokens at pos_v over an
    S-row cache of random rows, kernel against plain, timed beside its
    bound and (bf16) SDPA."""
    from llama_cu_awq_torch.ops.cuda.prefill_attention import (
        prefill_attention)

    pos = torch.tensor([pos_v], dtype=torch.int32, device="cuda")
    horizon = pos_v + T  # keys the block reads
    q = torch.randn(B, T, H, D, device="cuda", generator=g).bfloat16()
    if quant:
        kc, vc = (torch.randint(-127, 128, (B, S, n_kv, D), dtype=torch.int8,
                                device="cuda", generator=g)
                  for _ in range(2))
        ks, vs = (torch.rand(B, S, n_kv, device="cuda", generator=g) * 0.02
                  for _ in range(2))
    else:
        kc, vc = (torch.randn(B, S, n_kv, D, device="cuda",
                              generator=g).bfloat16() for _ in range(2))
        ks = vs = None
    args = (q, kc, vc, pos, ks, vs)
    out, variant = launched_variant(
        lambda: prefill_attention(*args, attn_len=S))
    ref = prefill_attention(*args, attn_len=S, plain=True)
    torch.cuda.synchronize()
    chk = check_close(f"prefill_attention/{tag}", out, ref, **ATTN_TOL)
    kv_bytes = horizon * n_kv * (D * kc.element_size()
                                 + (4 if quant else 0)) * 2
    causal_keys = T * pos_v + T * (T + 1) // 2
    b, src = bound_ms(kv_bytes + nbytes(q, out), 4 * causal_keys * H * D)
    lib = None
    if not quant:
        qh = q.transpose(1, 2).contiguous()
        kh = kc[:, :horizon].transpose(1, 2).contiguous()
        vh = vc[:, :horizon].transpose(1, 2).contiguous()
        s_idx = torch.arange(horizon, device="cuda")
        t_idx = torch.arange(T, device="cuda")
        mask = s_idx[None, :] <= pos_v + t_idx[:, None]
        lib = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, enable_gqa=n_kv != H))
    rows.append(dict(
        name=f"prefill_attention/{tag}", kernel="prefill_attention",
        route="cuda", source="llama_cu_awq_torch/csrc/prefill_attention.cu",
        replaces="llama_cu_awq_tpu/ops/pallas/prefill_attention.py:189",
        variant=variant, path=path, **chk,
        ms=timer(lambda: prefill_attention(*args, attn_len=S)),
        plain_ms=timer(lambda: prefill_attention(*args, attn_len=S,
                                                 plain=True), iters=5),
        bound_ms=b, bound_by=src, library_ms=lib))


def gemm_crossover(torch, timer, g):
    """The GEMV and the GEMM on 7B's qkv shape at m rows, each launched
    directly (these launches are not counted): the data behind
    GEMM_MIN_M."""
    from llama_cu_awq_torch.ops.cuda.int4_matmul import GEMM_MIN_M, _launch
    from llama_cu_awq_torch.quant.qtensor import QTensor

    qt = random_qtensor(torch, QTensor, 4096, 3 * 4096, g)
    sweep = []
    for m in (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 80, 96, 128):
        x = torch.randn(m, 4096, device="cuda", generator=g).bfloat16()
        gemv = _launch(x, qt, out_dtype=torch.float32, kernel="gemv")[0]
        gemm = _launch(x, qt, out_dtype=torch.float32, kernel="gemm")[0]
        torch.cuda.synchronize()
        check_close(f"gemm_crossover/m{m}", gemm, gemv, **INT4_TOL)
        sweep.append({"m": m, "gemv_ms": timer(lambda: _launch(
            x, qt, out_dtype=torch.float32, kernel="gemv")),
            "gemm_ms": timer(lambda: _launch(
                x, qt, out_dtype=torch.float32, kernel="gemm"))})
    print(json.dumps({"gemm_crossover": "int4 qkv 4096x12288",
                      "GEMM_MIN_M": GEMM_MIN_M, "sweep": sweep}), flush=True)


def gemm_split_sweep(torch, timer, g):
    """The GEMM at m=128 on 7B's four projections (x as given, f32 out)
    with 1 to 4 splits of the groups and the rule's count, launched
    directly (not counted), each checked against the rule's output: the
    data behind int4_matmul.gemm_splits."""
    from llama_cu_awq_torch.ops.cuda.int4_matmul import _launch, gemm_splits
    from llama_cu_awq_torch.quant.qtensor import QTensor

    for tag, n_in, n_out in (("qkv", 4096, 3 * 4096), ("o", 4096, 4096),
                             ("gate_up", 4096, 2 * 11008),
                             ("down", 11008, 4096)):
        qt = random_qtensor(torch, QTensor, n_in, n_out, g)
        x = torch.randn(128, n_in, device="cuda", generator=g).bfloat16()
        rule = gemm_splits(n_in, n_out)
        want = _launch(x, qt, out_dtype=torch.float32, kernel="gemm")[0]
        sweep = []
        for sp in sorted({1, 2, 3, 4, rule}):
            got = _launch(x, qt, out_dtype=torch.float32, kernel="gemm",
                          splits=sp)[0]
            torch.cuda.synchronize()
            check_close(f"gemm_splits/{tag}/s{sp}", got, want, **GEMV_TOL)
            sweep.append({"splits": sp, "ms": timer(lambda sp=sp: _launch(
                x, qt, out_dtype=torch.float32, kernel="gemm",
                splits=sp))})
        print(json.dumps({"gemm_splits": f"{tag} {n_in}x{n_out} m128",
                          "rule": rule, "sweep": sweep}), flush=True)


def rows_13b(torch, timer, rows, g):
    """Check-only rows at Llama-2 13B's shapes (dim 5120, hidden 13824,
    40 heads of 128), one synthetic layer: the GEMM on the four
    projections at m=128 and prefill_attention MHA bf16, a 128-token
    block at position 1024 over a 2048-row cache."""
    from llama_cu_awq_torch.ops.cuda.int4_matmul import int4_matmul_fused
    from llama_cu_awq_torch.quant.qtensor import QTensor

    dim, hid, m = 5120, 13824, 128
    for tag, n_in, n_out, kind in (
            ("13b_gemm_qkv_prescale", dim, 3 * dim, "prescale"),
            ("13b_gemm_o_residual_ss", dim, dim, "residual"),
            ("13b_gemm_gate_up_prescale", dim, 2 * hid, "prescale"),
            ("13b_gemm_down_silu_residual_ss", hid, dim, "silu")):
        qt = random_qtensor(torch, QTensor, n_in, n_out, g)
        x = torch.randn(m, n_in, device="cuda", generator=g).bfloat16()
        if kind == "prescale":
            ss = torch.rand(m, 1, device="cuda", generator=g) + 0.5
            nw = torch.rand(n_in, device="cuda", generator=g) + 0.5
            kw = dict(prescale=(ss, nw))
            extra = [ss, nw]
        else:
            res = torch.randn(m, n_out, device="cuda",
                              generator=g).bfloat16()
            kw = dict(residual=res, emit_ss_eps=1e-5)
            extra = [res]
            if kind == "silu":
                kw["silu_u"] = torch.randn(m, n_in, device="cuda",
                                           generator=g).bfloat16()
                extra.append(kw["silu_u"])
        (out, ss_k), variant = launched_variant(
            lambda: int4_matmul_fused(x, qt, **kw))
        ref, ss_p = int4_matmul_fused(x, qt, plain=True, **kw)
        torch.cuda.synchronize()
        chk = check_close(f"int4_matmul_fused/{tag}", out, ref, **INT4_TOL)
        if ss_p is not None:
            check_close(f"int4_matmul_fused/{tag}/ss", ss_k, ss_p,
                        **INT4_TOL)
        b, src = bound_ms(
            nbytes(qt.qw, qt.scales, qt.zeros, x, out, ss_k, *extra),
            2 * m * n_in * n_out)
        rows.append(dict(
            name=f"int4_matmul_fused/{tag}", kernel="int4_matmul_fused",
            route="cuda", source=int4_source(variant),
            replaces="llama_cu_awq_tpu/ops/pallas/int4_matmul.py:543",
            variant=variant, path=None, **chk,
            ms=timer(lambda: int4_matmul_fused(x, qt, **kw)),
            plain_ms=timer(lambda: int4_matmul_fused(x, qt, plain=True,
                                                     **kw)),
            bound_ms=b, bound_by=src,
            library_ms=timer(int4pack_library(torch, qt, x)),
            linear_ms=linear_yardstick(torch, timer, qt, x)))
        del qt
    prefill_attention_row(torch, timer, rows, g, "13b_mha40_40_bf16", None,
                          1, 128, 2048, 128, 40, 40, 1024, False)


def run_path(torch, name, fn, launches):
    """Counters to 0 just before the path, read just after: launches per
    kernel and per kernel/variant."""
    from llama_cu_awq_torch.ops.cuda import (LAUNCHES, VARIANT_LAUNCHES,
                                             reset_launches)

    torch.cuda.synchronize()
    reset_launches()
    result = fn()
    torch.cuda.synchronize()
    launches[name] = dict(kernels=dict(LAUNCHES),
                          variants=dict(VARIANT_LAUNCHES))
    print(json.dumps({"path": name, **launches[name]}), flush=True)
    return result


def profile_run(torch, label, prepare, run, n, per, shares=None):
    """Where the time of run(*prepare()) goes, for n units of `per`
    (tokens, blocks): the host clock without the profiler (median of 3),
    then one run traced with torch.profiler for the device's own time per
    kernel name. Device idle share = 1 - device busy / unprofiled wall;
    the traced run also counts the gaps of more than 0.1 ms between the
    card's operations, where the host held the card back."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def timed(*args):
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall = statistics.median(timed(*prepare()) for _ in range(3))
    args = prepare()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_wall = timed(*args)
    by_name: dict[str, list] = {}
    host: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = by_name.setdefault(e.name, [0, 0.0])
            t[0] += 1
            t[1] += e.time_range.elapsed_us()
        elif e.name.startswith("aten::") or "cuda" in e.name.lower():
            t = host.setdefault(e.name, [0, 0.0])
            t[0] += 1
            t[1] += e.self_cpu_time_total
    busy_ms = sum(v[1] for v in by_name.values()) / 1e3
    # stretches of more than 0.1 ms in which the card ran nothing between
    # two of its operations (the host had not queued the next one yet);
    # shorter gaps are the launch-to-launch bubbles of a full queue
    gaps, end = [], None
    for s, e_ in sorted((e.time_range.start, e.time_range.end)
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA):
        if end is not None and s - end > 100:
            gaps.append(s - end)
        end = e_ if end is None else max(end, e_)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    # busy share of each family of kernels, by the profiler's kernel names
    share = {fam: sum(v[1] for name, v in by_name.items()
                      if any(k in name for k in keys)) / 1e3 / busy_ms
             for fam, keys in (shares or {}).items()} if busy_ms else {}
    top_host = sorted(host.items(), key=lambda kv: -kv[1][1])[:10]
    print(json.dumps({
        "profile": label, per + "s": n,
        f"wall_ms_per_{per}": wall / n * 1e3,
        f"traced_wall_ms_per_{per}": traced_wall / n * 1e3,
        f"device_ops_per_{per}": sum(v[0] for v in by_name.values()) / n,
        f"device_busy_ms_per_{per}": busy_ms / n,
        "device_idle_share": (1 - busy_ms / (wall * 1e3)
                              if busy_ms else None),
        "device_gaps_over_0.1ms": len(gaps),
        "device_gap_ms": sum(gaps) / 1e3,
        "largest_device_gap_ms": max(gaps, default=0.0) / 1e3,
        **({"busy_share": share} if shares else {}),
        "top_device_ops": [{"name": n_[:80], "count": c, "ms": us / 1e3}
                           for n_, (c, us) in top],
        "top_host_ops_self_cpu": [{"name": n_[:60], "count": c,
                                   "ms": us / 1e3}
                                  for n_, (c, us) in top_host]}),
          flush=True)


def profile_decode(torch, eng, prompt, steps=16, label="decode_chunk"):
    """One decode chunk of `steps` tokens after the prompt (through the
    engine's graphs unless it was made with capture=False)."""

    def prepare():
        eng.reset()
        eng._prefill(prompt[:-1])
        eng._tok.fill_(prompt[-1])
        torch.cuda.synchronize()
        return ()

    profile_run(torch, label, prepare, lambda: eng._decode_chunk(steps),
                steps, "token")


def random_cache(torch, cfg, kv_quant, g, kv_bits=8, batch=1, dtype=None):
    """A 2048-row KV cache of random rows (bf16, or dtype; int8 codes and
    scales; or with kv_bits=4 random packed bytes and scales) for `batch`
    slots, as a kernels-against-plain check starts from."""
    from llama_cu_awq_torch.models import init_kv_cache

    cache = init_kv_cache(cfg, batch, 2048, dtype=dtype or torch.bfloat16,
                          quantized=kv_quant, kv_bits=kv_bits)
    lo, smax = (-128, 0.2) if kv_bits == 4 else (-127, 0.02)
    for l in range(cfg.n_layers):
        for buf, sc in ((cache.k[l], cache.k_scale),
                        (cache.v[l], cache.v_scale)):
            if kv_quant:
                buf.copy_(torch.randint(lo, 128, buf.shape,
                                        dtype=torch.int8, device="cuda",
                                        generator=g))
                sc[l].copy_(torch.rand(sc[l].shape, device="cuda",
                                       generator=g) * smax)
            else:
                buf.copy_(torch.randn(buf.shape, device="cuda",
                                      generator=g).to(buf.dtype))
    return cache


def forward_check(torch, params, cfg, label, tok, pos, kv_quant, g,
                  kv_bits=8, **kw):
    """One 7B forward from the same random cache through the kernels and
    through the plain versions: the largest logit difference within 2 %
    of the largest logit, and the same argmax on every row whose plain
    top-2 gap is wider than that."""
    from llama_cu_awq_torch.models import forward, init_kv_cache

    B = tok.shape[0]
    act = kw.get("act_dtype", torch.bfloat16)
    cache = random_cache(torch, cfg, kv_quant, g, kv_bits, batch=B,
                         dtype=act)
    logits = {}
    for plain in (False, True):
        c = init_kv_cache(cfg, B, 2048, dtype=act, quantized=kv_quant,
                          kv_bits=kv_bits)
        for dst, src in zip(c.k + c.v + c.k_scale + c.v_scale,
                            cache.k + cache.v + cache.k_scale
                            + cache.v_scale):
            dst.copy_(src)
        out, _ = forward(params, cfg, tok, pos, c, plain=plain, **kw)
        logits[plain] = out.float().reshape(-1, cfg.vocab_size)
        del c
    k, p = logits[False], logits[True]
    if not bool(k.isfinite().all()):
        raise AssertionError(f"{label}: non-finite logits from the kernels")
    diff = float((k - p).abs().max())
    scale = float(p.abs().max())
    tol = 2e-2 * max(1.0, scale)
    top2 = p.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > tol
    same = k.argmax(-1) == p.argmax(-1)
    print(json.dumps({
        "forward_7b": label, "rows": k.shape[0],
        "max_abs_logit_diff": diff, "max_abs_logit": scale,
        "tolerance": tol, "rows_with_top2_gap_over_tol": int(decided.sum()),
        "argmax_equal_rows": int(same.sum()),
        "argmax_kernel_first": int(k[0].argmax()),
        "argmax_plain_first": int(p[0].argmax()),
        "act_dtype": str(act).replace("torch.", ""),
        "layers": cfg.n_layers,
        "why": "32 layers of bf16 activations: one-ulp roundings in "
               "either path propagate; bound 2% of the largest logit"}),
        flush=True)
    if diff > tol:
        raise AssertionError(f"{label}: kernel and plain logits differ by "
                             f"{diff} > {tol}")
    if not bool(same[decided].all()):
        raise AssertionError(f"{label}: argmax differs on a row whose "
                             f"plain top-2 gap exceeds {tol}")


def e2e_phase(torch, launches):
    from llama_cu_awq_torch.config import LLAMA2_7B
    from llama_cu_awq_torch.engine import InferenceEngine
    from llama_cu_awq_torch.models import quantize_lm_head, synthetic_params

    cfg = LLAMA2_7B
    t0 = time.time()
    params = synthetic_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "synthetic_params", "model": "llama2-7b",
                      "seconds": time.time() - t0}), flush=True)
    prompt = list(range(5, 13))  # bench.py's synthetic prompt ids

    def engine(p=params, **kw):
        return InferenceEngine(p, cfg, None, temperature=0.0, seed=1234,
                               max_seq=kw.pop("max_seq", 512), **kw)

    eng = engine()
    eng.generate_benchmark(prompt, 256)  # warm-up: captures the graphs
    toks, dt, tps = run_path(torch, "main",
                             lambda: eng.generate_benchmark(prompt, 256),
                             launches)
    if len(toks) != 256 - len(prompt) + 1 or not all(
            0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError(f"bad token stream: {len(toks)} tokens")
    print(json.dumps({"e2e": "generate_benchmark", "model": "llama2-7b",
                      "quant": "w4-g128", "batch": 1, "steps": 256,
                      "max_seq": 512, "tok_per_s": tps, "seconds": dt,
                      "first_tokens": toks[:8]}), flush=True)
    for kname in ("int4_matmul_fused", "dense_gemv"):
        if launches["main"]["kernels"][kname] == 0:
            raise AssertionError(f"main path never launched {kname}")
    profile_decode(torch, eng, prompt)

    short = [
        ("fused_step_bf16", engine(attn_impl="fused_step", max_seq=2048),
         "attention_step"),
        ("fused_step_int8kv", engine(attn_impl="fused_step", kv_quant=True,
                                     max_seq=2048), "attention_step"),
        ("lm_head_int8", engine(quantize_lm_head(params, 8)), "dense_gemv"),
        ("lm_head_w4", engine(quantize_lm_head(params, 4)), "int4_matmul"),
    ]
    for name, eng_s, kname in short:
        toks_s, _, tps_s = run_path(
            torch, name, lambda e=eng_s: e.generate_benchmark(prompt, 32),
            launches)
        print(json.dumps({"e2e": name, "steps": 32, "tok_per_s": tps_s,
                          "first_tokens": toks_s[:8]}), flush=True)
        if launches[name]["kernels"][kname] == 0:
            raise AssertionError(f"{name} never launched {kname}")
        del eng_s

    # one full 7B forward step, kernels against plain versions, from the
    # same cache holding 1500 random history rows
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    pos = torch.tensor([1500], dtype=torch.int32, device="cuda")
    tok = torch.tensor([[7]], dtype=torch.int32, device="cuda")
    for kv_quant in (False, True):
        forward_check(torch, params, cfg, "int8_kv" if kv_quant else
                      "bf16_kv", tok, pos, kv_quant, g,
                      attn_impl="fused_step")
    return params


def prefill_phase(torch, params, launches):
    """Block prefill and perplexity at 7B: time to first token and prefill
    tokens/s on a 1920-token prompt, a 256-token prompt with int8 KV, a
    profile of one 128-token block at position 1024, the perplexity of a
    1023-token sequence through the kernels and the plain versions, and a
    7B 128-token block against its plain twin for bf16 and int8 KV."""
    from llama_cu_awq_torch.config import LLAMA2_7B
    from llama_cu_awq_torch.engine import InferenceEngine
    from llama_cu_awq_torch.engine import engine as engine_mod
    from llama_cu_awq_torch.engine.perplexity import token_perplexity
    from llama_cu_awq_torch.models import quantize_lm_head

    cfg = LLAMA2_7B
    prompt = [1] + [3 + (7919 * i) % 31990 for i in range(1919)]

    def engine(**kw):
        return InferenceEngine(params, cfg, None, temperature=0.0,
                               seed=1234, max_seq=2048, **kw)

    eng = engine()
    # warm-up: every block and step graph of the 1920-token prompt is
    # captured before the timed run
    eng.generate_benchmark(prompt, len(prompt))

    def prefill_run():
        # generate_benchmark: 1919 prompt tokens in 15 blocks (the last
        # padded), then the first sampled token: time to first token
        toks, ttft, _ = eng.generate_benchmark(prompt, len(prompt))
        eng.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._prefill(prompt[:-1])
        torch.cuda.synchronize()
        return toks, ttft, time.perf_counter() - t0

    toks, ttft, t_pref = run_path(torch, "prefill", prefill_run, launches)
    if len(toks) != 1 or not 0 <= toks[0] < cfg.vocab_size:
        raise AssertionError(f"bad first token: {toks}")
    print(json.dumps({
        "e2e": "prefill", "model": "llama2-7b", "quant": "w4-g128",
        "prompt_tokens": len(prompt), "blocks": 15, "max_seq": 2048,
        "time_to_first_token_s": ttft, "prefill_s": t_pref,
        "prefill_tok_per_s": (len(prompt) - 1) / t_pref,
        "first_token": toks[0]}), flush=True)
    variants = launches["prefill"]["variants"]
    if launches["prefill"]["kernels"]["prefill_attention"] == 0 or not any(
            k.startswith("int4_matmul_fused/gemm/") for k in variants):
        raise AssertionError("the prefill run never launched "
                             "prefill_attention or the int4 GEMM")
    # the lm_head runs on a prompt's last block only: once for each of the
    # run's two prompts, at 128 rows
    heads = variants.get("dense_gemv/bf16/m128/32000x4096", 0)
    print(json.dumps({"check": "prefill_lm_head_launches", "prompts": 2,
                      "blocks": 30, "m128_head_launches": heads}),
          flush=True)
    if heads != 2:
        raise AssertionError(f"prefill: {heads} lm_head launches at 128 "
                             f"rows for 2 prompts of 15 blocks")

    eng8 = engine(kv_quant=True)
    eng8.generate_benchmark(prompt[:256], 256)  # warm-up: the graphs
    toks8, dt8, _ = run_path(
        torch, "prefill_int8kv",
        lambda: eng8.generate_benchmark(prompt[:256], 256), launches)
    print(json.dumps({"e2e": "prefill_int8kv", "prompt_tokens": 256,
                      "time_to_first_token_s": dt8, "first_token": toks8[0]}),
          flush=True)
    if launches["prefill_int8kv"]["kernels"]["prefill_attention"] == 0:
        raise AssertionError("prefill_int8kv never launched "
                             "prefill_attention")
    del eng8

    # the int8 head over a prompt's last block (the tile kernel at 128
    # rows of int8 codes)
    eng_h8 = InferenceEngine(quantize_lm_head(params, 8), cfg, None,
                             temperature=0.0, seed=1234, max_seq=2048)
    eng_h8.generate_benchmark(prompt[:256], 256)  # warm-up: the graphs
    toks_h8, dt_h8, _ = run_path(
        torch, "prefill_lm_head_int8",
        lambda: eng_h8.generate_benchmark(prompt[:256], 256), launches)
    print(json.dumps({"e2e": "prefill_lm_head_int8", "prompt_tokens": 256,
                      "time_to_first_token_s": dt_h8,
                      "first_token": toks_h8[0]}), flush=True)
    if launches["prefill_lm_head_int8"]["variants"].get(
            "dense_gemv/int8/m128/32000x4096", 0) != 1:
        raise AssertionError("prefill_lm_head_int8: the int8 head did not "
                             "run once at 128 rows")
    del eng_h8

    def prepare_block():
        eng.reset()
        eng._prefill(prompt[:1024])
        torch.cuda.synchronize()
        return (prompt[1024:1152],)

    profile_run(torch, "prefill_block_pos1024", prepare_block, eng._prefill,
                1, "block", shares={
                    "int4_gemm": ["int4_gemm_kernel", "stage_x_kernel",
                                  "split_sum_kernel"],
                    "prefill_attention": ["prefill_split_kernel",
                                          "prefill_merge_kernel"],
                    "rms_scale": ["rms_scale_kernel"],
                    "lm_head": ["dense_gemm"]})

    # perplexity of a 1023-token sequence: 8 blocks with every row's
    # logits, through the kernels, then with the engine's forward bound
    # to the plain versions on the card
    seq = [3 + (104729 * i) % 31990 for i in range(1023)]
    t0 = time.perf_counter()
    ppl_k = run_path(torch, "perplexity",
                     lambda: token_perplexity(eng, seq), launches)
    dt_k = time.perf_counter() - t0
    # the plain versions run eagerly: a graph replays what it captured
    eng_plain = engine(capture=False)
    kernel_forward = engine_mod.forward
    engine_mod.forward = functools.partial(kernel_forward, plain=True)
    try:
        ppl_p = token_perplexity(eng_plain, seq)
    finally:
        engine_mod.forward = kernel_forward
    del eng_plain
    d = abs(math.log(ppl_k) - math.log(ppl_p))
    print(json.dumps({"e2e": "perplexity", "tokens": len(seq),
                      "ppl_kernel": ppl_k, "ppl_plain": ppl_p,
                      "abs_delta_ln_ppl": d, "tolerance": 0.01,
                      "seconds_kernel": dt_k}), flush=True)
    if not (math.isfinite(ppl_k) and d <= 0.01):
        raise AssertionError(f"perplexity: kernels {ppl_k}, plain {ppl_p}")
    if launches["perplexity"]["kernels"]["prefill_attention"] == 0:
        raise AssertionError("perplexity never launched prefill_attention")
    # perplexity needs every row's logits: the head on each of 8 blocks
    heads = launches["perplexity"]["variants"].get(
        "dense_gemv/bf16/m128/32000x4096", 0)
    print(json.dumps({"check": "perplexity_lm_head_launches", "blocks": 8,
                      "m128_head_launches": heads}), flush=True)
    if heads != 8:
        raise AssertionError(f"perplexity: {heads} lm_head launches at 128 "
                             f"rows for 8 blocks")
    del eng

    # one full 7B block of 128 tokens at position 1024, every row's logits
    g = torch.Generator(device="cuda")
    g.manual_seed(2)
    tok = torch.randint(3, cfg.vocab_size, (1, 128), dtype=torch.int32,
                        device="cuda", generator=g)
    pos = torch.tensor([1024], dtype=torch.int32, device="cuda")
    for kv_quant in (False, True):
        forward_check(torch, params, cfg, "block128_" + (
            "int8_kv" if kv_quant else "bf16_kv"), tok, pos, kv_quant, g,
            attn_len=2048, logits_all=True)


# the largest logit gap to the replayed argmax a speculative token may
# have: tests/test_spec_decode.py:44-63's tol
SPEC_GAP = 0.1


def decode_run(torch, eng, prompt, steps):
    """prompt[:-1] through _prefill, then `steps` plain decode chunks from
    prompt[-1] (a host sync a chunk), the decode timed alone on the host
    clock. Returns (tokens, decode tokens/s)."""
    eng.reset()
    eng._prefill(prompt[:-1])
    token = torch.tensor([prompt[-1]], dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _ = eng._decode_tokens(token, steps, stop_at_eos=False)
    torch.cuda.synchronize()
    return toks, steps / (time.perf_counter() - t0)


def position(torch, eng):
    """The engine's next position as a (1,) int32 tensor on the card."""
    return torch.tensor([eng.pos], dtype=torch.int32, device="cuda")


def replay_check(torch, params, cfg, prompt, stream, base, max_seq):
    """tests/test_spec_decode.py's replay_consistent on the card: plain
    T=1 decode is fed the speculative stream token by token, and every
    token of it must be within SPEC_GAP of that step's argmax. Where the
    stream parts from the plain stream `base`, the replayed top-2 margin
    must be below SPEC_GAP (a near tie, not a fault)."""
    from llama_cu_awq_torch.engine import InferenceEngine
    from llama_cu_awq_torch.models import forward

    eng = InferenceEngine(params, cfg, None, temperature=0.0,
                          max_seq=max_seq)
    eng._prefill(prompt[:-1])
    feed = [prompt[-1]] + stream[:-1]
    gaps, margins = [], []
    for t_in, t_out in zip(feed, stream):
        logits, _ = forward(
            params, cfg, torch.tensor([[t_in]], dtype=torch.int32,
                                      device="cuda"), position(torch, eng),
            eng.cache, attn_len=eng._bucket_for(eng.pos + 1),
            attn_impl=eng.attn_impl)
        top2 = logits[0].topk(2).values
        gaps.append(top2[0] - logits[0, t_out])
        margins.append(top2[0] - top2[1])
        eng.pos += 1
    gaps = torch.stack(gaps).tolist()
    margins = torch.stack(margins).tolist()
    split = next((i for i, (a, b) in enumerate(zip(stream, base)) if a != b),
                 None)
    print(json.dumps({
        "spec_replay": len(stream), "max_gap": max(gaps),
        "tolerance": SPEC_GAP, "first_divergence_from_plain": split,
        "margin_there": None if split is None else margins[split],
        "why": "tests/test_spec_decode.py:44-63: near-tie flips between the "
               "T=8 verify and T=1 decode are allowed, faults give large "
               "gaps"}), flush=True)
    if max(gaps) >= SPEC_GAP:
        raise AssertionError(f"spec token {gaps.index(max(gaps))} is "
                             f"{max(gaps)} below the replayed argmax")
    if split is not None and margins[split] >= SPEC_GAP:
        raise AssertionError(f"spec stream parts from plain at {split} "
                             f"where the top-2 margin is {margins[split]}")


def spec_runs(torch, params, cfg, launches):
    """InferenceEngine with spec="ngram" at 7B, graphs against
    capture=False (see the module docstring, phase 6)."""
    from llama_cu_awq_torch.engine import InferenceEngine

    def engine(**kw):
        return InferenceEngine(params, cfg, None, temperature=0.0,
                               seed=1234, **kw)

    def valid(toks):
        return toks and all(0 <= t < cfg.vocab_size for t in toks)

    # --- speculative decoding: 256 greedy steps on a repetitive prompt,
    # beside the plain stream, then replayed through plain decode; the
    # verifies replay graphs, against an engine made with capture=False,
    # in turns ---
    rep_prompt = [1] + [5 + i % 11 for i in range(32)]
    plain_eng = engine(max_seq=512)
    base, _, tps_plain = plain_eng.generate_benchmark(rep_prompt, 256)
    engs = {way: engine(max_seq=512, spec="ngram", capture=way == "graph")
            for way in ("graph", "eager")}

    def spec_run(e):
        e.spec_stats = {k: 0 for k in e.spec_stats}
        toks, dt, tps = e.generate_benchmark(rep_prompt, 256)
        return toks, tps, dict(e.spec_stats), dt

    res = graph_turns(torch, "spec", engs, spec_run, launches,
                      warm=("graph",))
    got, _, st, dt = res["graph"][0]
    equal = all(r[0] == got and r[2] == st
                for r in res["graph"] + res["eager"])
    same_cache = caches_equal(torch, engs["graph"], engs["eager"])
    print(json.dumps({
        "e2e": "spec_ngram", "model": "llama2-7b", "steps": 256,
        "spec_k": engs["graph"].spec_k, "max_seq": 512,
        "tok_per_s_graph": [r[1] for r in res["graph"]],
        "tok_per_s_eager": [r[1] for r in res["eager"]],
        "plain_tok_per_s_same_prompt": tps_plain, "seconds": dt,
        "spec_stats": st, "acceptance_rate": (
            st["accepted"] / st["proposed"] if st["proposed"] else 0.0),
        "tokens_equal_to_plain": got == base,
        "tokens_and_stats_equal_graph_eager": equal,
        "caches_bit_equal": same_cache, "first_tokens": got[:8],
        "graphs": graph_table(engs["graph"])}), flush=True)
    if len(got) != 256 - len(rep_prompt) + 1 or not valid(got):
        raise AssertionError(f"spec: bad stream of {len(got)} tokens")
    if st["verifies"] == 0:
        raise AssertionError("spec: no proposal was verified")
    if not (equal and same_cache):
        raise AssertionError("spec: the graphs and eager launches differ")
    replay_check(torch, params, cfg, rep_prompt, got, base, 512)
    del plain_eng, engs


def slice3_phase(torch, params, launches):
    """The int4 KV cache, batched attention and speculative decoding at 7B
    (see the module docstring, phase 6)."""
    from llama_cu_awq_torch.config import LLAMA2_7B
    from llama_cu_awq_torch.engine import InferenceEngine

    cfg = LLAMA2_7B
    prompt = [1] + [3 + (7919 * i) % 31990 for i in range(1919)]

    def engine(**kw):
        return InferenceEngine(params, cfg, None, temperature=0.0,
                               seed=1234, **kw)

    def valid(toks):
        return toks and all(0 <= t < cfg.vocab_size for t in toks)

    # --- int4 KV: 15 prefill blocks through plain split-plane attention,
    # then decode at the 2048 bucket through attention_step_kv4 ---
    eng4 = engine(kv_quant=4, max_seq=2048)
    eng4.generate_benchmark(prompt, len(prompt))  # warm-up: the graphs

    def kv4_run():
        toks, ttft, _ = eng4.generate_benchmark(prompt, len(prompt))
        return toks, ttft, *decode_run(torch, eng4, prompt, 32)

    toks, ttft, dtoks, tps = run_path(torch, "kv4", kv4_run, launches)
    kv_bytes = nbytes(*eng4.cache.k, *eng4.cache.v, *eng4.cache.k_scale,
                      *eng4.cache.v_scale)
    bf16_bytes = 2 * cfg.n_layers * 2048 * cfg.n_kv_heads * cfg.head_dim * 2
    print(json.dumps({
        "e2e": "kv4", "model": "llama2-7b", "prompt_tokens": len(prompt),
        "max_seq": 2048, "time_to_first_token_s": ttft,
        "decode_steps": 32, "decode_tok_per_s": tps,
        "kv_cache_bytes": kv_bytes, "bf16_kv_cache_bytes": bf16_bytes,
        "first_tokens": dtoks[:8]}), flush=True)
    if not (valid(toks) and valid(dtoks)):
        raise AssertionError(f"kv4: bad tokens {toks} {dtoks[:8]}")
    if launches["kv4"]["kernels"]["attention_step_kv4"] == 0:
        raise AssertionError("kv4 never launched attention_step_kv4")
    del eng4

    # --- batched attention after a 1024-token prompt ---
    for name, impl, kv_quant, steps in (
            ("batched_bf16", "batched", False, 32),
            ("batched_int8kv", "batched", True, 32),
            ("batched_static", "batched_static", False, 16)):
        eng_b = engine(attn_impl=impl, kv_quant=kv_quant, max_seq=2048)
        dtoks, tps = run_path(
            torch, name, lambda e=eng_b, n=steps: decode_run(
                torch, e, prompt[:1024], n), launches)
        print(json.dumps({"e2e": name, "prompt_tokens": 1024,
                          "max_seq": 2048, "decode_steps": steps,
                          "decode_tok_per_s": tps,
                          "first_tokens": dtoks[:8]}), flush=True)
        if not valid(dtoks):
            raise AssertionError(f"{name}: bad tokens {dtoks[:8]}")
        if launches[name]["kernels"]["batched_decode_attention"] == 0:
            raise AssertionError(f"{name} never launched "
                                 f"batched_decode_attention")
        del eng_b

    spec_runs(torch, params, cfg, launches)

    # one 7B step at position 1500, kernels against plain versions
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    pos = torch.tensor([1500], dtype=torch.int32, device="cuda")
    tok = torch.tensor([[7]], dtype=torch.int32, device="cuda")
    forward_check(torch, params, cfg, "kv4_fused_step", tok, pos, True, g,
                  kv_bits=4, attn_impl="fused_step")
    for kv_quant in (False, True):
        forward_check(torch, params, cfg, "batched_" + (
            "int8_kv" if kv_quant else "bf16_kv"), tok, pos, kv_quant, g,
            attn_impl="batched")


@contextlib.contextmanager
def down_qkv_switch(on: bool):
    """LLAMA_TPU_DOWN_QKV set to 1 or 0 for the block (forward reads it on
    every call), then restored."""
    old = os.environ.get("LLAMA_TPU_DOWN_QKV")
    os.environ["LLAMA_TPU_DOWN_QKV"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["LLAMA_TPU_DOWN_QKV"]
        else:
            os.environ["LLAMA_TPU_DOWN_QKV"] = old


def gemv_pair(torch, g, u, res, wd, wq, nw, out_dtype):
    """The standalone launches the chain replaces, forced onto the GEMV:
    the down GEMV with the SwiGLU prologue and residual, rms_scale, then
    the qkv GEMV with the rmsnorm prologue (not counted)."""
    from llama_cu_awq_torch.ops.cuda.int4_matmul import _launch

    m = g.shape[0]
    x2, ss2 = _launch(g, wd, u2=u, res=res, out_dtype=torch.bfloat16,
                      eps=1e-5, kernel="gemv")
    qkv, _ = _launch(x2, wq, ss=ss2.reshape(m), nw=nw, out_dtype=out_dtype,
                     kernel="gemv")
    return x2, ss2, qkv


def down_qkv_rows(torch, timer, rows, g):
    """down_qkv at 7B shapes (down 11008x4096, then qkv 4096x12288) at m=1
    (batch-1 decode) and m=8 (8 serving slots): against its plain version
    (INT4_TOL) and against the standalone GEMV pair, which it must equal
    bit for bit (each column sums in the GEMV's order; int4_gemv.cuh). The
    pair's time stands beside the kernel's; the library time is two
    torch._weight_int4pack_mm calls, down then qkv, without the SwiGLU,
    residual, rms-scale and rmsnorm glue."""
    from llama_cu_awq_torch.ops.cuda.down_qkv import down_qkv_fused
    from llama_cu_awq_torch.quant.qtensor import QTensor

    dim, hid, n_q = 4096, 11008, 3 * 4096
    wd = random_qtensor(torch, QTensor, hid, dim, g)
    wq = random_qtensor(torch, QTensor, dim, n_q, g)
    for m, path in ((1, "down_qkv_b1"), (8, "batch_engine_dq")):
        gu = torch.randn(m, 2 * hid, device="cuda", generator=g).bfloat16()
        gate, up = gu.chunk(2, dim=-1)  # the gate_up halves, as forward
        res = torch.randn(m, dim, device="cuda", generator=g).bfloat16()
        nw = torch.rand(dim, device="cuda", generator=g) + 0.5
        args = (gate, up, res, wd, wq, nw)
        kw = dict(eps=1e-5, out_dtype=torch.bfloat16)
        (x2, ss2, qkv), variant = launched_variant(
            lambda: down_qkv_fused(*args, **kw))
        rx2, rss2, rqkv = down_qkv_fused(*args, plain=True, **kw)
        px2, pss2, pqkv = gemv_pair(torch, *args, torch.bfloat16)
        torch.cuda.synchronize()
        chk = check_close(f"down_qkv/m{m}", qkv, rqkv, **INT4_TOL)
        check_close(f"down_qkv/m{m}/x2", x2, rx2, **INT4_TOL)
        check_close(f"down_qkv/m{m}/ss2", ss2, rss2, **INT4_TOL)
        diffs = [float((a.float() - b.float().reshape(a.shape)).abs().max())
                 for a, b in ((x2, px2), (ss2, pss2), (qkv, pqkv))]
        equal = (torch.equal(x2, px2) and torch.equal(qkv, pqkv)
                 and torch.equal(ss2.reshape(-1), pss2.reshape(-1)))
        print(json.dumps({
            "check": f"down_qkv/m{m}/vs_gemv_pair", "max_abs_err": max(diffs),
            "x2_ss2_qkv_max_abs_err": diffs, "bit_equal": equal,
            "why": "each column sums in the standalone GEMV's order and each "
                   "row's rms scale in rms_scale's (int4_gemv.cuh)"}),
            flush=True)
        if not equal:
            raise AssertionError(f"down_qkv/m{m}: differs from the GEMV pair "
                                 f"(max abs err {diffs})")
        b, src = bound_ms(
            nbytes(wd.qw, wd.scales, wd.zeros, wq.qw, wq.scales, wq.zeros,
                   gate, up, res, nw, x2, ss2, qkv),
            2 * m * (hid * dim + dim * n_q))
        h = (torch.nn.functional.silu(gate.float()) * up.float()).bfloat16()
        lib_down = int4pack_library(torch, wd, h)
        lib_qkv = int4pack_library(torch, wq, x2)
        rows.append(dict(
            name=f"down_qkv/m{m}", kernel="down_qkv", route="cuda",
            source="llama_cu_awq_torch/csrc/down_qkv.cu",
            replaces="llama_cu_awq_tpu/ops/pallas/down_qkv.py:147",
            variant=variant, path=path, **chk,
            ms=timer(lambda: down_qkv_fused(*args, **kw)),
            plain_ms=timer(lambda: down_qkv_fused(*args, plain=True, **kw),
                           iters=5),
            pair_ms=timer(lambda: gemv_pair(torch, *args, torch.bfloat16)),
            bound_ms=b, bound_by=src,
            library_ms=timer(lambda: (lib_down(), lib_qkv())),
            library_call="torch._weight_int4pack_mm, down then qkv"))
        r = rows[-1]
        print(json.dumps({"kernel_check": r["name"], "kernel_ms": r["ms"],
                          **{k: r[k] for k in (
                              "max_abs_err", "rtol", "atol", "plain_ms",
                              "pair_ms", "library_ms", "bound_ms",
                              "bound_by")}}), flush=True)


TOY_WORDS = [b" the", b" cat", b" sat", b" on", b" mat", b"s", b" a",
             b"the", b"cat", b" "]


def write_toy_tokenizer(path, vocab_size):
    """A tokenizer.bin in the reference's format (max piece length, then
    score, length and bytes of each piece): the special pieces, the 256
    single bytes, a few words, padded to vocab_size. The checkout holds no
    real vocabulary; the weights are random anyway."""
    vocab = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    vocab += [(bytes([b]), -1000.0) for b in range(256)]
    vocab += [(w, -float(i)) for i, w in enumerate(TOY_WORDS)]
    vocab += [(b"<pad%d>" % i, -2000.0)
              for i in range(vocab_size - len(vocab))]
    with open(path, "wb") as f:
        f.write(struct.pack("<i", max(len(p) for p, _ in vocab)))
        for piece, score in vocab:
            f.write(struct.pack("<fi", score, len(piece)))
            f.write(piece)
    return path


def http_json(url, body=None, stream=False):
    """GET (body None) or POST a JSON body; returns (status, JSON), or
    for stream=True (status, concatenated SSE text, last finish_reason)."""
    data = None if body is None else json.dumps(
        {**body, "stream": stream}).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        if not stream:
            return r.status, json.loads(r.read())
        text, reason = [], None
        for line in r:
            line = line.decode().strip()
            if line.startswith("data: ") and line != "data: [DONE]":
                choice = json.loads(line[6:])["choices"][0]
                text.append(choice["text"])
                reason = choice["finish_reason"]
        return r.status, "".join(text), reason


def serve_http_run(torch, params, cfg, launches):
    """make_server on 127.0.0.1 over a BatchEngine with spec="ngram" (the
    server's default): 8 concurrent greedy completions, 4 of them
    streamed, then /health and /stats; first on an engine that replays
    graphs (once untimed, where it captures, then timed), then on one
    made with capture=False. The engine thread starts once all 8
    requests are queued, one after the other, so both runs take the same
    slots and rounds: equal streams, caches and launch counts. Two blocking requests' token_ids are
    replayed step by step through the single-sequence engine."""
    from llama_cu_awq_torch.engine import BatchEngine, InferenceEngine
    from llama_cu_awq_torch.serve import make_server
    from llama_cu_awq_torch.tokenizer import Tokenizer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    tok = Tokenizer(write_toy_tokenizer(os.path.join(tmp, "tok.bin"),
                                        cfg.vocab_size), cfg.vocab_size)
    prompts = [("the cat sat on the mat" * (1 + i % 3)) + " a" * i
               for i in range(8)]

    def serve(be, name):
        be.reset()
        httpd, seng = make_server(be, tok, host="127.0.0.1", port=0)
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        results = {}

        def client(i):
            body = {"prompt": prompts[i], "max_tokens": 32,
                    "temperature": 0.0}
            results[i] = http_json(base + "/v1/completions", body,
                                   stream=i % 2 == 1)

        def run():
            # one request queued at a time, so request i takes slot i in
            # every run
            threads = []
            deadline = time.perf_counter() + 60
            for i in range(8):
                threads.append(threading.Thread(target=client, args=(i,)))
                threads[-1].start()
                while True:
                    with seng.replicas[0].lock:
                        if be.scheduler.num_queued == i + 1:
                            break
                    if time.perf_counter() > deadline:
                        raise AssertionError("serve_http: requests not "
                                             "queued")
                    time.sleep(0.002)
            t0 = time.perf_counter()
            seng.start()
            for t in threads:
                t.join(timeout=600)
            return time.perf_counter() - t0

        try:
            wall = (run_path(torch, name, run, launches) if name
                    else run())
            health = http_json(base + "/health")
            stats = http_json(base + "/stats")[1]
        finally:
            httpd.shutdown()
            seng.stop()
            httpd.server_close()
            server.join(timeout=30)
        done = [i for i, r in results.items() if r[0] == 200 and (
            r[2] == "stop" if i % 2 else
            r[1]["choices"][0]["finish_reason"] == "stop")]
        if sorted(done) != list(range(8)) or \
                health != (200, {"status": "ok"}):
            raise AssertionError(f"serve_http: finished {done}, "
                                 f"health {health}")
        if stats["requests"] != 8 or stats["active_slots"] != 0:
            raise AssertionError(f"serve_http: stats {stats}")
        streams = [r[1]["choices"][0]["token_ids"] if i % 2 == 0 else r[1]
                   for i, r in sorted(results.items())]
        return wall, streams, stats, dict(be.spec_stats)

    engs = {way: BatchEngine(params, cfg, tok, n_slots=8, max_seq=512,
                             chunk_size=8, spec="ngram",
                             capture=way == "graph")
            for way in ("graph", "eager")}
    serve(engs["graph"], None)  # the captures
    res = {way: serve(engs[way], name) for way, name in (
        ("graph", "serve_http"), ("eager", "serve_http_eager"))}
    g, e = res["graph"], res["eager"]
    equal = g[1] == e[1] and g[3] == e[3]
    same_cache = caches_equal(torch, *engs.values())
    same_launches = launches["serve_http"] == launches["serve_http_eager"]
    print(json.dumps({
        "e2e": "serve_http", "model": "llama2-7b", "slots": 8,
        "max_seq": 512, "spec": "ngram", "requests": 8, "streamed": 4,
        "finished": 8, "wall_s_graph": g[0], "wall_s_eager": e[0],
        "blocking_tokens": sum(len(t) for t in g[1][::2]),
        "streams_equal": equal,
        "caches_bit_equal": same_cache,
        "launches_equal": same_launches, "server_stats": g[2],
        "spec_stats": g[3], "scheduler": type(
            engs["graph"].scheduler).__name__,
        **graph_summary(engs["graph"])}), flush=True)
    if not (equal and same_cache and same_launches):
        raise AssertionError("serve_http: the graphs and eager launches "
                             "differ")
    del engs
    for i in (0, 2):
        ids = tok.encode(prompts[i], bos=True, eos=False)
        stream = g[1][i]
        if not stream:
            raise AssertionError(f"serve_http: request {i} got no tokens")
        plain = InferenceEngine(params, cfg, None, temperature=0.0,
                                max_seq=512)
        base_stream = plain.generate_benchmark(
            ids, len(ids) + len(stream) - 1)[0]
        del plain
        replay_check(torch, params, cfg, ids, stream, base_stream, 512)


def profile_batch_chunk(torch, engs):
    """Where the time of one serving chunk goes: 8 slots decoding at
    positions around 1000 (the 1024 bucket: fused_step attention), one
    chunk of chunk_size steps at B=8, launched eagerly (capture=False)
    and replayed from the graphs, without and with the chain."""
    deep = [[1] + [3 + (7919 * (i + 977 * j)) % 31990 for i in range(999)]
            for j in range(8)]
    for on, way in ((False, "eager"), (False, "graph"), (True, "eager"),
                    (True, "graph")):
        be = engs[way]

        def prepare():
            be.reset()
            for p in deep:
                be.submit(p, max_new=64)
            be.step()  # admission, the prompts' block prefill, a chunk
            torch.cuda.synchronize()
            return ()

        label = "batch_chunk_b8_pos1000" + ("_chain" if on else "") + (
            "_graph" if way == "graph" else "")
        with down_qkv_switch(on):
            profile_run(torch, label, prepare, be.step, be.chunk_size,
                        "step")


class TimedScheduler:
    """A scheduler whose every call (and property read) is timed on the
    host clock: how much of a chunk's host time the slot scheduler
    takes."""

    def __init__(self, inner):
        self._inner = inner
        self.seconds = 0.0
        self.calls = 0

    def __getattr__(self, name):
        t0 = time.perf_counter()
        attr = getattr(self._inner, name)  # a property computes here
        self.seconds += time.perf_counter() - t0
        if not callable(attr):
            self.calls += 1
            return attr

        def timed(*args):
            t1 = time.perf_counter()
            try:
                return attr(*args)
            finally:
                self.seconds += time.perf_counter() - t1
                self.calls += 1
        return timed


def profile_batch_run(torch, engs):
    """BatchEngine.run()'s lookahead on 8 slots near position 1000, after
    their prompts' block prefill and a first chunk: 4 chunks of 8 steps
    each (run() also queues a fifth, which it discards). First the check
    that a dispatch queues its chunk without waiting for the chunk in
    flight, on graphs already captured (a capture synchronizes): under
    sync debug mode "error" a stream or device synchronization raises.
    Then run() profiled eagerly and from graphs, and from graphs a loop
    of synchronous steps over the same work; then run() from graphs
    split into the host's time in dispatch, in fetching and routing
    tokens, and in the slot scheduler's calls, once with the native
    scheduler and once with the Python one: a fetch that waits about
    nothing means the host, not the card, bounds the loop."""
    from llama_cu_awq_torch.engine.scheduler import make_scheduler

    deep = [[1] + [3 + (7919 * (i + 977 * j)) % 31990 for i in range(999)]
            for j in range(8)]
    n_steps = 4 * engs["graph"].chunk_size

    def preparer(be, native=None):
        """reset, then (native True or False) a TimedScheduler over the
        native or the Python scheduler, the prompts and a first step."""
        def prepare():
            be.reset()
            if native is not None:
                be.scheduler = TimedScheduler(make_scheduler(
                    be.n_slots, be.max_seq, prefer_native=native))
            for p in deep:
                be.submit(p, max_new=40)
            be.step()
            torch.cuda.synchronize()
            if native is not None:
                be.scheduler.seconds, be.scheduler.calls = 0.0, 0
            return ()
        return prepare

    def steps(be):
        def run():
            while be.pending:
                be.step()
        return run

    be = engs["graph"]
    preparer(be)()
    first = be._dispatch_chunk()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = be._dispatch_chunk()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    be._process_chunk(first)
    be._process_chunk(second)
    print(json.dumps({"check": "batch_dispatch_queues_without_sync",
                      "graphs": True, "ok": True}), flush=True)
    for label, way, fn in (
            ("batch_run_b8_pos1000", "eager", "run"),
            ("batch_run_b8_pos1000_graph", "graph", "run"),
            ("batch_steps_b8_pos1000_graph", "graph", "steps")):
        be = engs[way]
        profile_run(torch, label, preparer(be), be.run if fn == "run"
                    else steps(be), n_steps, "step")

    be = engs["graph"]
    for native in (True, False):
        preparer(be, native)()
        sched = be.scheduler
        spent = {"_dispatch_chunk": 0.0, "_process_chunk": 0.0}
        n_chunks = [0]

        def timed(name):
            fn = getattr(be, name)

            def wrapped(*args):
                t0 = time.perf_counter()
                try:
                    return fn(*args)
                finally:
                    spent[name] += time.perf_counter() - t0
                    n_chunks[0] += name == "_process_chunk"
            return wrapped

        for name in spent:  # instance attributes shadow the methods
            setattr(be, name, timed(name))
        try:
            t0 = time.perf_counter()
            be.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for name in spent:
                delattr(be, name)
        print(json.dumps({
            "host_split": "batch_run_b8_pos1000_graph",
            "scheduler": type(sched._inner).__name__, "steps": n_steps,
            "chunks": n_chunks[0],
            "wall_ms_per_step": wall / n_steps * 1e3,
            "dispatch_ms_per_step": spent["_dispatch_chunk"] / n_steps * 1e3,
            "fetch_and_route_ms_per_step":
                spent["_process_chunk"] / n_steps * 1e3,
            "scheduler_ms_per_chunk": sched.seconds / n_chunks[0] * 1e3,
            "scheduler_calls_per_chunk": sched.calls / n_chunks[0]}),
            flush=True)


# tokens a request of batch_engine_runs (64 before the depth cuts that
# keep the script in its time limit)
BATCH_MAX_NEW = 32


def batch_engine_runs(torch, params, cfg, launches, chain_variant):
    """BatchEngine at 7B, graphs against capture=False (see the module
    docstring, phase 7): 16 greedy requests, then the profiles."""
    from llama_cu_awq_torch.engine import BatchEngine

    # --- BatchEngine: 16 greedy requests over 8 slots, prompts of 20 to
    # 1000 tokens (forced stream and interleaved block prefill), windows
    # into the 1024 and 2048 buckets, where fused_step and the chain apply;
    # an engine that replays graphs against one made with capture=False,
    # in turns after the graph engine's untimed run (its captures)
    lengths = [20, 36, 48] + [60 + (1000 - 60) * i // 12 for i in range(13)]
    prompts = [[1] + [3 + (104729 * (i + 131 * j)) % 31990
                      for i in range(n - 1)]
               for j, n in enumerate(lengths)]
    engs = {way: BatchEngine(params, cfg, None, n_slots=8, max_seq=2048,
                             chunk_size=8, spec=None,
                             capture=way == "graph")
            for way in ("graph", "eager")}

    def serve_all(be):
        be.reset()
        rids = [be.submit(p, max_new=BATCH_MAX_NEW) for p in prompts]
        out = be.run()
        return [out[r] for r in rids], be.stats()

    outs = {}
    for on, name, turns in (
            (False, "batch_engine", ("eager", "graph", "graph", "eager")),
            (True, "batch_engine_dq", ("eager", "graph"))):
        with down_qkv_switch(on):
            res = graph_turns(torch, name, engs, serve_all, launches,
                              warm=("graph",), turns=turns)
        first = res["eager"][0][0]
        equal = all(r[0] == first for r in res["graph"] + res["eager"])
        same_cache = caches_equal(torch, engs["graph"], engs["eager"])
        st = res["graph"][0][1]
        print(json.dumps({
            "e2e": name, "model": "llama2-7b", "slots": 8, "max_seq": 2048,
            "chunk_size": 8, "requests": len(prompts),
            "prompt_tokens": sum(lengths), "max_new": BATCH_MAX_NEW,
            "down_qkv_switch": on,
            **{f"{k}_{way}": [r[1][k] for r in res[way]]
               for way in ("graph", "eager")
               for k in ("tok_per_s", "mean_latency_s", "max_latency_s")},
            "finished": st["finished"], "total_tokens": st["total_tokens"],
            "tokens_equal": equal, "caches_bit_equal": same_cache,
            "launches_equal": launches[name] == launches[name + "_eager"],
            "scheduler": type(engs["graph"].scheduler).__name__,
            "chain_m8_launches": launches[name]["variants"].get(
                chain_variant, 0), **graph_summary(engs["graph"])}),
            flush=True)
        if st["finished"] != len(prompts) or not all(first):
            raise AssertionError(f"{name}: {st}")
        if not (equal and same_cache):
            raise AssertionError(f"{name}: the graphs and eager launches "
                                 f"differ")
        outs[on] = first
    profile_batch_chunk(torch, engs)
    profile_batch_run(torch, engs)
    del engs
    print(json.dumps({"e2e": "batch_engine_streams",
                      "equal_with_and_without_chain":
                          outs[True] == outs[False]}), flush=True)
    if outs[True] != outs[False]:
        raise AssertionError("batch_engine: the chain changed a stream")
    if not launches["batch_engine_dq"]["variants"].get(chain_variant) or \
            launches["batch_engine"]["kernels"]["down_qkv"]:
        raise AssertionError("batch_engine: the m=8 chain never launched "
                             "with the switch, or launched without it")


def slice4_phase(torch, timer, rows, params, launches):
    """Continuous batching, serving and the down_qkv chain at 7B (see the
    module docstring, phase 7)."""
    from llama_cu_awq_torch.config import LLAMA2_7B
    from llama_cu_awq_torch.engine import InferenceEngine

    cfg = LLAMA2_7B
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    down_qkv_rows(torch, timer, rows, g)
    chain_variant = "down_qkv/m8/11008x4096+4096x12288"

    # --- batch-1 decode at the 2048 bucket, without and with the chain ---
    prompt = [1] + [3 + (7919 * i) % 31990 for i in range(1919)]
    # in turns (standalone, chain, chain, standalone): the host clock
    # moves between runs
    eng = InferenceEngine(params, cfg, None, temperature=0.0, seed=1234,
                          attn_impl="fused_step", max_seq=2048)
    b1 = []
    for on, name in ((False, "down_qkv_b1_off"), (True, "down_qkv_b1"),
                     (True, "down_qkv_b1_again"),
                     (False, "down_qkv_b1_off_again")):
        with down_qkv_switch(on):
            b1.append(run_path(torch, name, lambda: decode_run(
                torch, eng, prompt[:1024], 32), launches))
    n_chain = launches["down_qkv_b1"]["kernels"]["down_qkv"]
    print(json.dumps({
        "e2e": "down_qkv_b1", "model": "llama2-7b", "prompt_tokens": 1024,
        "max_seq": 2048, "attn_impl": "fused_step", "decode_steps": 32,
        "decode_tok_per_s_chain": [b1[1][1], b1[2][1]],
        "decode_tok_per_s_standalone": [b1[0][1], b1[3][1]],
        "down_qkv_launches": n_chain,
        "down_qkv_launches_per_step": n_chain / 32,
        "streams_equal": all(r[0] == b1[0][0] for r in b1),
        "first_tokens": b1[1][0][:8]}), flush=True)
    if any(r[0] != b1[0][0] for r in b1):
        raise AssertionError("down_qkv_b1: the chain changed the stream")
    if n_chain != (cfg.n_layers - 1) * 32 or \
            launches["down_qkv_b1_off"]["kernels"]["down_qkv"]:
        raise AssertionError(f"down_qkv_b1: {n_chain} chain launches")
    del eng

    batch_engine_runs(torch, params, cfg, launches, chain_variant)
    serve_http_run(torch, params, cfg, launches)

    # one 7B step at B=8, positions around 1500, with the chain
    g.manual_seed(5)
    tok8 = torch.randint(3, cfg.vocab_size, (8, 1), dtype=torch.int32,
                         device="cuda", generator=g)
    pos8 = torch.tensor([1500, 1490, 1400, 1300, 1200, 1100, 1050, 1024],
                        dtype=torch.int32, device="cuda")
    with down_qkv_switch(True):
        run_path(torch, "forward_7b_chain", lambda: forward_check(
            torch, params, cfg, "b8_down_qkv_chain", tok8, pos8, False, g,
            attn_impl="fused_step"), launches)
    if launches["forward_7b_chain"]["kernels"]["down_qkv"] != \
            cfg.n_layers - 1:
        raise AssertionError("forward_7b_chain: expected one chain launch "
                             "per layer boundary")


def chain_sequence(torch, attn, x, nw, wo, wgu, wd, wq=None, nw2=None):
    """The standalone launches ffn_chain replaces, forced onto the GEMV
    (not counted): o with the residual and rms_scale, gate_up with the
    rmsnorm prologue, down with SwiGLU, the residual and rms_scale, and
    the next qkv with the rmsnorm prologue. Returns the chain's outputs
    and the input of each of the four products."""
    from llama_cu_awq_torch.ops.cuda.int4_matmul import _launch

    m, bf16 = attn.shape[0], torch.bfloat16
    x1, ss1 = _launch(attn, wo, res=x, out_dtype=bf16, eps=1e-5,
                      kernel="gemv")
    gu, _ = _launch(x1, wgu, ss=ss1.reshape(m), nw=nw, out_dtype=bf16,
                    kernel="gemv")
    g, u = gu.chunk(2, dim=-1)
    out, ss = _launch(g, wd, u2=u, res=x1, out_dtype=bf16, eps=1e-5,
                      kernel="gemv")
    outs = (out, ss)
    if wq is not None:
        outs += (_launch(out, wq, ss=ss.reshape(m), nw=nw2, out_dtype=bf16,
                         kernel="gemv")[0],)
    h = (torch.nn.functional.silu(g.float()) * u.float()).bfloat16()
    return outs, (attn, x1, h, out)


def chain_bound(ws, m, inputs, outputs, extra_bytes=0, extra_flops=0):
    """bound_ms of the chain's products at m rows, plus what attention
    adds for mono_layer."""
    return bound_ms(
        sum(nbytes(w.qw, w.scales, w.zeros) for w in ws)
        + nbytes(*inputs, *outputs) + extra_bytes,
        2 * m * sum(w.n_in * w.n_out for w in ws) + extra_flops)


def vs_composed(name, got, want):
    """The kernel's outputs against the launch sequence it replaces, bit
    for bit."""
    diffs = [float((a.float() - b.float().reshape(a.shape)).abs().max())
             for a, b in zip(got, want) if a is not None]
    equal = all(torch_equal(a, b) for a, b in zip(got, want))
    print(json.dumps({
        "check": f"{name}/vs_composed", "max_abs_err": max(diffs),
        "max_abs_err_each_output": diffs, "bit_equal": equal,
        "why": "each column sums in the standalone GEMV's order, each rms "
               "scale in rms_scale's, and mono's attention stage runs "
               "attention_step's split items and combine "
               "(decode_attention.cuh step_split)"}),
        flush=True)
    if not equal:
        raise AssertionError(f"{name}: differs from the launch sequence it "
                             f"replaces (max abs err {diffs})")


def torch_equal(a, b):
    """Equal bits in any shape (both None counts as equal)."""
    if a is None or b is None:
        return a is None and b is None
    return (a.dtype == b.dtype and a.numel() == b.numel()
            and bool((a.reshape(-1) == b.reshape(-1)).all()))


def chain_rows(torch, timer, rows, g):
    """ffn_chain (with the next layer's qkv) at m=1 and m=8, and mono_layer
    at m=1 over bf16 and int8 KV at position 1500 of a 2048-row window and
    at m=8 over bf16 KV at positions 960-1100, all at 7B shapes (o 4096x
    4096, gate_up 4096x22016, down 11008x4096, qkv 4096x12288, 32 MHA
    heads of 128): against the plain versions (chain_tol; new cache rows
    and scales bit-equal), and bit for bit against the launch sequence
    each replaces, whose time stands beside the kernel's (composed_ms).
    mono_layer is also held bit for bit to attention_step followed by
    ffn_chain, the two launches it must beat, timed as pair_ms.
    library_ms: the four products through torch._weight_int4pack_mm, plus
    SDPA over the window's rows for mono over bf16 KV."""
    from llama_cu_awq_torch.experiments.int4_chain import (ffn_chain,
                                                           mono_layer)
    from llama_cu_awq_torch.ops.cuda.attention_step import (attention_step,
                                                            rope_rows)
    from llama_cu_awq_torch.quant.qtensor import QTensor

    dim, hid, H, D, S = 4096, 11008, 32, 128, 2048
    ws = [random_qtensor(torch, QTensor, dim, dim, g),
          random_qtensor(torch, QTensor, dim, 2 * hid, g),
          random_qtensor(torch, QTensor, hid, dim, g),
          random_qtensor(torch, QTensor, dim, 3 * dim, g)]
    nw = torch.rand(dim, device="cuda", generator=g) + 0.5
    nw2 = torch.rand(dim, device="cuda", generator=g) + 0.5
    kw = dict(eps=1e-5, wqkv_next=ws[3], attn_norm_next=nw2)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g).bfloat16()

    def library(prod_inputs, sdpa=None):
        calls = [int4pack_library(torch, w, x)
                 for w, x in zip(ws, prod_inputs)]
        if sdpa is not None:
            calls.append(sdpa)
        return timer(lambda: [c() for c in calls])

    def row(name, kernel, variant, path, chk, ms, plain_ms, composed_ms,
            bound, lib, lib_call, replaces, pair_ms=None):
        rows.append(dict(
            name=name, kernel=kernel, route="cuda",
            source="llama_cu_awq_torch/csrc/int4_chain.cu",
            replaces=replaces, variant=variant, path=path, **chk, ms=ms,
            plain_ms=plain_ms, composed_ms=composed_ms, pair_ms=pair_ms,
            bound_ms=bound[0], bound_by=bound[1], library_ms=lib,
            library_call=lib_call))
        r = rows[-1]
        print(json.dumps({"kernel_check": r["name"], "kernel_ms": r["ms"],
                          **{k: r[k] for k in (
                              "max_abs_err", "rtol", "atol", "plain_ms",
                              "composed_ms", "pair_ms", "library_ms",
                              "bound_ms", "bound_by")}}), flush=True)

    for m, path in ((1, "chain_step_b_bf16"), (8, "forward_7b_chain_b8")):
        attn, x = randn(m, dim), randn(m, dim)
        args = (attn, x, nw, *ws[:3])
        got, variant = launched_variant(lambda: ffn_chain(*args, **kw))
        ref = ffn_chain(*args, plain=True, **kw)
        seq, prods = chain_sequence(torch, attn, x, nw, *ws, nw2)
        torch.cuda.synchronize()
        name = f"ffn_chain/m{m}"
        chk = check_close(name, got[0], ref[0], **chain_tol(ref[0]))
        check_close(f"{name}/ss", got[1], ref[1], **chain_tol(ref[1]))
        check_close(f"{name}/qkv", got[2], ref[2], **chain_tol(ref[2]))
        vs_composed(name, got, seq)
        row(name, "ffn_chain", variant, path, chk,
            timer(lambda: ffn_chain(*args, **kw)),
            timer(lambda: ffn_chain(*args, plain=True, **kw), iters=5),
            timer(lambda: chain_sequence(torch, attn, x, nw, *ws, nw2)),
            chain_bound(ws, m, (attn, x, nw, nw2), got),
            library(prods), "torch._weight_int4pack_mm x4 (o, gate_up, "
            "down, qkv)", "tools/experiments/int4_chain.py:479")

    for tag, positions, quant, path in (
            ("m1_bf16", [1500], False, "chain_step_c_bf16"),
            ("m1_int8", [1500], True, "chain_step_c_int8"),
            ("m8_bf16", [960 + 20 * i for i in range(8)], False,
             "forward_7b_chain_b8")):
        B = len(positions)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        cos2, sinm = rope_rows(pos, D, 10000.0)
        qkv, x = randn(B, 3 * dim), randn(B, dim)
        if quant:
            kc = torch.randint(-127, 128, (B, S, H, D), dtype=torch.int8,
                               device="cuda", generator=g)
            vc = torch.randint(-127, 128, (B, S, H, D), dtype=torch.int8,
                               device="cuda", generator=g)
            ks = torch.rand(B, S, H, device="cuda", generator=g) * 0.02
            vs = torch.rand(B, S, H, device="cuda", generator=g) * 0.02
        else:
            kc, vc = randn(B, S, H, D), randn(B, S, H, D)
            ks = vs = None
        args = (qkv, x, nw, *ws[:3], kc, vc, pos, cos2, sinm, ks, vs)
        mkw = dict(n_heads=H, attn_len=S, **kw)
        got, variant = launched_variant(lambda: mono_layer(*args, **mkw))
        ref = mono_layer(*args, plain=True, **mkw)

        def composed():
            a = attention_step(qkv, kc, vc, pos, cos2, sinm, ks, vs,
                               n_heads=H)
            outs, prods = chain_sequence(
                torch, a[0].reshape(B, dim).bfloat16(), x, nw, *ws, nw2)
            return outs[:2] + a[1:] + outs[2:], prods

        def pair():
            a = attention_step(qkv, kc, vc, pos, cos2, sinm, ks, vs,
                               n_heads=H)
            outs = ffn_chain(a[0].reshape(B, dim).bfloat16(), x, nw,
                             *ws[:3], **kw)
            return outs[:2] + a[1:] + outs[2:]

        want, prods = composed()
        two = pair()
        torch.cuda.synchronize()
        name = f"mono_layer/{tag}"
        chk = check_close(name, got[0], ref[0], **chain_tol(ref[0]))
        check_close(f"{name}/ss", got[1], ref[1], **chain_tol(ref[1]))
        check_close(f"{name}/qkv", got[6], ref[6], **chain_tol(ref[6]))
        for i, part in ((2, "k_new"), (3, "v_new"), (4, "k_s"), (5, "v_s")):
            if not torch_equal(got[i], ref[i]):
                raise AssertionError(
                    f"{name}: {part} differs from the plain version (must "
                    f"be bit-equal: same IEEE rope, division and "
                    f"round-half-even)")
        vs_composed(name, got, want)
        vs_composed(f"{name}/pair", got, two)
        hist = sum(positions) * H * D * kc.element_size() * 2
        hist += sum(positions) * H * 4 * 2 if quant else 0
        bound = chain_bound(
            ws, B, (qkv, x, nw, nw2, pos, cos2, sinm),
            [t for t in got if t is not None], hist,
            sum(4 * (p + 1) * H * D for p in positions))
        sdpa = None
        lib_call = "torch._weight_int4pack_mm x4 (o, gate_up, down, qkv)"
        if not quant:
            # the window's pos + 1 keys, each slot under its own mask
            n = max(positions) + 1
            mask = (torch.arange(n, device="cuda")[None, :]
                    <= pos[:, None])[:, None, None, :]
            sdpa = sdpa_library(torch, qkv[:, :dim].reshape(B, H, D),
                                kc[:, :n], vc[:, :n],
                                mask if B > 1 else None)
            lib_call += " + F.scaled_dot_product_attention"
        row(name, "mono_layer", variant, path, chk,
            timer(lambda: mono_layer(*args, **mkw)),
            timer(lambda: mono_layer(*args, plain=True, **mkw), iters=5),
            timer(composed), bound, library(prods, sdpa) if not quant
            else None, lib_call if not quant else
            "none: no call reads int8 codes with row scales",
            "tools/experiments/int4_chain.py:627", timer(pair))
        del kc, vc


def chain_prefill(torch, eng, prompt):
    """prompt[:-1] through the engine's _prefill; returns prompt[-1] as the
    (1, 1) token that starts chain_decode."""
    eng.reset()
    eng._prefill(prompt[:-1])
    torch.cuda.synchronize()
    return torch.tensor([[prompt[-1]]], dtype=torch.int32,
                        device=eng.device)


def chain_decode(torch, eng, token, steps, impl):
    """`steps` greedy T=1 steps from token at the engine's position and
    bucket, each through forward (impl "forward": attn_impl="fused_step")
    or decode_step (impl "ffn_chain" or "mono"), the sampled token kept on
    the card and one host sync at the end. Returns (tokens, decode
    tokens/s)."""
    t0 = time.perf_counter()
    toks = []
    for _ in range(steps):
        token = chain_step(torch, eng, token, impl)
        toks.append(token)
    out = torch.cat(toks).reshape(-1).tolist()
    return out, steps / (time.perf_counter() - t0)


def chain_step(torch, eng, token, impl):
    """One greedy step of chain_decode at eng.pos; returns the (1, 1)
    next token on the card."""
    from llama_cu_awq_torch.experiments.int4_chain import decode_step
    from llama_cu_awq_torch.models import forward

    pos = position(torch, eng)
    attn_len = eng._bucket_for(eng.pos + 1)
    if impl == "forward":
        logits, _ = forward(eng.params, eng.cfg, token, pos, eng.cache,
                            attn_len=attn_len, attn_impl="fused_step")
    else:
        logits, _ = decode_step(eng.params, eng.cfg, token, pos, eng.cache,
                                layer_impl=impl, attn_len=attn_len)
    eng.pos += 1
    return logits.argmax(-1).to(torch.int32)[:, None]


CHAIN_IMPLS = (("a", "forward"), ("b", "ffn_chain"), ("c", "mono"))


def chain_phase(torch, timer, rows, params, launches):
    """ffn_chain and mono_layer at 7B (see the module docstring, phase
    8)."""
    from llama_cu_awq_torch.config import LLAMA2_7B
    from llama_cu_awq_torch.engine import InferenceEngine
    from llama_cu_awq_torch.experiments.int4_chain import decode_step
    from llama_cu_awq_torch.models import forward, init_kv_cache

    cfg = LLAMA2_7B
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    chain_rows(torch, timer, rows, g)

    prompt = [1] + [3 + (7919 * i) % 31990 for i in range(1023)]
    for fmt, kv_quant in (("bf16", False), ("int8", True)):
        eng = InferenceEngine(params, cfg, None, temperature=0.0, seed=1234,
                              attn_impl="fused_step", kv_quant=kv_quant,
                              max_seq=2048)
        chain_decode(torch, eng, chain_prefill(torch, eng, prompt[:200]),
                     4, "mono")  # warm-up
        res = {}
        # in turns (a, b, c, c, b, a): the host clock moves between runs;
        # the counters see the decode steps only
        for letter, impl in CHAIN_IMPLS + CHAIN_IMPLS[::-1]:
            name = f"chain_step_{letter}_{fmt}"
            if name in launches:
                name += "_again"
            token = chain_prefill(torch, eng, prompt)
            res.setdefault(letter, []).append(run_path(
                torch, name, lambda i=impl, t=token: chain_decode(
                    torch, eng, t, 32, i), launches))
        # (a), (b) and (c) run the same split attention and sum alike:
        # equal streams
        streams = [r[0] for letter in "abc" for r in res[letter]]
        equal = all(s == streams[0] for s in streams)
        per_step = {letter: {k: v / 32 for k, v in launches[
            f"chain_step_{letter}_{fmt}"]["kernels"].items() if v}
            for letter, _ in CHAIN_IMPLS}
        print(json.dumps({
            "e2e": f"chain_step_7b_{fmt}", "model": "llama2-7b",
            "kv": fmt, "prompt_tokens": 1024, "max_seq": 2048,
            "decode_steps": 32,
            "decode_tok_per_s": {f"{letter}_{impl}": [r[1] for r in
                                                      res[letter]]
                                 for letter, impl in CHAIN_IMPLS},
            "launches_per_step": per_step, "streams_equal_a_b_c": equal,
            "first_tokens": streams[0][:8]}), flush=True)
        if not equal:
            raise AssertionError(f"chain_step_7b_{fmt}: (a), (b) and (c) "
                                 f"gave different streams")
        # a step: (b) and (c) launch layer 0's qkv GEMV and one chain or
        # mono launch a layer; (a) the 4 GEMVs a layer
        want = {("a", "int4_matmul_fused"): 128, ("b", "ffn_chain"): 32,
                ("b", "int4_matmul_fused"): 1, ("c", "mono_layer"): 32,
                ("c", "int4_matmul_fused"): 1}
        for (letter, kname), n in want.items():
            got = per_step[letter].get(kname, 0)
            if got != n:
                raise AssertionError(f"chain_step_{letter}_{fmt}: {got} "
                                     f"{kname} launches a step, not {n}")
        if per_step["c"].get("attention_step") or \
                per_step["c"].get("ffn_chain"):
            raise AssertionError(f"chain_step_c_{fmt}: launched "
                                 f"attention_step or ffn_chain")
        # one step of each way at the position the runs reached
        for letter, impl in CHAIN_IMPLS:
            def prepare(base=eng.pos):
                eng.pos = base
                tok = torch.tensor([[5]], dtype=torch.int32, device="cuda")
                torch.cuda.synchronize()
                return (tok,)

            profile_run(torch, f"chain_step_{letter}_{impl}_{fmt}_pos"
                        f"{eng.pos}", prepare,
                        lambda tok, i=impl: chain_step(torch, eng, tok, i),
                        1, "step")
        del eng

    # one 7B step at B=8 from the same random cache through (a), (b), (c)
    g.manual_seed(9)
    tok8 = torch.randint(3, cfg.vocab_size, (8, 1), dtype=torch.int32,
                         device="cuda", generator=g)
    pos8 = torch.tensor([960 + 20 * i for i in range(8)], dtype=torch.int32,
                        device="cuda")
    cache = random_cache(torch, cfg, False, g, batch=8)

    def b8_step():
        logits = {}
        for letter, impl in CHAIN_IMPLS:
            c = init_kv_cache(cfg, 8, 2048)
            for dst, src in zip(c.k + c.v, cache.k + cache.v):
                dst.copy_(src)
            if impl == "forward":
                out, _ = forward(params, cfg, tok8, pos8, c,
                                 attn_impl="fused_step")
            else:
                out, _ = decode_step(params, cfg, tok8, pos8, c,
                                     layer_impl=impl)
            logits[letter] = out
            del c
        return logits

    logits = run_path(torch, "forward_7b_chain_b8", b8_step, launches)
    a = logits["a"]
    diffs = {k: float((v - a).abs().max()) for k, v in logits.items()}
    equal = {k: torch_equal(v, a) for k, v in logits.items()}
    print(json.dumps({
        "forward_7b": "chain_b8", "rows": 8, "positions": pos8.tolist(),
        "max_abs_logit_diff_vs_a": diffs, "bit_equal_vs_a": equal,
        "max_abs_logit": float(a.abs().max()),
        "finite": bool(torch.isfinite(a).all()),
        "why": "(b) and (c) sum every column, rms scale and attention row "
               "in the order of (a)'s launches"}), flush=True)
    if not (equal["b"] and equal["c"] and bool(torch.isfinite(a).all())):
        raise AssertionError(f"forward_7b chain_b8: logits differ from (a): "
                             f"{diffs}")
    lb8 = launches["forward_7b_chain_b8"]["kernels"]
    if lb8["ffn_chain"] != cfg.n_layers or lb8["mono_layer"] != cfg.n_layers:
        raise AssertionError(f"forward_7b chain_b8: launches {lb8}")
    del cache


def graph_table(eng):
    """Per graph of an engine: its kind, block width, window, attention
    path, capture seconds and the bytes the shared pool grew by."""
    return [{"kind": repr(k[0]), "T": k[1], "window": k[2],
             "attn_impl": k[3].attn_impl, "capture_s": g.capture_seconds,
             "pool_bytes": g.pool_bytes}
            for k, g in eng._graphs.graphs.items()]


def graph_summary(eng):
    """An engine's graphs: how many of each kind, and the capture seconds
    and the bytes its pool grew by, summed."""
    graphs = eng._graphs.graphs
    by_kind: dict[str, int] = {}
    for k in graphs:
        kind = k[0][0] if isinstance(k[0], tuple) else k[0]
        by_kind[kind] = by_kind.get(kind, 0) + 1
    return {"graphs": len(graphs), "by_kind": by_kind,
            "capture_s": sum(g.capture_seconds for g in graphs.values()),
            "pool_bytes": sum(g.pool_bytes for g in graphs.values())}


def caches_equal(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        a.cache.k + a.cache.v + a.cache.k_scale + a.cache.v_scale,
        b.cache.k + b.cache.v + b.cache.k_scale + b.cache.v_scale))


def graph_turns(torch, name, engs, run, launches,
                warm=("graph", "eager"),
                turns=("eager", "graph", "graph", "eager")):
    """run(engine) once untimed for each way in `warm` (the graph engine
    captures there), then in `turns`; the launches of the first timed
    turn each way go under `name` and `name`_eager and must be equal.
    Returns {way: [results]}."""
    for way in warm:
        run(engs[way])
    out = {"graph": [], "eager": []}
    for i, way in enumerate(turns):
        tag = name if way == "graph" else name + "_eager"
        out[way].append(run_path(torch, tag, lambda: run(engs[way]),
                                 launches) if i < 2 else run(engs[way]))
    if launches[name] != launches[name + "_eager"]:
        raise AssertionError(f"{name}: graph and eager launch counts "
                             f"differ")
    return out


def chunk_against_steps(torch, eng, prompt, reps=5):
    """The design choice of the decode graph: one chunk of 16 steps as 16
    replays of the one-step graph (what the engine runs) against one
    replay of a graph of all 16 steps, from the same state at the 512
    bucket, in turns; host clock around each chunk and a sync."""
    k, attn_len = eng.chunk_size, 512
    eng.generate_benchmark(prompt, 300)  # the step graph at 512 exists
    body = functools.partial(eng._decode_body, attn_len)
    step_key = eng._graph_key("decode", 1, attn_len)
    chunk_key = ("decode_chunk",) + step_key[1:]

    def chunk_body():
        for _ in range(k):
            body()

    start = eng.pos
    eng._start()
    eng._graphs.run(chunk_key, chunk_body)  # eager once, then captured
    times = {"step_graph_x16": [], "chunk_graph_x1": []}
    outs = {}
    for way in ("step_graph_x16", "chunk_graph_x1", "chunk_graph_x1",
                "step_graph_x16") * reps:
        eng.pos = start
        eng._start()
        eng._tok.fill_(prompt[-1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if way == "step_graph_x16":
            eng._graphs.run(step_key, body, k)
        else:
            eng._graphs.run(chunk_key, chunk_body)
        torch.cuda.synchronize()
        times[way].append(time.perf_counter() - t0)
        outs[way] = eng._out.tolist()
    chunk_graph = eng._graphs.graphs[chunk_key]
    print(json.dumps({
        "graph_design": "decode_chunk_16_at_512", "position": start,
        **{f"{w}_ms_per_token": statistics.median(t) / k * 1e3
           for w, t in times.items()},
        "chunk_graph_capture_s": chunk_graph.capture_seconds,
        "chunk_graph_pool_bytes": chunk_graph.pool_bytes,
        "tokens_equal": outs["step_graph_x16"] == outs["chunk_graph_x1"]}),
        flush=True)
    if outs["step_graph_x16"] != outs["chunk_graph_x1"]:
        raise AssertionError("the chunk graph and the step graph differ")
    del eng._graphs.graphs[chunk_key]


# the graph phase's main-path depth: 128 of the main path's 256 steps,
# since an eager 7B run of 256 steps takes about 8.5 s on an H100
GRAPH_STEPS = 128


def graph_phase(torch, params, launches):
    """The engine's CUDA graphs against eager launches at 7B (see the
    module docstring, phase 9)."""
    from llama_cu_awq_torch.config import LLAMA2_7B
    from llama_cu_awq_torch.engine import InferenceEngine

    cfg = LLAMA2_7B

    def engines(**kw):
        return {way: InferenceEngine(params, cfg, None, seed=1234,
                                     capture=way == "graph",
                                     **{"temperature": 0.0, **kw})
                for way in ("graph", "eager")}

    def report(name, engs, res, metric, **extra):
        first = res["eager"][0][0]
        equal = all(r[0] == first for r in res["graph"] + res["eager"])
        same_cache = caches_equal(torch, engs["graph"], engs["eager"])
        print(json.dumps({
            "e2e": name, "model": "llama2-7b",
            f"{metric}_graph": [r[1] for r in res["graph"]],
            f"{metric}_eager": [r[1] for r in res["eager"]],
            "tokens_equal": equal, "caches_bit_equal": same_cache,
            "first_tokens": first[:8], **extra,
            "graphs": graph_table(engs["graph"])}), flush=True)
        if not (equal and same_cache):
            raise AssertionError(f"{name}: the graphs and eager launches "
                                 f"differ")

    # --- the main path: GRAPH_STEPS greedy steps, windows 128-256 ---
    prompt = list(range(5, 13))
    engs = engines(max_seq=512)
    res = graph_turns(torch, "graph_main", engs,
                      lambda e: e.generate_benchmark(prompt,
                                                     GRAPH_STEPS)[::2],
                      launches)
    report("graph_main", engs, res, "tok_per_s", steps=GRAPH_STEPS,
           max_seq=512)
    profile_decode(torch, engs["eager"], prompt, label="decode_chunk_eager")
    profile_decode(torch, engs["graph"], prompt, label="decode_chunk_graph")
    chunk_against_steps(torch, engs["graph"], prompt)
    del engs
    # sampled at the CLI's defaults
    engs = engines(max_seq=512, temperature=0.5, topp=0.6)
    res = {way: [engs[way].generate_benchmark(prompt, GRAPH_STEPS)[::2]]
           for way in ("graph", "eager")}
    report("graph_main_sampled", engs, res, "tok_per_s", steps=GRAPH_STEPS,
           temperature=0.5, topp=0.6)
    del engs

    # --- fused_step at the 2048 bucket after a 1024-token prompt ---
    long = [1] + [3 + (7919 * i) % 31990 for i in range(1919)]
    for name, kv_quant in (("graph_fused_step_bf16", False),
                           ("graph_fused_step_int8kv", True)):
        engs = engines(attn_impl="fused_step", kv_quant=kv_quant,
                       max_seq=2048)
        res = graph_turns(torch, name, engs, lambda e: decode_run(
            torch, e, long[:1024], 64), launches)
        report(name, engs, res, "decode_tok_per_s", decode_steps=64)
        del engs

    # --- the 1920-token prompt: time to first token ---
    engs = engines(max_seq=2048)
    res = graph_turns(torch, "graph_prefill", engs, lambda e: (
        e.generate_benchmark(long, len(long))[:2]), launches)
    report("graph_prefill", engs, res, "time_to_first_token_s",
           prompt_tokens=len(long))

    def prepare_block(e):
        def prepare():
            e.reset()
            e._prefill(long[:1024])
            torch.cuda.synchronize()
            return (long[1024:1152],)
        return prepare

    for way in ("eager", "graph"):
        profile_run(torch, f"prefill_block_pos1024_{way}",
                    prepare_block(engs[way]), engs[way]._prefill, 1,
                    "block")
    del engs


# --act-dtype float16: fp16's largest finite value, and the depth of the
# phase's fp16 runs. The synthetic weights' codes average 7.5 against zero
# points of 8, so every output column carries a bias of the same sign, and
# the residual stream grows by about 25,000 a layer: past 65,504 from the
# fourth layer on (act_dtype_phase's overflow sweep prints where, through
# the kernels and through the plain versions, every run). So the fp16
# runs are cut to two layers, at 7B's widths; f32 runs all 32.
F16_MAX = 65504.0
F16_LAYERS = 2
ACT_PROMPT = list(range(5, 13))


@contextlib.contextmanager
def residual_probe():
    """The largest |x| entering the final rmsnorm of each forward while
    the context is open (a host sync a call: direct forwards only, never
    inside a graph capture)."""
    from llama_cu_awq_torch.models import llama as ml

    seen = []
    orig = ml.final_logits

    def probe(params, x, ss, act_dtype, logits_all, plain):
        seen.append(float(x.float().abs().max()))
        return orig(params, x, ss, act_dtype, logits_all, plain)

    ml.final_logits = probe
    try:
        yield seen
    finally:
        ml.final_logits = orig


def act_params(params, act, layers):
    """The synthetic params cut to `layers`, with embed and lm_head in the
    JAX CLI's type for act (cli.py:131: float16 keeps an fp16 head,
    float32 stores an f32 one; here the synthetic bf16 values widened);
    the layers are shared, not copied."""
    import dataclasses

    return dataclasses.replace(params, embed=params.embed.to(act),
                               lm_head=params.lm_head.to(act),
                               layers=params.layers[:layers])


def fp16_overflow_sweep(torch, params, cfg):
    """The 8-token prompt's forward at depths 1-6 and 32: in fp16 through
    the kernels and through the plain versions (which must turn
    non-finite at the same depth), and the largest residual |x| in f32.
    Returns the first depth whose fp16 logits are not finite."""
    import dataclasses

    from llama_cu_awq_torch.models import forward, init_kv_cache

    depths = [1, 2, 3, 4, 5, 6, cfg.n_layers]
    toks = torch.tensor([ACT_PROMPT], device="cuda")
    pos = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = {"f16_finite_kernel": [], "f16_finite_plain": [],
           "f16_residual_absmax": [], "f32_residual_absmax": []}
    for d in depths:
        c = dataclasses.replace(cfg, n_layers=d)
        for act, plain, key in ((torch.float16, False, "kernel"),
                                (torch.float16, True, "plain"),
                                (torch.float32, False, None)):
            cache = init_kv_cache(c, 1, 128, dtype=act)
            with residual_probe() as seen:
                lg, _ = forward(act_params(params, act, d), c, toks, pos,
                                cache, act_dtype=act, plain=plain)
            if key:
                out[f"f16_finite_{key}"].append(bool(lg.isfinite().all()))
                if key == "kernel":
                    out["f16_residual_absmax"].append(seen[0])
            else:
                out["f32_residual_absmax"].append(seen[0])
    first = next((d for d, ok in zip(depths, out["f16_finite_kernel"])
                  if not ok), None)
    print(json.dumps({"fp16_overflow": "synthetic llama2-7b", "depths": depths,
                      **out, "first_nonfinite_depth": first,
                      "fp16_max": F16_MAX, "f16_runs_layers": F16_LAYERS}),
          flush=True)
    if out["f16_finite_kernel"] != out["f16_finite_plain"]:
        raise AssertionError("fp16: the kernels and the plain versions "
                             "overflow at different depths")
    if first is not None and first <= F16_LAYERS:
        raise AssertionError(f"fp16 overflows at depth {first}, within the "
                             f"{F16_LAYERS} layers of the fp16 runs")
    return first


def act_kernel_rows(torch, timer, rows, g, act):
    """The fp16 or f32 form of each kernel on the act_dtype paths at 7B
    shapes, against its plain version on the same inputs: the w4 down
    projection (SwiGLU prologue, act residual and output, rms scale) at
    m=1, 8 and 128; attention_step MHA at position 1500;
    batched_decode_attention at B=8 over positions 960-1100;
    prefill_attention at T=128, position 1024; down_qkv at m=1. Library:
    SDPA in the same type for the attention rows; no PyTorch call takes
    w4 codes with fp16 or f32 activations (torch._weight_int4pack_mm
    takes bf16), so the w4 rows have none."""
    from llama_cu_awq_torch.ops.cuda.attention_step import (attention_step,
                                                            rope_rows)
    from llama_cu_awq_torch.ops.cuda.batched_attention import (
        batched_decode_attention)
    from llama_cu_awq_torch.ops.cuda.down_qkv import down_qkv_fused
    from llama_cu_awq_torch.ops.cuda.int4_matmul import int4_matmul_fused
    from llama_cu_awq_torch.ops.cuda.prefill_attention import (
        prefill_attention)
    from llama_cu_awq_torch.quant.qtensor import QTensor

    name = "f16" if act == torch.float16 else "f32"
    dim, hid, S, H, D = 4096, 11008, 2048, 32, 128

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=g)
                * scale).to(act)

    def add(tag, kernel, source, replaces, variant, path, chk, fn, plain_fn,
            b, src, lib):
        rows.append(dict(
            name=f"{kernel}/{tag}_{name}", kernel=kernel, route="cuda",
            source=f"llama_cu_awq_torch/csrc/{source}",
            replaces=replaces, variant=variant, path=path, **chk,
            ms=timer(fn), plain_ms=timer(plain_fn, iters=5), bound_ms=b,
            bound_by=src, library_ms=None if lib is None else timer(lib)))

    # the w4 down projection, at decode, serving and prefill row counts
    wd = random_qtensor(torch, QTensor, hid, dim, g)
    for m, path in ((1, "main"), (8, "batch_engine"), (128, "fused_step")):
        gate, up = randn(m, 2 * hid).chunk(2, dim=-1)
        kw = dict(silu_u=up, residual=randn(m, dim, scale=8.0),
                  emit_ss_eps=1e-5, out_dtype=act)
        (out, ss), variant = launched_variant(
            lambda: int4_matmul_fused(gate, wd, **kw))
        ref, ss_ref = int4_matmul_fused(gate, wd, plain=True, **kw)
        torch.cuda.synchronize()
        tag = f"down_silu_residual_ss_m{m}"
        chk = check_close(f"int4_matmul_fused/{tag}_{name}", out, ref,
                          **INT4_TOL)
        check_close(f"int4_matmul_fused/{tag}_{name}/ss", ss, ss_ref,
                    **INT4_TOL)
        b, src = bound_ms(nbytes(wd.qw, wd.scales, wd.zeros, gate, up,
                                 kw["residual"], out, ss),
                          2 * m * hid * dim)
        add(tag, "int4_matmul_fused", int4_source(variant).split("/")[-1],
            "llama_cu_awq_tpu/ops/pallas/int4_matmul.py:543", variant,
            f"act_{name}_{path}", chk,
            lambda: int4_matmul_fused(gate, wd, **kw),
            lambda: int4_matmul_fused(gate, wd, plain=True, **kw), b, src,
            None)

    # attention_step, MHA, a cache of the activation type, position 1500
    pos_v = 1500
    pos = torch.tensor([pos_v], dtype=torch.int32, device="cuda")
    cos2, sinm = rope_rows(pos, D, 10000.0)
    qkv, kc, vc = randn(1, 3 * H * D), randn(1, S, H, D), randn(1, S, H, D)
    args = (qkv, kc, vc, pos, cos2, sinm)
    outs, variant = launched_variant(lambda: attention_step(*args,
                                                            n_heads=H))
    refs = attention_step(*args, n_heads=H, plain=True)
    torch.cuda.synchronize()
    chk = check_close(f"attention_step/mha32_{name}", outs[0], refs[0],
                      **ATTN_TOL)
    if not (torch.equal(outs[1], refs[1]) and torch.equal(outs[2], refs[2])):
        raise AssertionError(f"attention_step/mha32_{name}: the new rows "
                             f"differ from the plain version")
    b, src = bound_ms(pos_v * H * D * kc.element_size() * 2
                      + nbytes(qkv, cos2, sinm, *outs),
                      4 * (pos_v + 1) * H * D)
    add("mha32", "attention_step", "attention_step.cu",
        "llama_cu_awq_tpu/ops/pallas/attention_step.py:425", variant,
        f"act_{name}_fused_step", chk,
        lambda: attention_step(*args, n_heads=H),
        lambda: attention_step(*args, n_heads=H, plain=True), b, src,
        sdpa_library(torch, qkv[:, :H * D].reshape(1, H, D),
                     kc[:, :pos_v + 1], vc[:, :pos_v + 1], dtype=act))

    # batched_decode_attention, 8 slots at positions 960-1100
    B = len(B8_POSITIONS)
    pos8 = torch.tensor(B8_POSITIONS, dtype=torch.int32, device="cuda")
    q, kc8, vc8 = randn(B, H, D), randn(B, S, H, D), randn(B, S, H, D)
    args = (q, kc8, vc8, pos8)
    out, variant = launched_variant(
        lambda: batched_decode_attention(*args, attn_len=S))
    ref = batched_decode_attention(*args, attn_len=S, plain=True)
    torch.cuda.synchronize()
    chk = check_close(f"batched_decode_attention/b8_{name}", out, ref,
                      **ATTN_TOL)
    rows_read = sum(p + 1 for p in B8_POSITIONS)
    b, src = bound_ms(rows_read * H * D * kc8.element_size() * 2
                      + nbytes(q, out), 4 * rows_read * H * D)
    top = max(B8_POSITIONS) + 1
    mask = (torch.arange(top, device="cuda")[None, :]
            <= pos8[:, None])[:, None, None, :]
    add("b8", "batched_decode_attention", "batched_attention.cu",
        "llama_cu_awq_tpu/ops/pallas/batched_attention.py:179", variant,
        f"act_{name}_batch_engine", chk,
        lambda: batched_decode_attention(*args, attn_len=S),
        lambda: batched_decode_attention(*args, attn_len=S, plain=True), b,
        src, sdpa_library(torch, q, kc8[:, :top], vc8[:, :top], mask,
                          dtype=act))

    # prefill_attention, a 128-token block at position 1024
    T, p0 = 128, 1024
    qb = randn(1, T, H, D)
    posb = torch.tensor([p0], dtype=torch.int32, device="cuda")
    args = (qb, kc, vc, posb)
    out, variant = launched_variant(
        lambda: prefill_attention(*args, attn_len=S))
    ref = prefill_attention(*args, attn_len=S, plain=True)
    torch.cuda.synchronize()
    chk = check_close(f"prefill_attention/t128_pos1024_{name}", out, ref,
                      **ATTN_TOL)
    horizon = p0 + T
    b, src = bound_ms(horizon * H * D * kc.element_size() * 2
                      + nbytes(qb, out),
                      4 * (T * p0 + T * (T + 1) // 2) * H * D)
    qh = qb.transpose(1, 2).contiguous()
    kh = kc[:, :horizon].transpose(1, 2).contiguous()
    vh = vc[:, :horizon].transpose(1, 2).contiguous()
    pmask = (torch.arange(horizon, device="cuda")[None, :]
             <= p0 + torch.arange(T, device="cuda")[:, None])
    add("t128_pos1024", "prefill_attention", "prefill_attention.cu",
        "llama_cu_awq_tpu/ops/pallas/prefill_attention.py:189", variant,
        f"act_{name}_fused_step", chk,
        lambda: prefill_attention(*args, attn_len=S),
        lambda: prefill_attention(*args, attn_len=S, plain=True), b, src,
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=pmask))

    # down_qkv at m=1: x2 and qkv in the activation type
    wq = random_qtensor(torch, QTensor, dim, 3 * dim, g)
    gate, up = randn(1, 2 * hid).chunk(2, dim=-1)
    res = randn(1, dim, scale=8.0)
    nw = torch.rand(dim, device="cuda", generator=g) + 0.5
    args = (gate, up, res, wd, wq, nw)
    kw = dict(eps=1e-5, out_dtype=act, x2_dtype=act)
    (x2, ss2, qkvo), variant = launched_variant(
        lambda: down_qkv_fused(*args, **kw))
    rx2, rss2, rqkv = down_qkv_fused(*args, plain=True, **kw)
    torch.cuda.synchronize()
    chk = check_close(f"down_qkv/m1_{name}", qkvo, rqkv, **INT4_TOL)
    check_close(f"down_qkv/m1_{name}/x2", x2, rx2, **INT4_TOL)
    check_close(f"down_qkv/m1_{name}/ss2", ss2, rss2, **INT4_TOL)
    b, src = bound_ms(nbytes(wd.qw, wd.scales, wd.zeros, wq.qw, wq.scales,
                             wq.zeros, gate, up, res, nw, x2, ss2, qkvo),
                      2 * (hid * dim + dim * 3 * dim))
    add("m1", "down_qkv", "down_qkv.cu",
        "llama_cu_awq_tpu/ops/pallas/down_qkv.py:147", variant,
        f"act_{name}_down_qkv", chk, lambda: down_qkv_fused(*args, **kw),
        lambda: down_qkv_fused(*args, plain=True, **kw), b, src, None)
    for r in rows[-7:]:
        print(json.dumps({"kernel_check": r["name"], "kernel_ms": r["ms"],
                          **{k: r[k] for k in (
                              "max_abs_err", "rtol", "atol", "plain_ms",
                              "library_ms", "bound_ms", "bound_by")}}),
              flush=True)


def act_e2e(torch, params, cfg, act, launches):
    """One activation type end to end at `cfg`'s depth (see the module
    docstring, phase 10); bf16 beside it at the same depth."""
    import dataclasses

    from llama_cu_awq_torch.engine import BatchEngine, InferenceEngine
    from llama_cu_awq_torch.engine import engine as engine_mod
    from llama_cu_awq_torch.engine.perplexity import token_perplexity

    name = "f16" if act == torch.float16 else "f32"
    p_act = act_params(params, act, cfg.n_layers)
    p_bf16 = dataclasses.replace(params, layers=params.layers[:cfg.n_layers])
    long = [1] + [3 + (7919 * i) % 31990 for i in range(1023)]

    def engine(p, a, **kw):
        return InferenceEngine(p, cfg, None, temperature=0.0, seed=1234,
                               act_dtype=a, **kw)

    def valid(toks):
        return bool(toks) and all(0 <= t < cfg.vocab_size for t in toks)

    def cache_bytes(e):
        c = e.cache
        return nbytes(*c.k, *c.v, *c.k_scale, *c.v_scale)

    report = {"e2e": f"act_dtype_{name}", "model": "llama2-7b",
              "layers": cfg.n_layers}
    for tag, p, a in ((name, p_act, act), ("bf16", p_bf16, torch.bfloat16)):
        path = f"act_{name}" + ("" if a == act else "_bf16")
        # the main path: 64 greedy steps from an 8-token prompt
        eng = engine(p, a, max_seq=512)
        eng.generate_benchmark(ACT_PROMPT, 64)  # captures the graphs
        toks, _, tps = run_path(torch, f"{path}_main",
                                lambda: eng.generate_benchmark(ACT_PROMPT,
                                                               64), launches)
        if not valid(toks):
            raise AssertionError(f"{path}_main: bad tokens {toks[:8]}")
        report[f"main_tok_per_s_{tag}"] = tps
        report[f"main_first_tokens_{tag}"] = toks[:8]
        del eng
        # a 1024-token prompt (prefill_attention), then 32 fused_step
        # steps at the 2048 bucket
        eng = engine(p, a, attn_impl="fused_step", max_seq=2048)

        def fused_run(e=eng):
            first, ttft, _ = e.generate_benchmark(long, len(long))
            return first, ttft, *decode_run(torch, e, long, 32)

        fused_run()
        first, ttft, dtoks, dtps = run_path(torch, f"{path}_fused_step",
                                            fused_run, launches)
        if not (valid(first) and valid(dtoks)):
            raise AssertionError(f"{path}_fused_step: bad tokens")
        report[f"time_to_first_token_s_{tag}"] = ttft
        report[f"fused_step_tok_per_s_{tag}"] = dtps
        report[f"kv_cache_bytes_{tag}"] = cache_bytes(eng)
        del eng
    for kname in ("int4_matmul_fused", "attention_step",
                  "prefill_attention"):
        if not launches[f"act_{name}_fused_step"]["kernels"][kname]:
            raise AssertionError(f"act_{name}_fused_step never launched "
                                 f"{kname}")

    # 16 batched steps after the 1024-token prompt
    eng = engine(p_act, act, attn_impl="batched", max_seq=2048)
    decode_run(torch, eng, long, 16)
    dtoks, tps = run_path(torch, f"act_{name}_batched",
                          lambda: decode_run(torch, eng, long, 16), launches)
    if not valid(dtoks) or not launches[f"act_{name}_batched"]["kernels"][
            "batched_decode_attention"]:
        raise AssertionError(f"act_{name}_batched: bad run")
    report["batched_tok_per_s"] = tps
    del eng

    # 8 fused_step steps with the down->next-qkv chain
    with down_qkv_switch(True):
        eng = engine(p_act, act, attn_impl="fused_step", max_seq=256)
        eng.generate_benchmark(ACT_PROMPT, 16)
        toks, _, _ = run_path(torch, f"act_{name}_down_qkv",
                              lambda: eng.generate_benchmark(ACT_PROMPT, 16),
                              launches)
    if not valid(toks) or not launches[f"act_{name}_down_qkv"]["kernels"][
            "down_qkv"]:
        raise AssertionError(f"act_{name}_down_qkv: bad run")
    del eng

    # perplexity of 1023 ids through the kernels and the plain versions
    eng = engine(p_act, act, max_seq=2048)
    seq = [3 + (104729 * i) % 31990 for i in range(1023)]
    ppl_k = run_path(torch, f"act_{name}_perplexity",
                     lambda: token_perplexity(eng, seq), launches)
    eng_plain = engine(p_act, act, max_seq=2048, capture=False)
    kernel_forward = engine_mod.forward
    engine_mod.forward = functools.partial(kernel_forward, plain=True)
    try:
        ppl_p = token_perplexity(eng_plain, seq)
    finally:
        engine_mod.forward = kernel_forward
    del eng, eng_plain
    d = abs(math.log(ppl_k) - math.log(ppl_p))
    report.update(ppl_kernel=ppl_k, ppl_plain=ppl_p, abs_delta_ln_ppl=d)
    if not (math.isfinite(ppl_k) and d <= 0.01):
        raise AssertionError(f"act_{name} perplexity: kernels {ppl_k}, "
                             f"plain {ppl_p}")

    # BatchEngine: 8 slots, 8 requests, batched attention, graphs against
    # capture=False
    lengths = [20, 36, 60, 100, 150, 200, 260, 300]
    prompts = [[1] + [3 + (104729 * (i + 131 * j)) % 31990
                      for i in range(n - 1)]
               for j, n in enumerate(lengths)]
    engs = {way: BatchEngine(p_act, cfg, None, n_slots=8, max_seq=1024,
                             chunk_size=8, attn_impl="batched",
                             act_dtype=act, capture=way == "graph")
            for way in ("graph", "eager")}

    def serve_all(be):
        be.reset()
        rids = [be.submit(pr, max_new=32) for pr in prompts]
        out = be.run()
        return [out[r] for r in rids], be.stats()

    bname = f"act_{name}_batch_engine"
    res = graph_turns(torch, bname, engs, serve_all, launches,
                      warm=("graph",), turns=("eager", "graph"))
    first = res["eager"][0][0]
    equal = res["graph"][0][0] == first
    same_cache = caches_equal(torch, engs["graph"], engs["eager"])
    st = res["graph"][0][1]
    report.update({
        "batch_engine_tok_per_s_graph": st["tok_per_s"],
        "batch_engine_tok_per_s_eager": res["eager"][0][1]["tok_per_s"],
        "batch_engine_streams_equal": equal,
        "batch_engine_caches_bit_equal": same_cache,
        **{f"batch_engine_{k}": v
           for k, v in graph_summary(engs["graph"]).items()}})
    del engs
    if st["finished"] != len(prompts) or not all(map(valid, first)):
        raise AssertionError(f"{bname}: {st}")
    if not (equal and same_cache):
        raise AssertionError(f"{bname}: the graphs and eager launches "
                             f"differ")
    print(json.dumps(report), flush=True)

    # one 7B step at position 1500, kernels against plain versions
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    forward_check(torch, p_act, cfg, f"act_{name}_fused_step",
                  torch.tensor([[7]], dtype=torch.int32, device="cuda"),
                  torch.tensor([1500], dtype=torch.int32, device="cuda"),
                  False, g, attn_impl="fused_step", act_dtype=act)


def awq_ingest_check(torch):
    """The AWQ ingest at 7B's widths: one layer of a synthetic HF-AWQ
    safetensors directory (numpy, seed 0) through `python -m
    llama_cu_awq_torch.tools.pack_weights --model-dir`, the `.bin` loaded
    by the port's loader onto the card, and every projection of the layer
    dequantized there, bit for bit against (q - z) * s taken straight from
    the source tensors (AWQ's order_map nibble interleave undone here,
    independently of the port's code)."""
    import numpy as np

    from llama_cu_awq_torch.config import LLAMA2_7B
    from llama_cu_awq_torch.io.checkpoint import load_checkpoint
    from llama_cu_awq_torch.models import params_from_checkpoint

    t0 = time.time()
    cfg = LLAMA2_7B
    rng = np.random.default_rng(0)
    dim, hid, vocab = cfg.dim, cfg.hidden_dim, cfg.vocab_size
    shapes = {"self_attn.q_proj": (dim, dim), "self_attn.k_proj": (dim, dim),
              "self_attn.v_proj": (dim, dim), "self_attn.o_proj": (dim, dim),
              "mlp.gate_proj": (dim, hid), "mlp.up_proj": (dim, hid),
              "mlp.down_proj": (hid, dim)}
    tensors = {
        "model.embed_tokens.weight":
            (rng.standard_normal((vocab, dim), np.float32) * 0.02).astype(
                np.float16),
        "lm_head.weight": (rng.standard_normal((vocab, dim), np.float32)
                           * 0.02).astype(np.float16),
        "model.norm.weight": np.ones(dim, np.float16),
        "model.layers.0.input_layernorm.weight": np.ones(dim, np.float16),
        "model.layers.0.post_attention_layernorm.weight":
            np.ones(dim, np.float16)}
    for name, (n_in, n_out) in shapes.items():
        groups = n_in // 128
        base = f"model.layers.0.{name}."
        tensors[base + "qweight"] = rng.integers(
            0, 2 ** 32, (n_in, n_out // 8), dtype=np.uint32).view(np.int32)
        tensors[base + "qzeros"] = rng.integers(
            0, 2 ** 32, (groups, n_out // 8), dtype=np.uint32).view(np.int32)
        tensors[base + "scales"] = (rng.random((groups, n_out), np.float32)
                                    * 0.01 + 1e-4).astype(np.float16)
    with tempfile.TemporaryDirectory() as tmp:
        model_dir = os.path.join(tmp, "hf")
        os.makedirs(model_dir)
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump({"hidden_size": dim, "intermediate_size": hid,
                       "num_hidden_layers": 1, "num_attention_heads": 32,
                       "num_key_value_heads": 32, "vocab_size": vocab,
                       "max_position_embeddings": 4096,
                       "rope_theta": 10000.0}, f)
        header, blobs, off = {}, [], 0
        st = {np.dtype(np.float16): "F16", np.dtype(np.int32): "I32"}
        for name, a in tensors.items():
            raw = a.tobytes()
            header[name] = {"dtype": st[a.dtype], "shape": list(a.shape),
                            "data_offsets": [off, off + len(raw)]}
            off += len(raw)
            blobs.append(raw)
        hj = json.dumps(header).encode()
        with open(os.path.join(model_dir, "model.safetensors"), "wb") as f:
            f.write(struct.pack("<Q", len(hj)))
            f.write(hj)
            for b in blobs:
                f.write(b)
        out_bin = os.path.join(tmp, "model.bin")
        t1 = time.time()
        subprocess.run([sys.executable, "-m",
                        "llama_cu_awq_torch.tools.pack_weights",
                        "--model-dir", model_dir, out_bin], check=True,
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       timeout=600)
        pack_s = time.time() - t1
        ckpt = load_checkpoint(out_bin)
    params = params_from_checkpoint(ckpt, param_dtype=None)
    layer = params.layers[0]
    order = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7], device="cuda")
    shifts = 4 * torch.arange(8, device="cuda", dtype=torch.int64)

    def awq_values(words):
        """(h, w/8) AWQ words -> (h, w): nibble j of word k is column
        8 k + order[j]."""
        w = torch.from_numpy(words.view(np.uint32).astype(np.int64)).to(
            "cuda")
        nib = (w[:, :, None] >> shifts) & 0xF
        out = torch.empty_like(nib)
        out[:, :, order] = nib
        return out.reshape(w.shape[0], -1).float()

    checked = []
    for name, (n_in, n_out) in shapes.items():
        base = f"model.layers.0.{name}."
        q = awq_values(tensors[base + "qweight"])
        z = awq_values(tensors[base + "qzeros"])
        s = torch.from_numpy(tensors[base + "scales"].astype(
            np.float32)).to("cuda")
        gidx = torch.arange(n_in, device="cuda") // 128
        want = (q - z[gidx]) * s[gidx]  # (n_in, n_out)
        fused, lo = {"self_attn.q_proj": (layer.wqkv, 0),
                     "self_attn.k_proj": (layer.wqkv, dim),
                     "self_attn.v_proj": (layer.wqkv, 2 * dim),
                     "self_attn.o_proj": (layer.wo, 0),
                     "mlp.gate_proj": (layer.w_gate_up, 0),
                     "mlp.up_proj": (layer.w_gate_up, hid),
                     "mlp.down_proj": (layer.w_down, 0)}[name]
        got = fused.dequantize_t()[lo:lo + n_out].T
        if not torch.equal(got, want):
            raise AssertionError(f"awq ingest: {name} differs from the "
                                 f"source (max abs err "
                                 f"{float((got - want).abs().max())})")
        checked.append(name)
    embed_ok = torch.equal(params.embed.cpu(), torch.from_numpy(
        tensors["model.embed_tokens.weight"]))
    print(json.dumps({"awq_ingest": "llama2-7b widths, 1 layer",
                      "pack_seconds": pack_s, "seconds": time.time() - t0,
                      "projections_bit_equal": checked,
                      "embed_fp16_bit_equal": embed_ok}), flush=True)
    if not embed_ok:
        raise AssertionError("awq ingest: the embed lost its fp16 bits")


def act_dtype_phase(torch, timer, rows, params, launches):
    """--act-dtype float16 and float32 at 7B (see the module docstring,
    phase 10), and the AWQ ingest."""
    import dataclasses

    from llama_cu_awq_torch.config import LLAMA2_7B

    t0 = time.time()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the fp16 and f32 lm_head's f32 "
                             "product would round its operands")
    g = torch.Generator(device="cuda")
    g.manual_seed(10)
    fp16_overflow_sweep(torch, params, LLAMA2_7B)
    for act, layers in ((torch.float16, F16_LAYERS),
                        (torch.float32, LLAMA2_7B.n_layers)):
        act_kernel_rows(torch, timer, rows, g, act)
        act_e2e(torch, params, dataclasses.replace(LLAMA2_7B,
                                                   n_layers=layers),
                act, launches)
    awq_ingest_check(torch)
    print(json.dumps({"phase": "act_dtype", "seconds": time.time() - t0}),
          flush=True)


# ---------------------------------------------------------------------------
# phase 11: the served head type, and tensor parallelism on one card

def served_head_cost(torch, params, cfg):
    """The server's fp16 head against the bf16 head (see the module
    docstring, phase 11): graph engines of each kind, in turns after one
    untimed run each (the captures)."""
    import dataclasses

    from llama_cu_awq_torch.engine import BatchEngine
    from llama_cu_awq_torch.serve import make_server
    from llama_cu_awq_torch.tokenizer import Tokenizer

    heads = {"bf16": params, "fp16": dataclasses.replace(
        params, embed=params.embed.half(), lm_head=params.lm_head.half())}
    lengths = [20, 36, 48] + [60 + (1000 - 60) * i // 12 for i in range(13)]
    prompts = [[1] + [3 + (104729 * (i + 131 * j)) % 31990
                      for i in range(n - 1)]
               for j, n in enumerate(lengths)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_head_")
    tok = Tokenizer(write_toy_tokenizer(os.path.join(tmp, "tok.bin"),
                                        cfg.vocab_size), cfg.vocab_size)
    texts = [("the cat sat on the mat" * (1 + i % 3)) + " a" * i
             for i in range(8)]

    def batch(be):
        be.reset()
        for p in prompts:
            be.submit(p, max_new=64)
        be.run()
        return be.stats()["tok_per_s"]

    def serve(be):
        be.reset()
        httpd, seng = make_server(be, tok, host="127.0.0.1", port=0)
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        seng.start()
        try:
            t0 = time.perf_counter()
            res = [None] * len(texts)
            clients = [threading.Thread(target=lambda i=i: res.__setitem__(
                i, http_json(base + "/v1/completions",
                             {"prompt": texts[i], "max_tokens": 32,
                              "temperature": 0.0}))) for i in range(8)]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            httpd.shutdown()
            seng.stop()
            httpd.server_close()
            th.join(timeout=30)
        if not all(r is not None and r[0] == 200 for r in res):
            raise AssertionError(f"served_head: a request failed: {res}")
        return wall

    for name, run, kw in (("batch_engine", batch, dict(spec=None)),
                          ("serve_http", serve, dict(spec="ngram"))):
        engs = {h: BatchEngine(p, cfg, tok, n_slots=8, max_seq=2048,
                               chunk_size=8, **kw)
                for h, p in heads.items()}
        got = {h: [] for h in heads}
        for h in heads:
            run(engs[h])  # the captures
        for h in ("bf16", "fp16", "fp16", "bf16"):
            got[h].append(run(engs[h]))
        metric = "tok_per_s" if name == "batch_engine" else "wall_s"
        print(json.dumps({
            "e2e": f"served_head_{name}", "model": "llama2-7b", "slots": 8,
            **{f"{metric}_{h}": got[h] for h in heads},
            **{f"pool_bytes_{h}": graph_summary(engs[h])["pool_bytes"]
               for h in heads},
            **{f"graphs_{h}": graph_summary(engs[h])["graphs"]
               for h in heads},
            "why": "serve.main keeps the checkpoint's fp16 head at --tp 1 "
                   "(the JAX server's choice); an fp16 head takes the plain "
                   "f32 product"}), flush=True)
        del engs


TP_RANKS = 2
TP_STEPS = 16  # the TP engines' greedy steps (32 before the depth cuts)


def tp_phase(torch, rows, launches):
    """Tensor parallelism at 7B on one card (see the module docstring,
    phase 11): spawn the ranks, which run tp_rank, and take rank 0's
    kernel rows and launch counts."""
    import torch.multiprocessing as mp

    t0 = time.time()
    torch.cuda.empty_cache()  # the ranks share this process's card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    out = os.path.join(tmp, "rank0.json")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=tp_rank,
                         args=(r, f"file://{tmp}/init", out))
             for r in range(TP_RANKS)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * TP_RANKS:
        raise AssertionError(f"tp: the ranks exited with {codes}")
    with open(out) as f:
        res = json.load(f)
    rows.extend(res["rows"])
    launches.update(res["launches"])
    print(json.dumps({"phase": "tp", "ranks": TP_RANKS,
                      "seconds": time.time() - t0}), flush=True)


def tp_rank(rank: int, init: str, out: str) -> None:
    """One rank of phase 11 (a spawned process on cuda:0): rank 0 prints,
    rank 1's output goes nowhere."""
    import datetime

    import torch
    import torch.distributed as dist

    from llama_cu_awq_torch.config import LLAMA2_7B
    from llama_cu_awq_torch.models import synthetic_params
    from llama_cu_awq_torch.parallel import init_multihost, make_mesh
    from llama_cu_awq_torch.parallel.tp import shard_params

    if rank:
        sys.stdout = open(os.devnull, "w")  # noqa: SIM115 (the process's)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    init_multihost(init, TP_RANKS, rank, backend="gloo",
                   timeout=datetime.timedelta(seconds=600))
    try:
        tp = make_mesh(tp=TP_RANKS, dp=1, device="cuda:0").tp_group
        cfg = LLAMA2_7B
        # every rank makes the same full weights from seed 0 and keeps
        # its shard; rank 0 keeps the full ones for the references
        full = synthetic_params(cfg, seed=0)
        params = shard_params(full, cfg, TP_RANKS, rank)
        if rank:
            full = None
        torch.cuda.synchronize()
        res = {"rows": [], "launches": {}}
        if rank == 0:
            tp_kernel_rows(torch, Timer(torch), res["rows"])
        dist.barrier(group=tp.group)
        tp_forward_checks(torch, cfg, full, params, tp)
        tp_engine_runs(torch, cfg, full, params, tp, res["launches"])
        tp_batch_run(torch, cfg, full, params, tp, res["launches"])
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


TP_INT4_MS = ((1, "", "tp2_engine"), (128, "gemm_", "tp2_perplexity"))


def tp_int4_rows(torch, timer, rows, g, ms=TP_INT4_MS):
    """The four w4 projections at tp=2's per-shard shapes of 7B: qkv and
    gate_up with the rmsnorm prologue, o and down (SwiGLU prologue) as
    the f32 partials with no epilogue that the ranks sum; by default m=1
    (a decode step) and m=128 (a block). ms: (m, tag prefix, path)."""
    from llama_cu_awq_torch.ops.cuda.int4_matmul import int4_matmul_fused
    from llama_cu_awq_torch.quant.qtensor import QTensor

    dim, hid, n = 4096, 11008, TP_RANKS
    cases = [("qkv_prescale", dim, 3 * dim // n, "prescale"),
             ("o_partial", dim // n, dim, "partial"),
             ("gate_up_prescale", dim, 2 * hid // n, "prescale"),
             ("down_silu_partial", hid // n, dim, "silu")]
    for m, prefix, path in ms:
        for tag, n_in, n_out, kind in cases:
            tag = f"tp2_{prefix}{tag}"
            qt = random_qtensor(torch, QTensor, n_in, n_out, g)
            x = torch.randn(m, n_in, device="cuda", generator=g).bfloat16()
            if kind == "prescale":
                ss = torch.rand(m, 1, device="cuda", generator=g) + 0.5
                nw = torch.rand(n_in, device="cuda", generator=g) + 0.5
                kw = dict(prescale=(ss, nw))
                extra = [ss, nw]
            else:
                kw = dict(out_dtype=torch.float32)
                extra = []
                if kind == "silu":
                    kw["silu_u"] = torch.randn(m, n_in, device="cuda",
                                               generator=g).bfloat16()
                    extra.append(kw["silu_u"])
            (out, _), variant = launched_variant(
                lambda: int4_matmul_fused(x, qt, **kw))
            ref, _ = int4_matmul_fused(x, qt, plain=True, **kw)
            torch.cuda.synchronize()
            chk = check_close(f"int4_matmul_fused/{tag}", out, ref,
                              **INT4_TOL)
            b, src = bound_ms(nbytes(qt.qw, qt.scales, qt.zeros, x, out,
                                     *extra), 2 * m * n_in * n_out)
            row = dict(
                name=f"int4_matmul_fused/{tag}", kernel="int4_matmul_fused",
                route="cuda", source=int4_source(variant),
                replaces="llama_cu_awq_tpu/ops/pallas/int4_matmul.py:543",
                variant=variant, path=path, tp=TP_RANKS, **chk,
                ms=timer(lambda: int4_matmul_fused(x, qt, **kw)),
                plain_ms=timer(lambda: int4_matmul_fused(x, qt, plain=True,
                                                         **kw)),
                bound_ms=b, bound_by=src,
                library_ms=timer(int4pack_library(torch, qt, x)))
            if m == 128:
                row["linear_ms"] = linear_yardstick(torch, timer, qt, x)
            rows.append(row)


def tp_head_rows(torch, timer, rows, g, cases):
    """The vocab-sharded lm_head (the rank's 16000 of 32000 rows, bf16)
    through dense_gemv; cases: (tag, m, path)."""
    from llama_cu_awq_torch.ops.cuda.dense_gemv import dense_gemv

    dim, vocab = 4096, 32000 // TP_RANKS
    w = (torch.randn(vocab, dim, device="cuda", generator=g)
         * 0.02).bfloat16()
    for tag, m, path in cases:
        x = torch.randn(m, dim, device="cuda", generator=g).bfloat16()
        out, variant = launched_variant(lambda: dense_gemv(x, w))
        ref = dense_gemv(x, w, plain=True)
        torch.cuda.synchronize()
        chk = check_close(f"dense_gemv/{tag}", out, ref, **GEMV_TOL)
        b, src = bound_ms(nbytes(w, x, out), 2 * m * dim * vocab)
        rows.append(dict(
            name=f"dense_gemv/{tag}", kernel="dense_gemv", route="cuda",
            source="llama_cu_awq_torch/csrc/dense_gemm.cu",
            replaces="llama_cu_awq_tpu/ops/pallas/dense_gemv.py:147",
            variant=variant, path=path, tp=TP_RANKS, **chk,
            ms=timer(lambda: dense_gemv(x, w)),
            plain_ms=timer(lambda: dense_gemv(x, w, plain=True)),
            bound_ms=b, bound_by=src,
            library_ms=timer(lambda: torch.nn.functional.linear(x, w))))


def tp_kernel_rows(torch, timer, rows):
    """Every kernel of the TP path at its per-shard shapes (rank 0 alone
    on the card): the w4 rows, the vocab-sharded head, attention_step and
    prefill_attention over the rank's 16 heads."""
    from llama_cu_awq_torch.ops.cuda.attention_step import (attention_step,
                                                            rope_rows)

    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    tp_int4_rows(torch, timer, rows, g)
    tp_head_rows(torch, timer, rows, g, (("tp2_bf16", 1, "tp2_engine"),
                                         ("tp2_bf16_m128", 128,
                                          "tp2_perplexity")))
    # attention_step over the rank's 16 of 32 heads, window 2048, pos 1500
    S, D, H, pos_v = 2048, 128, 32 // TP_RANKS, 1500
    pos = torch.tensor([pos_v], dtype=torch.int32, device="cuda")
    cos2, sinm = rope_rows(pos, D, 10000.0)
    qkv = torch.randn(1, 3 * H * D, device="cuda", generator=g).bfloat16()
    kc, vc = (torch.randn(1, S, H, D, device="cuda",
                          generator=g).bfloat16() for _ in range(2))
    args = (qkv, kc, vc, pos, cos2, sinm, None, None)
    outs, variant = launched_variant(lambda: attention_step(*args,
                                                            n_heads=H))
    refs = attention_step(*args, n_heads=H, plain=True)
    torch.cuda.synchronize()
    chk = check_close("attention_step/tp2_mha16_16_bf16", outs[0], refs[0],
                      **ATTN_TOL)
    for i in (1, 2):
        if not torch.equal(outs[i], refs[i]):
            raise AssertionError("attention_step/tp2: the new cache row "
                                 "differs from the plain version's")
    b, src = bound_ms(pos_v * H * D * 2 * 2 + nbytes(qkv, cos2, sinm,
                                                     *outs),
                      4 * (pos_v + 1) * H * D)
    rows.append(dict(
        name="attention_step/tp2_mha16_16_bf16", kernel="attention_step",
        route="cuda", source="llama_cu_awq_torch/csrc/attention_step.cu",
        replaces="llama_cu_awq_tpu/ops/pallas/attention_step.py:425",
        variant=variant, path="tp2_engine", tp=TP_RANKS, **chk,
        ms=timer(lambda: attention_step(*args, n_heads=H)),
        plain_ms=timer(lambda: attention_step(*args, n_heads=H, plain=True),
                       iters=5),
        bound_ms=b, bound_by=src,
        library_ms=timer(sdpa_library(torch, qkv[:, :H * D].reshape(1, H, D),
                                      kc[:, :pos_v + 1],
                                      vc[:, :pos_v + 1]))))
    prefill_attention_row(torch, timer, rows, g, "tp2_mha16_16_bf16",
                          "tp2_perplexity", 1, 128, S, D, H, H, 1024, False)
    rows[-1]["tp"] = TP_RANKS


def tp_cache_slice(torch, cache, tp):
    """The rank's kv heads of a whole cache, as copies."""
    from llama_cu_awq_torch.models import KVCache

    n = cache.k[0].shape[2] // tp.size

    def mine(xs):
        return [x[:, :, tp.rank * n:(tp.rank + 1) * n].contiguous()
                for x in xs]

    return KVCache(mine(cache.k), mine(cache.v), mine(cache.k_scale),
                   mine(cache.v_scale))


def logit_tolerance(ref) -> float:
    """forward_check's bar: 2 % of the largest logit (at least 2e-2)."""
    return 2e-2 * max(1.0, float(ref.abs().max()))


def tp_forward_checks(torch, cfg, full, params, tp):
    """The TP forward against the single-device forward on the same
    weights and the same random cache: T=1 at position 1500 (fused_step)
    and a 128-token block at position 1024 (prefill_attention)."""
    from llama_cu_awq_torch.models import forward

    for label, T, pos_v, kw in (
            ("t1_pos1500_fused_step", 1, 1500, dict(attn_impl="fused_step")),
            ("block128_pos1024", 128, 1024, dict(logits_all=True))):
        g = torch.Generator(device="cuda")
        g.manual_seed(21)  # the same cache on every rank
        cache = random_cache(torch, cfg, False, g)
        tok = torch.randint(3, cfg.vocab_size, (1, T), dtype=torch.int32,
                            device="cuda", generator=g)
        pos = torch.tensor([pos_v], dtype=torch.int32, device="cuda")
        got, _ = forward(params, cfg, tok, pos, tp_cache_slice(torch, cache,
                                                              tp),
                         tp=tp, **kw)
        if full is None:
            continue
        want, _ = forward(full, cfg, tok, pos, cache, **kw)
        got = got.float().reshape(-1, cfg.vocab_size)
        want = want.float().reshape(-1, cfg.vocab_size)
        diff = float((got - want).abs().max())
        tol = logit_tolerance(want)
        print(json.dumps({
            "forward_7b": f"tp2_{label}", "rows": got.shape[0],
            "max_abs_logit_diff": diff,
            "max_abs_logit": float(want.abs().max()), "tolerance": tol,
            "argmax_equal_rows": int((got.argmax(-1) ==
                                      want.argmax(-1)).sum()),
            "why": "the ranks' partial sums add in another order and the "
                   "rms scale is taken of the f32 sum before the cast: "
                   "forward_check's 2 % of the largest logit"}), flush=True)
        if not bool(got.isfinite().all()) or diff > tol:
            raise AssertionError(f"tp2 {label}: TP and single-device "
                                 f"logits differ by {diff} > {tol}")
        del cache


def tp_agree(torch, tp, tokens) -> int:
    """The summed max - min of each token over the ranks (0: every rank
    drew the same stream)."""
    import torch.distributed as dist

    t = torch.tensor(tokens, dtype=torch.int64)
    hi, lo = t.clone(), t.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=tp.group)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=tp.group)
    return int((hi - lo).abs().sum())


def tp_replay(torch, cfg, full, label, prompt, stream, attn_impl):
    """Teacher-force the stream through the single-device forward as the
    engine ran it (replay_check's schedule: the prompt's prefill, then
    T=1 steps with the engine's attn_impl): every token within
    logit_tolerance of that step's top logit. Returns the largest gap and
    the tolerance. (On the synthetic weights fused_step and plain
    attention part by whole logits: the activations grow large and the
    two round scores differently, so the replay takes the engine's
    path.)"""
    from llama_cu_awq_torch.engine import InferenceEngine
    from llama_cu_awq_torch.models import forward

    eng = InferenceEngine(full, cfg, None, temperature=0.0, max_seq=2048,
                          attn_impl=attn_impl, capture=False)
    if len(prompt) > 1:
        eng._prefill(prompt[:-1])
    gaps, tols = [], []
    for t_in, t_out in zip([prompt[-1]] + stream[:-1], stream):
        logits, _ = forward(
            full, cfg, torch.tensor([[t_in]], dtype=torch.int32,
                                    device="cuda"), position(torch, eng),
            eng.cache, attn_len=eng._bucket_for(eng.pos + 1),
            attn_impl=eng.attn_impl)
        gaps.append(float(logits[0].max() - logits[0, t_out]))
        tols.append(logit_tolerance(logits))
        eng.pos += 1
    del eng
    worst = max(range(len(gaps)), key=lambda i: gaps[i] - tols[i])
    if gaps[worst] > tols[worst]:
        raise AssertionError(f"tp2 {label}: token {worst} is {gaps[worst]} "
                             f"below the replayed top logit "
                             f"(> {tols[worst]})")
    return max(gaps), min(tols)


def tp_gather(tp, obj) -> list:
    """obj from every rank of the group, in rank order (rank 1's output
    goes nowhere, so rank 0 prints both)."""
    import torch.distributed as dist

    out = [None] * tp.size
    dist.all_gather_object(out, obj, group=tp.group)
    return out


def split_graphs(eng) -> dict:
    """A TP engine's graphs, split at the collectives: how many, the
    segments of each key (kind/T/window), capture seconds and pool bytes
    summed."""
    graphs = eng._graphs.graphs

    def kind(k):
        return k if isinstance(k, str) else "_".join(map(str, k))

    return {"graphs": len(graphs),
            "segments_by_key": {f"{kind(k[0])}/T{k[1]}/w{k[2]}": g.segments
                                for k, g in graphs.items()},
            "capture_s": sum(g.capture_seconds for g in graphs.values()),
            "pool_bytes": sum(g.pool_bytes for g in graphs.values())}


def tp_decode_window(torch, eng, prompt, n=8, sync=False, trace=False):
    """n decode steps after the prompt's prefill: ms a token; graph
    segments replayed, collectives run and kernel launches counted, a
    token; with sync, the collectives timed each between two
    synchronizations (parallel/mesh.py sync_timing), so ms a token splits
    into collective ms and the rest; with trace, the device operations
    and the host's launch calls (kernels, graphs, copies) a token from
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llama_cu_awq_torch.engine.graphs import REPLAYS
    from llama_cu_awq_torch.ops.cuda import LAUNCHES, reset_launches
    from llama_cu_awq_torch.parallel.mesh import (COLLECTIVE_SECONDS,
                                                  COLLECTIVES,
                                                  reset_collectives,
                                                  sync_timing)

    eng.reset()
    eng._prefill(prompt[:-1])
    torch.cuda.synchronize()
    reset_collectives()
    reset_launches()
    r0 = dict(REPLAYS)
    ctx = contextlib.ExitStack()
    if sync:
        ctx.enter_context(sync_timing())
    prof = (ctx.enter_context(profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]))
            if trace else None)
    t0 = time.perf_counter()
    with ctx:
        toks, _ = eng._decode_tokens(
            torch.tensor([prompt[-1]], dtype=torch.int32, device="cuda"), n,
            stop_at_eos=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    res = {"ms_per_token": wall * 1e3 / n,
           "segment_replays_per_token": (REPLAYS["segments"]
                                         - r0["segments"]) / n,
           "collectives_per_token": sum(COLLECTIVES.values()) / n,
           "kernel_launches_per_token": sum(LAUNCHES.values()) / n,
           "tokens": toks}
    if sync:
        coll = sum(COLLECTIVE_SECONDS.values()) * 1e3 / n
        res.update(collective_ms_per_token=coll,
                   rest_ms_per_token=res["ms_per_token"] - coll)
    if trace:
        events = prof.events()
        res["device_ops_per_token"] = sum(
            e.device_type == DeviceType.CUDA for e in events) / n
        res["host_launch_calls_per_token"] = sum(
            e.device_type == DeviceType.CPU and e.name.startswith(
                ("cudaLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync", "cuLaunchKernel"))
            for e in events) / n
    return res


def tp_engine_runs(torch, cfg, full, params, tp, launches):
    """A TP InferenceEngine made with capture=True (its graphs split at
    the collectives) and one made with capture=False, on the same shard:
    TP_STEPS greedy steps after an 8-token prompt, the graph engine once
    untimed (its captures), then each way timed (tok/s; streams, and the
    whole caches after, equal bit for bit on every rank; the
    single-device replay); an 8-step decode window each way, traced
    (device operations, host launch calls) and synchronized (replays,
    collectives and launches a token; ms a token split into collective
    ms and the rest); the perplexity of 255 ids each way (equal bit for
    bit) beside the single-device engine's."""
    from llama_cu_awq_torch.engine import InferenceEngine
    from llama_cu_awq_torch.engine.perplexity import token_perplexity

    prompt = list(range(5, 13))
    steps = TP_STEPS + len(prompt) - 1
    engs = {way: InferenceEngine(params, cfg, None, temperature=0.0,
                                 seed=1234, max_seq=2048,
                                 attn_impl="fused_step", tp=tp,
                                 capture=way == "graph")
            for way in ("graph", "eager")}
    warm = engs["graph"].generate_benchmark(prompt, steps)[0]  # captures
    timed = {}
    for way in ("eager", "graph"):
        name = "tp2_engine" + ("" if way == "graph" else "_eager")
        timed[way] = run_path(
            torch, name, lambda: engs[way].generate_benchmark(prompt, steps),
            launches)
    toks = timed["graph"][0]
    mine = {"streams_equal": warm == toks == timed["eager"][0],
            "caches_equal": caches_equal(torch, engs["graph"],
                                         engs["eager"]),
            "graphs": split_graphs(engs["graph"]), "windows": {}}
    for way, e in engs.items():
        mine["windows"][way] = {
            **tp_decode_window(torch, e, prompt, trace=True),
            **tp_decode_window(torch, e, prompt, sync=True)}
    w = mine["windows"]
    mine["window_tokens_equal"] = w["graph"].pop("tokens") == w[
        "eager"].pop("tokens")
    ids = [1] + [3 + (7919 * i) % 31990 for i in range(254)]
    ppl = run_path(torch, "tp2_perplexity",
                   lambda: token_perplexity(engs["graph"], ids), launches)
    ppl_eager = token_perplexity(engs["eager"], ids)
    mine["perplexity_equal"] = ppl == ppl_eager
    mine["caches_equal_after_perplexity"] = caches_equal(
        torch, engs["graph"], engs["eager"])
    ranks = tp_gather(tp, mine)
    disagree = tp_agree(torch, tp, toks)
    del engs
    equal = all(r[k] for r in ranks for k in (
        "streams_equal", "caches_equal", "window_tokens_equal",
        "perplexity_equal", "caches_equal_after_perplexity"))
    if full is not None:
        single = InferenceEngine(full, cfg, None, temperature=0.0,
                                 max_seq=2048)
        ppl_1 = token_perplexity(single, ids)
        del single
        gap, tol = tp_replay(torch, cfg, full, "engine", prompt, toks,
                             "fused_step")
        d_ln = abs(math.log(ppl) - math.log(ppl_1))
        print(json.dumps({
            "e2e": "tp2_engine", "model": "llama2-7b", "ranks": tp.size,
            "backend": tp.backend, "steps": len(toks),
            "tok_per_s": timed["graph"][2], "seconds": timed["graph"][1],
            "tok_per_s_eager": timed["eager"][2],
            "seconds_eager": timed["eager"][1],
            "captured_equals_eager_bit_for_bit": equal,
            "ranks_disagree": disagree, "replay_max_gap": gap,
            "replay_tolerance": tol,
            "perplexity_tp": ppl, "perplexity_tp_eager": ppl_eager,
            "perplexity_single": ppl_1, "abs_d_ln_ppl": d_ln,
            "first_tokens": toks[:8], "by_rank": ranks,
            "note": "2 ranks sharing one card, gloo through the host: not "
                    "a TP speed"}), flush=True)
    if not equal:
        raise AssertionError(f"tp2 engine: captured and eager differ: "
                             f"{ranks}")
    if disagree or len(toks) != TP_STEPS:
        raise AssertionError(f"tp2 engine: {len(toks)} tokens, ranks "
                             f"disagree by {disagree}")
    if launches["tp2_engine"] != launches["tp2_engine_eager"]:
        raise AssertionError("tp2 engine: graph and eager launch counts "
                             "differ")
    if full is not None and not d_ln <= 0.01:
        raise AssertionError(f"tp2 perplexity: |d ln ppl| = {d_ln}")


def tp_batch_run(torch, cfg, full, params, tp, launches):
    """A TP BatchEngine made with capture=True and one made with
    capture=False: rank 0 serves 4 greedy requests on 4 slots (two
    prompts long enough for block prefill) and rank 1 follows; streams
    and whole caches equal bit for bit on every rank, each stream
    replayed through the single-device forward."""
    from llama_cu_awq_torch.engine import BatchEngine

    prompts = [[1] + [3 + (104729 * (i + 131 * j)) % 31990
                      for i in range(n - 1)]
               for j, n in enumerate((20, 40, 100, 200))]
    engs, outs = {}, {}
    for way in ("graph", "eager"):
        be = engs[way] = BatchEngine(params, cfg, None, n_slots=4,
                                     max_seq=512, chunk_size=8, spec=None,
                                     tp=tp, capture=way == "graph")
        if tp.rank:
            be.follow()
            continue
        try:
            rids = [be.submit(p, max_new=16) for p in prompts]
            name = "tp2_batch" + ("" if way == "graph" else "_eager")
            out = run_path(torch, name, be.run, launches)
            outs[way] = ([out[r] for r in rids], be.stats())
        finally:
            be.stop_followers()
    mine = {"caches_equal": caches_equal(torch, engs["graph"],
                                         engs["eager"]),
            "graphs": split_graphs(engs["graph"])}
    ranks = tp_gather(tp, mine)
    del engs
    if tp.rank:
        if not all(r["caches_equal"] for r in ranks):
            raise AssertionError("tp2 batch: captured and eager differ")
        return
    streams, st = outs["graph"]
    equal = (streams == outs["eager"][0]
             and all(r["caches_equal"] for r in ranks))
    gaps = [tp_replay(torch, cfg, full, f"batch request {i}", p, streams[i],
                      "auto")[0]
            for i, p in enumerate(prompts)]
    print(json.dumps({
        "e2e": "tp2_batch_engine", "model": "llama2-7b", "ranks": tp.size,
        "slots": 4, "requests": 4, "max_new": 16,
        "tok_per_s": st["tok_per_s"],
        "tok_per_s_eager": outs["eager"][1]["tok_per_s"],
        "finished": st["finished"],
        "captured_equals_eager_bit_for_bit": equal,
        "replay_max_gap": max(gaps), "by_rank": ranks,
        "note": "the graph run includes its captures; 2 ranks sharing one "
                "card, gloo through the host: not a TP speed"}), flush=True)
    if not equal:
        raise AssertionError("tp2 batch: captured and eager differ")
    if launches["tp2_batch"] != launches["tp2_batch_eager"]:
        raise AssertionError("tp2 batch: graph and eager launch counts "
                             "differ")
    if st["finished"] != 4 or not all(streams):
        raise AssertionError(f"tp2 batch: {st}")


# ---------------------------------------------------------------------------
# phase 12: serve --dp 2 --tp 2, and the ppl matrix tool, on one card

DP_TP = (2, 2)  # serve --dp 2 --tp 2: 3 processes, rank 0 the server


def synthetic_checkpoint(torch, params, cfg):
    """The RawCheckpoint of models.llama.synthetic_params' weights, to
    write with save_checkpoint: each fused projection cut back into the
    file's tensors (wqkv into wq, wk, wv; w_gate_up into w_gate, w_up),
    the bf16 embed and head in the file's fp16."""
    import numpy as np

    from llama_cu_awq_torch.io.checkpoint import (RawCheckpoint, RawLayer,
                                                  RawQWeight)

    def raw(qt, a, b):
        return RawQWeight(qt.qw[a:b].cpu().numpy().view(np.uint32).T,
                          qt.zeros[a:b].cpu().numpy().T.astype(np.int8),
                          qt.scales[a:b].float().cpu().numpy().T,
                          qt.n_in, b - a)

    def f16(t):
        return t.to(torch.float16).cpu().numpy()

    dim, kv, hid = cfg.dim, cfg.kv_dim, cfg.hidden_dim
    layers = [RawLayer(
        wq=raw(l.wqkv, 0, dim), wk=raw(l.wqkv, dim, dim + kv),
        wv=raw(l.wqkv, dim + kv, dim + 2 * kv), wo=raw(l.wo, 0, dim),
        w_gate=raw(l.w_gate_up, 0, hid), w_up=raw(l.w_gate_up, hid, 2 * hid),
        w_down=raw(l.w_down, 0, dim), attn_norm=f16(l.attn_norm),
        ffn_norm=f16(l.ffn_norm)) for l in params.layers]
    return RawCheckpoint(cfg, f16(params.embed), f16(params.lm_head),
                         f16(params.final_norm), layers)


def params_of_file(torch, params, ckpt, dtype):
    """What params_from_checkpoint(ckpt, param_dtype=dtype) builds from
    the .bin written from params (synthetic_checkpoint), made from params
    without the 7B load: the embed and head through the file's fp16; held
    to params_from_checkpoint's own on the dense tensors and layer 0."""
    import dataclasses

    from llama_cu_awq_torch.models import params_from_checkpoint

    def dense(t):
        h = t.half()
        return h if dtype is None else h.to(dtype)

    out = dataclasses.replace(params, embed=dense(params.embed),
                              lm_head=dense(params.lm_head))
    one = params_from_checkpoint(dataclasses.replace(
        ckpt, layers=ckpt.layers[:1]), param_dtype=dtype)
    pairs = [(out.embed, one.embed), (out.lm_head, one.lm_head),
             (out.final_norm, one.final_norm)]
    a, b = out.layers[0], one.layers[0]
    pairs += [(a.attn_norm, b.attn_norm), (a.ffn_norm, b.ffn_norm)]
    for qa, qb in ((a.wqkv, b.wqkv), (a.wo, b.wo), (a.w_gate_up, b.w_gate_up),
                   (a.w_down, b.w_down)):
        pairs += [(qa.qw, qb.qw), (qa.scales, qb.scales),
                  (qa.zeros, qb.zeros)]
    if not all(x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs):
        raise AssertionError("the .bin's weights differ from the "
                             "synthetic ones")
    return out


def dp_tp_serve(torch, cfg, path, tok_path, ckpt, full, launches):
    """`serve --dp 2 --tp 2` through serve.run_replicas, with every rank
    on cuda:0 over gloo (see the module docstring, phase 12): 8
    concurrent completions, 4 streamed, queued before the engine threads
    start; each stream replayed through the single-device forward."""
    import datetime

    from llama_cu_awq_torch.serve import (build_argparser, make_server,
                                          run_replicas)
    from llama_cu_awq_torch.tokenizer import Tokenizer

    dp, tp = DP_TP
    args = build_argparser().parse_args(
        [path, "-z", tok_path, "--dp", str(dp), "--tp", str(tp), "--slots",
         "2", "--max-seq", "512", "-t", "0", "-s", "1"])
    tok = Tokenizer(tok_path, cfg.vocab_size)
    lengths = (20, 45, 70, 95, 120, 145, 170, 200)
    prompts = [[1] + [3 + (104729 * (i + 131 * j)) % 31990
                      for i in range(n - 1)]
               for j, n in enumerate(lengths)]
    res = {}

    def body(engines):
        httpd, seng = make_server(engines, tok, host="127.0.0.1", port=0)
        # each request's id and the token ids it was routed, read on the
        # engine threads (a streamed reply carries text alone)
        ids, rid_of = {}, {}
        route, submit = seng._route, seng.submit

        def recording(r, results):
            for lrid, new, _ in results:
                ids.setdefault((r.idx, lrid), []).extend(new)
            route(r, results)

        def submitting(prompt, **kw):
            rid, q = submit(prompt, **kw)
            rid_of[tuple(prompt)] = rid
            return rid, q

        seng._route, seng.submit = recording, submitting
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        replies = {}

        def client(i):
            replies[i] = http_json(base + "/v1/completions",
                                   {"prompt": prompts[i], "max_tokens": 16,
                                    "temperature": 0.0},
                                   stream=i % 2 == 1)

        def run():
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            deadline = time.perf_counter() + 120
            while seng.stats()["queued_requests"] < len(prompts):
                if time.perf_counter() > deadline:
                    raise AssertionError("dp2_tp2: requests not queued")
                time.sleep(0.005)
            t0 = time.perf_counter()
            seng.start()
            for t in threads:
                t.join(timeout=600)
            return time.perf_counter() - t0

        try:
            res["wall"] = run_path(torch, "dp2_tp2_serve", run, launches)
            res["stats"] = http_json(base + "/stats")[1]
        finally:
            httpd.shutdown()
            seng.stop()
            httpd.server_close()
            server.join(timeout=30)
        res["replies"] = replies
        res["ids"] = {i: ids.get(rid_of.get(tuple(p)), [])
                      for i, p in enumerate(prompts)}
        return 0

    t0 = time.time()
    rc = run_replicas(args, ckpt, tok, body, devices=["cuda:0"] * (dp * tp),
                      backend="gloo",
                      timeout=datetime.timedelta(seconds=600))
    seconds = time.time() - t0
    replies, stats = res["replies"], res["stats"]
    # each reply against the ids its request was routed: token_ids for a
    # blocking one, the text of those ids for a streamed one
    streams = res["ids"]
    for i, p in enumerate(prompts):
        r = replies.get(i)
        if r is None or r[0] != 200:
            raise AssertionError(f"dp2_tp2: request {i} failed: {r}")
        same = (tok_text(tok, p, streams[i]) == r[1] and r[2] == "stop"
                if i % 2 else
                r[1]["choices"][0]["token_ids"] == streams[i])
        if not same or len(streams[i]) != 16:
            raise AssertionError(f"dp2_tp2: request {i}'s reply is not "
                                 f"the 16 tokens it was routed: {r}")
    served = [p["requests"] for p in stats["replicas"]]
    gaps = [tp_replay(torch, cfg, full, f"dp2_tp2 request {i}", prompts[i],
                      streams[i], "auto")[0] for i in range(len(prompts))]
    torch.cuda.empty_cache()
    print(json.dumps({
        "e2e": "dp2_tp2_serve_http", "model": "llama2-7b", "dp": dp,
        "tp": tp, "processes": 1 + dp * (tp - 1), "backend": "gloo",
        "slots_per_replica": 2, "max_seq": 512, "spec": "ngram",
        "requests": len(prompts), "streamed": len(prompts) // 2,
        "max_new": 16, "prompt_lengths": list(lengths),
        "finished": len(streams), "wall_s": res["wall"],
        "seconds_with_startup": seconds, "served_per_replica": served,
        "server_stats": stats, "exit_code_of_every_rank": rc,
        "replay_max_gap": max(gaps),
        "replay_tolerance": "2 % of the replayed top logit",
        "kernels_launched": launches["dp2_tp2_serve"]["kernels"],
        "note": "3 processes sharing one card over gloo: not a speed"}),
        flush=True)
    if rc != 0 or min(served) < 2 or stats["requests"] != len(prompts):
        raise AssertionError(f"dp2_tp2: rc {rc}, served {served}")


def tok_text(tok, prompt, ids):
    """The text the server streams for ids after prompt (its pieces)."""
    prev, out = prompt[-1], []
    for t in ids:
        out.append(tok.safe_piece(tok.decode(prev, t)))
        prev = t
    return "".join(out)


# the fused_step rows against the plain-attention row of their cache
PPL_PAIRS = (("bf16 KV, einsum", "bf16 KV, fused_step"),
             ("int8 KV, einsum", "int8 KV, fused_step"),
             ("int4 KV, einsum", "int4 KV, fused_step"))


def ppl_text(tmp):
    """The ppl matrix's text: 2 sequences of 128 letters and spaces from
    seed 0 (one token a byte under the byte tokenizer), joined by
    <|endoftext|>; (the sequences, the file's path)."""
    import numpy as np

    rng = np.random.default_rng(0)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", np.uint8)
    seqs = [bytes(rng.choice(letters, 128)).decode() for _ in range(2)]
    path = os.path.join(tmp, "valid.txt")
    with open(path, "w") as f:
        f.write("<|endoftext|>".join(seqs))
    return seqs, path


def ppl_tool(path, tok_path, text_path, out):
    """`python -m llama_cu_awq_torch.tools.ppl_matrix` as a user runs it,
    on the bf16 rows (`--only` splits on commas: "bf16 KV" takes both),
    started in the background: it runs beside the served run."""
    return subprocess.Popen(
        [sys.executable, "-m", "llama_cu_awq_torch.tools.ppl_matrix", path,
         "-z", tok_path, "-q", text_path, "--only", "bf16 KV", "--json",
         out], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def ppl_matrix_run(torch, tok_path, base, seqs, tool, out, launches):
    """tools/ppl_matrix's 8 rows in this process through the tool's own
    functions, each under the launch counters; then the tool's own run
    (ppl_tool), whose rows must equal these (see the module docstring,
    phase 12)."""
    from llama_cu_awq_torch.config import LLAMA2_7B as cfg
    from llama_cu_awq_torch.tokenizer import Tokenizer
    from llama_cu_awq_torch.tools import ppl_matrix as pm

    t0 = time.time()
    tok = Tokenizer(tok_path, cfg.vocab_size)
    text = "<|endoftext|>".join(seqs)
    rows, secs, used = [], {}, {}
    for label, kw, bits in pm.MATRIX:
        name = "ppl_" + label.replace(" ", "_").replace(",", "")
        t1 = time.time()
        rows.append(run_path(torch, name, lambda: pm.score_row(
            base, cfg, tok, text, 30, label, kw, bits, "cuda"), launches))
        secs[label] = time.time() - t1
        used[label] = launches[name]
        torch.cuda.empty_cache()
    by = {r["config"]: r for r in rows}
    d_ln = {f: abs(math.log(by[f]["geomean_ppl"])
                   - math.log(by[e]["geomean_ppl"])) for e, f in PPL_PAIRS}
    _, err = tool.communicate(timeout=600)
    if tool.returncode != 0:
        raise AssertionError(f"ppl_matrix tool: {err[-2000:]}")
    with open(out) as f:
        tool_json = json.load(f)

    def variants(label, prefix):
        return sum(n for k, n in used[label]["variants"].items()
                   if k.startswith(prefix))

    checks = {
        "attention_step_bf16": variants("bf16 KV, fused_step",
                                        "attention_step/bf16/"),
        "attention_step_int8": variants("int8 KV, fused_step",
                                        "attention_step/int8/"),
        "attention_step_kv4_int4": variants("int4 KV, fused_step",
                                            "attention_step_kv4/int4/"),
        "dense_gemv_int8": variants("int8 lm_head", "dense_gemv/int8/"),
        "int4_matmul_w4_head": variants("w4-g128 lm_head", "int4_matmul/"),
        "int4_matmul_fused": variants("bf16 KV, einsum",
                                      "int4_matmul_fused/"),
        # the checkpoint's fp16 head takes the plain f32 product
        "dense_gemv_fp16_head_rows": variants("bf16 KV, einsum",
                                              "dense_gemv/"),
    }
    print(json.dumps({
        "e2e": "ppl_matrix_7b", "model": "llama2-7b", "rows": rows,
        "sequences": 2, "tokens_per_sequence": [len(tok.encode(
            s, bos=False, eos=False)) for s in seqs],
        "seconds_per_row": secs, "seconds": time.time() - t0,
        "abs_d_ln_ppl_fused_step_vs_einsum": d_ln,
        "launch_checks": checks, "tool_rows": tool_json["rows"],
        "tool_device": tool_json["device"],
        "head": "the checkpoint's fp16 (the JAX tool's), plain f32 "
                "product; int8 and w4 heads take their kernels"}),
        flush=True)
    if not all(math.isfinite(r["geomean_ppl"]) for r in rows) or \
            len(rows) != 8:
        raise AssertionError(f"ppl_matrix: {rows}")
    if not all(v <= 0.01 for v in d_ln.values()):
        raise AssertionError(f"ppl_matrix: fused_step rows off: {d_ln}")
    if checks["dense_gemv_fp16_head_rows"] or not all(
            v > 0 for k, v in checks.items()
            if k != "dense_gemv_fp16_head_rows"):
        raise AssertionError(f"ppl_matrix: launches {checks}")
    if tool_json["rows"] != [by["bf16 KV, einsum"],
                             by["bf16 KV, fused_step"]]:
        raise AssertionError(f"ppl_matrix tool rows {tool_json['rows']} "
                             f"differ from this process's")


def dp_tp_phase(torch, params):
    """Phase 12 (see the module docstring): the seed-0 weights of phase 4
    written to a 7B .bin, then `serve --dp 2 --tp 2` and the ppl
    matrix on it. Returns the launches of its runs."""
    import shutil

    from llama_cu_awq_torch.config import LLAMA2_7B
    from llama_cu_awq_torch.io.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    from llama_cu_awq_torch.tools.make_test_model import write_byte_tokenizer

    t0 = time.time()
    torch.cuda.empty_cache()  # the ranks share this process's card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dptp_")
    path, tok_path = (os.path.join(tmp, "7b.bin"),
                      os.path.join(tmp, "tok.bin"))
    launches: dict[str, dict] = {}
    tool = None
    try:
        save_checkpoint(path, synthetic_checkpoint(torch, params, LLAMA2_7B))
        write_byte_tokenizer(tok_path, LLAMA2_7B.vocab_size)
        seqs, text_path = ppl_text(tmp)
        tool_out = os.path.join(tmp, "ppl.json")
        tool = ppl_tool(path, tok_path, text_path, tool_out)
        ckpt = load_checkpoint(path)
        t_write = time.time() - t0
        t1 = time.time()
        # the single-device replay's weights: the TP shards' bf16 head
        dp_tp_serve(torch, LLAMA2_7B, path, tok_path, ckpt,
                    params_of_file(torch, params, ckpt, torch.bfloat16),
                    launches)
        t_serve = time.time() - t1
        t1 = time.time()
        # the tool's: the checkpoint's fp16 embed and head (its load())
        ppl_matrix_run(torch, tok_path,
                       params_of_file(torch, params, ckpt, None), seqs, tool,
                       tool_out, launches)
        t_ppl = time.time() - t1
    finally:
        if tool is not None and tool.poll() is None:
            tool.kill()
            tool.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"phase": "dp_tp_tools", "seconds": time.time() - t0,
                      "checkpoint_write_s": t_write, "serve_s": t_serve,
                      "ppl_matrix_s": t_ppl}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 13: the trainer on real text, and the trained model through the
# kernels

TRAIN_STEPS = 150  # the JAX tool's default is 3000: the phase's one cut
CORPUS_MB = 1      # build_corpus --max-mb
PPL_DOCS = 3       # valid.txt's first documents, scored by the CLI
MATRIX_SEQS = 1    # tools.ppl_matrix --seqs; 1 keeps the script in its limit
GEN_TOKENS = 64    # greedy tokens a generate run
PROMPT_CHARS = 400  # the prompt: the head of valid.txt's first document
# a model that learned nothing scores ln 259 nats a token: uniform over the
# ids the byte tokenizer emits (3 specials and 256 bytes)
UNIFORM_NATS = math.log(259)
# a train step on the card against the CPU: the loss's relative error
# against the CPU's f32; each gradient leaf's error norm, against an f64
# step on the CPU, within STEP_F32_MARGIN times the CPU f32 step's own or
# within STEP_REL of the leaf's norm (f32 sums in other orders: a fault,
# or TF32's 10-bit products, reads far past either)
STEP_REL = 1e-4
STEP_F32_MARGIN = 3.0
# |delta ln ppl| of the kernels against their plain versions (phases 5,
# 10-12), and of the w4-g128 model against its float parameters
PPL_KERNEL_BAR = 0.01
W4_FLOAT_BAR = 0.25
# §6's rows, by the kernel a launch counts under
SECTION6_ROW = {"int4_matmul_fused": 1, "int4_matmul": 2, "dense_gemv": 3,
                "attention_step": 4, "attention_step_kv4": 5,
                "prefill_attention": 6, "batched_decode_attention": 7,
                "down_qkv": 8, "ffn_chain": 9, "mono_layer": 10}


def corpus_run(tmp):
    """build_corpus --max-mb CORPUS_MB from this machine's installed
    packages; (the corpus directory, valid.txt's documents)."""
    from llama_cu_awq_torch.tools import build_corpus

    corpus = os.path.join(tmp, "corpus")
    t0 = time.time()
    build_corpus.main(["--out", corpus, "--max-mb", str(CORPUS_MB)])
    seconds = time.time() - t0
    docs = {}
    for split in ("train", "valid"):
        with open(os.path.join(corpus, f"{split}.txt"),
                  encoding="utf-8") as f:
            docs[split] = f.read().split(build_corpus.SEP)
    print(json.dumps({
        "e2e": "build_corpus", "max_mb": CORPUS_MB, "seconds": seconds,
        "packages": [os.path.basename(r)
                     for r in build_corpus.package_roots()],
        **{f"{s}_docs": len(d) for s, d in docs.items()},
        **{f"{s}_mb": sum(len(x.encode()) for x in d) / 1e6
           for s, d in docs.items()}}), flush=True)
    if len(docs["valid"]) < 2:
        raise AssertionError(f"build_corpus: {len(docs['valid'])} valid "
                             f"documents")
    return corpus, docs["valid"]


def train_run(torch, corpus, tok_path, out, launches):
    """train_tiny at its full widths with 4 heads of 128 and TRAIN_STEPS
    steps, gated: every logged loss finite, the last valid loss below the
    first and below UNIFORM_NATS. Returns run()'s record."""
    from llama_cu_awq_torch.tools import train_tiny

    argv = ["--corpus", corpus, "--out", out, "--tokenizer", tok_path,
            "--heads", "4", "--kv-heads", "4", "--steps", str(TRAIN_STEPS)]
    args = train_tiny.build_argparser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rec = run_path(torch, "train_tiny", lambda: train_tiny.run(argv),
                   launches)
    wall = time.time() - t0
    cfg, step_ms = rec["cfg"], rec["step_ms"]
    ms = statistics.median(step_ms[10:])
    tokens = args.batch * args.seq
    # the products of a step: 6 flops a weight a token (forward and both
    # backward products) for every matrix but the embedding, and the
    # scores and their values: 6 * 2 * T * T * dim a sequence a layer
    matrix_params = rec["n_params"] - cfg.vocab_size * cfg.dim - (
        2 * cfg.n_layers + 1) * cfg.dim
    flops = 6 * tokens * matrix_params + 12 * args.batch * cfg.n_layers \
        * args.seq * args.seq * cfg.dim
    log = rec["log"]
    print(json.dumps({
        "e2e": "train_tiny", "device": rec["device"],
        "config": {"dim": cfg.dim, "hidden": cfg.hidden_dim,
                   "layers": cfg.n_layers, "heads": cfg.n_heads,
                   "kv_heads": cfg.n_kv_heads, "vocab": cfg.vocab_size},
        "params": rec["n_params"], "train_tokens": rec["train_tokens"],
        "valid_tokens": rec["valid_tokens"], "steps": TRAIN_STEPS,
        "batch": args.batch, "seq": args.seq, "lr": args.lr,
        "step_ms_median_after_10": ms, "step_ms_min": min(step_ms[10:]),
        "step_ms_max": max(step_ms[10:]), "first_step_ms": step_ms[0],
        "train_tokens_per_s": tokens / (ms / 1e3),
        "model_tflop_per_s": flops / (ms / 1e3) / 1e12,
        "peak_memory_allocated": torch.cuda.max_memory_allocated(),
        "wall_s": wall, "log": log,
        "kernels_launched": launches["train_tiny"]["kernels"]}),
        flush=True)
    losses = [r[k] for r in log for k in ("train_loss", "valid_loss")]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_tiny: non-finite loss in {log}")
    first, last = log[0]["valid_loss"], log[-1]["valid_loss"]
    if not (last < first and last < UNIFORM_NATS):
        raise AssertionError(f"train_tiny: valid loss {first} -> {last} "
                             f"(uniform {UNIFORM_NATS})")
    if any(launches["train_tiny"]["kernels"].values()):
        raise AssertionError("train_tiny launched an inference kernel")
    return rec


def train_step_check(torch, rec, valid_ids):
    """One train step's loss and gradients (and the gradients after the
    global-norm clip) from the trained params on a batch of 4 valid
    sequences, on the card and on the CPU in f32, each held to an f64
    step on the CPU (STEP_REL, STEP_F32_MARGIN)."""
    import numpy as np

    from llama_cu_awq_torch.tools import train_tiny as tt

    cfg = rec["cfg"]
    host = tt.params_to_numpy(rec["params"])
    rng = np.random.default_rng(0)
    span = 257
    starts = rng.integers(0, len(valid_ids) - span, size=4)
    batch = torch.from_numpy(np.stack([valid_ids[s:s + span]
                                       for s in starts]))
    res = {}
    for way, dev, f64 in (("cuda", "cuda", False), ("cpu", "cpu", False),
                          ("cpu_f64", "cpu", True)):
        t0 = time.time()
        params = tt.params_from_numpy(host, dev)
        if f64:
            for leaf in tt.leaves(params):
                leaf.data = leaf.data.double()
        loss, grads = tt.loss_and_grads(params, batch.to(dev), cfg)
        clipped = tt.clip_by_global_norm(grads)
        res[way] = (float(loss), [g.cpu().double() for g in grads],
                    [g.cpu().double() for g in clipped], time.time() - t0)
    names = tt.leaf_names(cfg.n_layers)

    def errors(way, i, ref="cpu_f64"):
        """Each leaf's error norm against ref's, over the leaf's norm."""
        return {n: float((a - b).norm() / b.norm()) for n, a, b in
                zip(names, res[way][i], res[ref][i])}

    bad, worst = [], {}
    for i, what in ((1, "grads"), (2, "clipped")):
        card, cpu = errors("cuda", i), errors("cpu", i)
        bad += [(what, n, card[n], cpu[n]) for n in names
                if card[n] > max(STEP_F32_MARGIN * cpu[n], STEP_REL)]
        n = max(card, key=card.get)
        worst[what] = {"leaf": n, "cuda_rel": card[n], "cpu_rel": cpu[n],
                       "max_cuda_vs_cpu_rel": max(
                           errors("cuda", i, "cpu").values())}
    loss_rel = abs(res["cuda"][0] / res["cpu"][0] - 1)
    print(json.dumps({
        "check": "train_step_cuda_vs_cpu", "batch": [4, span - 1],
        "loss_cuda": res["cuda"][0], "loss_cpu": res["cpu"][0],
        "loss_cpu_f64": res["cpu_f64"][0], "loss_rel": loss_rel,
        "worst_leaf_vs_f64": worst, "outside": bad,
        "tolerance": {"loss_rel": STEP_REL, "leaf": [STEP_F32_MARGIN,
                                                     STEP_REL]},
        "seconds": {w: r[3] for w, r in res.items()},
        "why": "plain f32 on the card and the CPU (no TF32), the same sums "
               "in other orders (the embedding's scatter in the card's), "
               "each against an f64 step"}), flush=True)
    if loss_rel > STEP_REL or bad:
        raise AssertionError(f"train step: loss rel {loss_rel}; leaves "
                             f"outside the bar: {bad}")


def quiet_cli(argv):
    """The CLI's main(argv) in this process; (exit code, its stdout)."""
    import io

    from llama_cu_awq_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def generate_ids(torch, eng, prompt, steps):
    """engine.generate's tokens for prompt ids over `steps` (-n): the
    prompt's prefill, then the decode loop (speculative when the engine's
    spec is on), stopping at EOS. Returns (tokens, hit_eos)."""
    eng.reset()
    n_pref = min(len(prompt), steps)
    if n_pref > 1:
        eng._prefill(prompt[:n_pref - 1])
    token = torch.tensor([prompt[n_pref - 1]], dtype=torch.int32,
                         device="cuda")
    return eng._decode_auto(token, steps - n_pref + 1)


def printed_text(tok, prompt, gen, hit_eos):
    """What generate prints for prompt ids and generated ids: the echoed
    prompt, then every generated piece but the last (all at EOS)."""
    return tok_text(tok, prompt[:1], prompt[1:]) + tok_text(
        tok, prompt, gen if hit_eos else gen[:-1])


def trained_generate(torch, bin_path, tok_path, ckpt, params, prompt_path,
                     launches):
    """64 greedy tokens through the CLI, plain and --spec ngram, each held
    to the same engine's tokens on the same weights; both streams replayed
    through plain T=1 decode (replay_check)."""
    from llama_cu_awq_torch.engine import InferenceEngine
    from llama_cu_awq_torch.tokenizer import Tokenizer

    cfg = ckpt.config
    tok = Tokenizer(tok_path, cfg.vocab_size)
    with open(prompt_path) as f:
        prompt = tok.encode(f.read(), bos=True, eos=False)
    steps = len(prompt) + GEN_TOKENS - 1
    res = {}
    for spec in (None, "ngram"):
        name = "trained_spec" if spec else "trained_generate"
        argv = [bin_path, "-z", tok_path, "-t", "0.0", "-s", "1", "-n",
                str(steps), "-f", prompt_path] + (["--spec", spec]
                                                  if spec else [])
        t0 = time.time()
        rc, out = run_path(torch, name, lambda: quiet_cli(argv), launches)
        wall = time.time() - t0
        eng = InferenceEngine(params, cfg, tok, temperature=0.0, seed=1,
                              spec=spec, max_seq=cfg.seq_len)
        gen, hit = generate_ids(torch, eng, prompt, steps)
        tps = next(float(ln.split()[2].rstrip(".")) for ln in
                   out.splitlines() if ln.startswith("achieved tok/s: "))
        st = dict(eng.spec_stats) if spec else None
        if spec:
            want = (f"spec: {st['verifies']} verifies, {st['accepted']}/"
                    f"{st['proposed']} proposals accepted")
            if want not in out:
                raise AssertionError(f"{name}: the CLI's spec line differs "
                                     f"from {want!r}: {out[-400:]}")
        if rc != 0 or printed_text(tok, prompt, gen, hit) not in out:
            raise AssertionError(f"{name}: rc {rc}; the CLI printed "
                                 f"another stream: {out[-400:]}")
        res[name] = dict(gen=gen, hit_eos=hit, tok_per_s_cli=tps,
                         wall_s=wall, stats=st)
        del eng
    base, spec_gen = res["trained_generate"]["gen"], res["trained_spec"]["gen"]
    st = res["trained_spec"]["stats"]
    print(json.dumps({
        "e2e": "trained_generate", "prompt_tokens": len(prompt),
        "generated": {k: len(v["gen"]) for k, v in res.items()},
        "hit_eos": {k: v["hit_eos"] for k, v in res.items()},
        "tok_per_s_cli": {k: v["tok_per_s_cli"] for k, v in res.items()},
        "cli_wall_s": {k: v["wall_s"] for k, v in res.items()},
        "spec_stats": st, "acceptance_rate": (
            st["accepted"] / st["proposed"] if st["proposed"] else 0.0),
        "spec_equal_to_plain": spec_gen == base,
        "text": tok_text(tok, prompt, base)[:300]}), flush=True)
    if not base or not all(0 <= t < cfg.vocab_size for t in base):
        raise AssertionError(f"trained_generate: bad stream {base}")
    replay_check(torch, params, cfg, prompt, base, base, cfg.seq_len)
    replay_check(torch, params, cfg, prompt, spec_gen, base, cfg.seq_len)
    return st


def geomean_line(out):
    """(sequences, geomean perplexity) from the CLI's perplexity output."""
    line = next(ln for ln in out.splitlines()
                if ln.startswith("Geomean perplexity on "))
    return int(line.split()[3]), float(line.rsplit(" ", 1)[1])


def float_ln_ppl(torch, rec, tok, docs):
    """The float model's ln perplexity of each document through
    train_tiny's forward_loss, with the perplexity harness's protocol:
    BOS first, at most seq_len - 1 scored tokens."""
    from llama_cu_awq_torch.tokenizer import BOS_TOKEN
    from llama_cu_awq_torch.tools.train_tiny import forward_loss

    cfg = rec["cfg"]
    out = []
    with torch.no_grad():
        for d in docs:
            ids = tok.encode(d, bos=False, eos=False)[:cfg.seq_len - 1]
            if ids:
                x = torch.tensor([[BOS_TOKEN] + ids], device="cuda")
                out.append(float(forward_loss(rec["params"], x, cfg)))
    return out


def trained_perplexity(torch, bin_path, tok_path, text_path, docs, rec,
                       cpu_run, launches):
    """The CLI's perplexity of the first PPL_DOCS documents on the card
    (the kernels) against --device cpu (the plain versions, cpu_run, a
    process started beside it), and against the float model's."""
    from llama_cu_awq_torch.tokenizer import Tokenizer

    t0 = time.time()
    rc, out = run_path(torch, "trained_perplexity", lambda: quiet_cli(
        [bin_path, "-z", tok_path, "-m", "perplexity", "-q", text_path,
         "-s", "1"]), launches)
    card_s = time.time() - t0
    out_cpu, err_cpu = cpu_run.communicate(timeout=600)
    if rc != 0 or cpu_run.returncode != 0:
        raise AssertionError(f"perplexity: rc {rc} / "
                             f"{cpu_run.returncode}: {err_cpu[-2000:]}")
    n, geo = geomean_line(out)
    n_cpu, geo_cpu = geomean_line(out_cpu)
    tok = Tokenizer(tok_path, rec["cfg"].vocab_size)
    flt = float_ln_ppl(torch, rec, tok, docs)
    ln_float = sum(flt) / len(flt)
    d_kernel = abs(math.log(geo) - math.log(geo_cpu))
    d_float = abs(math.log(geo) - ln_float)
    print(json.dumps({
        "e2e": "trained_perplexity", "documents": len(docs),
        "sequences": n, "sequences_cpu": n_cpu,
        "tokens": [len(tok.encode(d, bos=False, eos=False)) for d in docs],
        "geomean_ppl_kernels": geo, "geomean_ppl_plain_cpu": geo_cpu,
        "ln_ppl_kernels": math.log(geo), "ln_ppl_float": ln_float,
        "ln_ppl_float_per_doc": flt,
        "abs_d_ln_ppl_kernels_vs_plain": d_kernel,
        "abs_d_ln_ppl_w4_vs_float": d_float,
        "tolerances": [PPL_KERNEL_BAR, W4_FLOAT_BAR], "card_s": card_s,
        "kernels_launched": launches["trained_perplexity"]["kernels"]}),
        flush=True)
    if n != len(flt) or n_cpu != n:
        raise AssertionError(f"perplexity: {n} / {n_cpu} / {len(flt)} "
                             f"sequences")
    if not (d_kernel <= PPL_KERNEL_BAR and d_float <= W4_FLOAT_BAR):
        raise AssertionError(f"perplexity: |d ln ppl| {d_kernel} against "
                             f"plain, {d_float} against float")


def trained_ppl_matrix(torch, bin_path, tok_path, text_path, launches):
    """tools.ppl_matrix --seqs MATRIX_SEQS on the trained model through the
    tool's own functions, each row under the launch counters: every row
    finite, each fused_step row within PPL_KERNEL_BAR of its cache's
    einsum row and launching attention_step (head_dim 128)."""
    from llama_cu_awq_torch.tools import ppl_matrix as pm

    t0 = time.time()
    base, cfg, tok = pm.load(bin_path, tok_path, "cuda")
    with open(text_path) as f:
        text = f.read()
    seqs = min(MATRIX_SEQS, len(text.split("<|endoftext|>")))
    rows, secs = [], {}
    for label, kw, bits in pm.MATRIX:
        name = "trained_ppl_" + label.replace(" ", "_").replace(",", "")
        t1 = time.time()
        rows.append(run_path(torch, name, lambda: pm.score_row(
            base, cfg, tok, text, MATRIX_SEQS, label, kw, bits, "cuda"),
            launches))
        secs[label] = time.time() - t1
        torch.cuda.empty_cache()
    by = {r["config"]: r for r in rows}
    d_ln = {f: abs(math.log(by[f]["geomean_ppl"])
                   - math.log(by[e]["geomean_ppl"])) for e, f in PPL_PAIRS}
    fused = {f: launches["trained_ppl_" + f.replace(" ", "_").replace(
        ",", "")]["kernels"][k] for f, k in (
            ("bf16 KV, fused_step", "attention_step"),
            ("int8 KV, fused_step", "attention_step"),
            ("int4 KV, fused_step", "attention_step_kv4"))}
    print(json.dumps({
        "e2e": "trained_ppl_matrix", "sequences": MATRIX_SEQS,
        "rows": rows, "table": pm.table(rows), "seconds_per_row": secs,
        "seconds": time.time() - t0,
        "abs_d_ln_ppl_fused_step_vs_einsum": d_ln,
        "fused_step_attention_launches": fused}), flush=True)
    if len(rows) != len(pm.MATRIX) or not all(
            math.isfinite(r["geomean_ppl"]) and r["sequences"] == seqs
            for r in rows):
        raise AssertionError(f"trained ppl_matrix: {rows}")
    if not all(v <= PPL_KERNEL_BAR for v in d_ln.values()):
        raise AssertionError(f"trained ppl_matrix: fused_step rows off: "
                             f"{d_ln}")
    if not all(fused.values()):
        raise AssertionError(f"trained ppl_matrix: fused_step rows ran no "
                             f"attention kernel: {fused}")


def trainer_phase(torch):
    """Phase 13 (see the module docstring): build_corpus, train_tiny on the
    card, the step against the CPU, pack_weights, then the trained model
    through the CLI and the ppl matrix. Returns the launches of its
    runs."""
    import shutil

    from llama_cu_awq_torch.io.checkpoint import load_checkpoint
    from llama_cu_awq_torch.models import params_from_checkpoint
    from llama_cu_awq_torch.tokenizer import Tokenizer
    from llama_cu_awq_torch.tools import train_tiny
    from llama_cu_awq_torch.tools.make_test_model import write_byte_tokenizer

    t0 = time.time()
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    launches: dict[str, dict] = {}
    secs = {}
    procs = []

    def python_m(*args, threads=None):
        env = dict(os.environ)
        if threads:
            env["OMP_NUM_THREADS"] = str(threads)
        p = subprocess.Popen([sys.executable, "-m", *args], cwd=repo,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=env)
        procs.append(p)
        return p

    try:
        corpus, valid_docs = corpus_run(tmp)
        secs["corpus"] = time.time() - t0
        tok_path = os.path.join(tmp, "tok.bin")
        write_byte_tokenizer(tok_path, 32000)
        out = os.path.join(tmp, "tiny")
        t1 = time.time()
        rec = train_run(torch, corpus, tok_path, out, launches)
        secs["train"] = time.time() - t1
        bin_path = os.path.join(out, "model.bin")
        pack = python_m("llama_cu_awq_torch.tools.pack_weights",
                        os.path.join(out, "awq", "config.json"),
                        os.path.join(out, "awq"), bin_path, "1")
        t1 = time.time()
        tok = Tokenizer(tok_path, rec["cfg"].vocab_size)
        train_step_check(torch, rec, train_tiny.load_tokens(corpus, "valid",
                                                            tok))
        secs["step_check"] = time.time() - t1
        _, err = pack.communicate(timeout=600)
        if pack.returncode != 0:
            raise AssertionError(f"pack_weights: {err[-2000:]}")
        docs = valid_docs[:PPL_DOCS]
        text_path = os.path.join(tmp, "valid_docs.txt")
        with open(text_path, "w", encoding="utf-8") as f:
            f.write("<|endoftext|>".join(docs))
        prompt_path = os.path.join(tmp, "prompt.txt")
        with open(prompt_path, "w", encoding="utf-8") as f:
            f.write(valid_docs[0][:PROMPT_CHARS])
        # the plain versions' perplexity on the CPU, beside the card runs
        # up to the perplexity's
        cpu_run = python_m("llama_cu_awq_torch", bin_path, "-z", tok_path,
                           "-m", "perplexity", "-q", text_path, "--device",
                           "cpu", "-s", "1", threads=6)
        ckpt = load_checkpoint(bin_path)
        params = params_from_checkpoint(ckpt, device="cuda")
        t1 = time.time()
        trained_generate(torch, bin_path, tok_path, ckpt, params,
                         prompt_path, launches)
        secs["generate"] = time.time() - t1
        t1 = time.time()
        trained_ppl_matrix(torch, bin_path, tok_path, text_path, launches)
        secs["ppl_matrix"] = time.time() - t1
        t1 = time.time()
        trained_perplexity(torch, bin_path, tok_path, text_path, docs, rec,
                           cpu_run, launches)
        secs["perplexity"] = time.time() - t1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    per_row: dict[int, int] = {}
    for run in launches.values():
        for k, n in run["kernels"].items():
            if n:
                per_row[SECTION6_ROW[k]] = per_row.get(SECTION6_ROW[k], 0) + n
    print(json.dumps({"phase": "trainer", "seconds": time.time() - t0,
                      "seconds_by_step": secs,
                      "launches_per_section6_row": dict(sorted(
                          per_row.items())),
                      "runs": sorted(launches)}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 14: the bench, run as a user runs it

BENCH_KEYS = ("metric", "value", "unit", "vs_baseline")
DUAL_KEYS = BENCH_KEYS + ("decode_tok_s_plain", "decode_tok_s_spec",
                          "plain_rebracket", "window_drift",
                          "spec_acceptance", "spec_workload")
DECODE_7B = "decode_tok_s_7b_w4g128_b1"
BENCH_PROFILE = "{profile}"  # the run's trace directory, made by the phase
# (tag, flags, the repository's bench.py's metric names and keys for the
# same flags without its TPU-tuned defaults (tests/test_torch_bench.py
# holds the two benches equal on the CPU; a default decode run's headline
# is its faster leg's name), the kernels its timed legs must launch, the
# workload of this script's own reading beside it)
BENCH_RUNS = (
    ("a_default", ["--repeats", "1"], (DECODE_7B, DECODE_7B + "_spec7"),
     DUAL_KEYS,
     ("int4_matmul_fused", "dense_gemv"), "generate_benchmark"),
    ("b_prefill", ["--mode", "prefill", "--prompt-len", "1920",
                   "--max-seq", "2048"],
     ("prefill_tok_s_7b_w4g128_p1920",), BENCH_KEYS,
     ("int4_matmul_fused", "prefill_attention", "dense_gemv"), "prefill"),
    ("c_batch", ["--mode", "batch", "--steps", "64", "--repeats", "1"],
     ("batch_tok_s_7b_w4g128_s16_r32",), BENCH_KEYS,
     ("int4_matmul_fused", "dense_gemv"), "batch_engine"),
    ("d_admit_long", ["--mode", "batch", "--slots", "8", "--requests", "16",
                      "--admit-long", "1000", "--max-seq", "2048",
                      "--steps", "64", "--repeats", "1"],
     ("batch_tok_s_7b_w4g128_s8_r16_admL1000",), BENCH_KEYS,
     ("int4_matmul_fused", "dense_gemv", "prefill_attention",
      "attention_step"), None),
    ("e_depth", ["--decode-steps", "256", "--prompt-len", "1024",
                 "--max-seq", "2048", "--attn-impl", "fused_step",
                 "--repeats", "3"],
     (DECODE_7B + "_ctx1024",), BENCH_KEYS,
     ("int4_matmul_fused", "dense_gemv", "attention_step",
      "prefill_attention"), None),
    ("f_kv4", ["--kv-bits", "4", "--decode-steps", "32", "--prompt-len",
               "1920", "--max-seq", "2048", "--repeats", "3"],
     (DECODE_7B + "_kv4_ctx1920",), BENCH_KEYS,
     ("int4_matmul_fused", "dense_gemv", "attention_step_kv4"), None),
    ("g_lm_head_int8", ["--lm-head-bits", "8", "--spec", "none",
                        "--repeats", "1"],
     (DECODE_7B + "_lmh8",), BENCH_KEYS, ("int4_matmul_fused", "dense_gemv"),
     None),
    ("h_profile", ["--spec", "none", "--steps", "64", "--repeats", "1",
                   "--profile", BENCH_PROFILE],
     (DECODE_7B,), BENCH_KEYS, ("int4_matmul_fused", "dense_gemv"), None),
    ("i_tp2", ["--tp", "2", "--spec", "none", "--steps", "32", "--repeats",
               "1"],
     (DECODE_7B + "_tp2",), BENCH_KEYS, ("int4_matmul_fused", "dense_gemv"),
     None),
)
BENCH_SCALING_RUNS = (
    ("j_scaling_tiny", ["--config", "tiny", "--tps", "1,2", "--slots", "4",
                        "--requests", "8", "--steps", "16", "--repeats",
                        "1"],
     ["scaling_tok_s_tiny_tp1", "scaling_tok_s_tiny_tp2",
      "scaling_efficiency_tiny_tp2"]),
)


class E2eLines:
    """sys.stdout's stand-in: passes everything on and keeps the "e2e"
    lines this script prints, for phase 14 to print beside the bench's
    readings of the same workloads."""

    def __init__(self, out):
        self.out = out
        self.lines: dict[str, dict] = {}
        self._part = ""

    def write(self, text):
        self._part += text
        while "\n" in self._part:
            line, self._part = self._part.split("\n", 1)
            if line.startswith('{"e2e"'):
                rec = json.loads(line)
                self.lines.setdefault(rec["e2e"], rec)
        return self.out.write(text)

    def __getattr__(self, name):
        return getattr(self.out, name)


def host_processes(module, argvs, timeout):
    """`python -m module argv` for each argv at once, each in a session of
    its own (its spawned ranks are its children), its output to files so
    no pipe fills: (exit code, stdout, stderr) each, and the seconds until
    the last ended. A process that fails stops the wait, and every
    process group still running then is killed; a run that passes
    `timeout` raises."""
    import signal

    t0 = time.time()
    root = os.path.dirname(os.path.abspath(__file__))
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
             for _ in argvs]
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv],
                              cwd=root, stdout=out, stderr=err, text=True,
                              start_new_session=True)
             for argv, (out, err) in zip(argvs, files)]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs):
                break
            if time.time() - t0 > timeout:
                raise AssertionError(f"{module} {argvs}: killed after "
                                     f"{timeout} s")
            time.sleep(0.2)
        secs = time.time() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    outs = []
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        outs.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return outs, secs


def python_m(module, argv, timeout):
    """`python -m module argv` alone (host_processes): (exit code, stdout,
    stderr, seconds)."""
    (res,), secs = host_processes(module, [argv], timeout)
    return (*res, secs)


def bench_earlier(e2e, workload):
    """This script's own reading of a workload the bench runs too."""
    rec = e2e.get(workload)
    if rec is None:
        return None
    keys = {"generate_benchmark": ("tok_per_s", "steps", "max_seq"),
            "prefill": ("time_to_first_token_s", "prefill_tok_per_s",
                        "prompt_tokens"),
            "batch_engine": ("tok_per_s_graph", "slots", "requests",
                             "max_new")}[workload]
    return {"e2e": workload, **{k: rec.get(k) for k in keys}}


def bench_run(tag, flags, names, keys, kernels, workload, e2e, tmp,
              per_row, variants):
    """One bench run (see BENCH_RUNS): its result line's keys and metric,
    the launches of its timed legs, its gates' log lines."""
    argv = [a.replace(BENCH_PROFILE, os.path.join(tmp, tag)) for a in flags]
    rc, out, err, secs = python_m("llama_cu_awq_torch.bench", argv, 900)
    if rc != 0:
        raise AssertionError(f"bench {tag} {argv}: exit {rc}\n{err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    legs = {}
    for ln in err.splitlines():
        if ln.startswith("launches "):
            rec = json.loads(ln[len("launches "):])
            legs[rec["leg"]] = rec
    gates = [ln for ln in err.splitlines()
             if ln.startswith(("spec gate", "batch gate", "[spec] spec "
                               "acceptance", "spec acceptance", "--tp"))]
    launched: dict[str, int] = {}
    by_variant: dict[str, int] = {}
    for rec in legs.values():
        for k, n in rec["kernels"].items():
            launched[k] = launched.get(k, 0) + n
            per_row[SECTION6_ROW[k]] = per_row.get(SECTION6_ROW[k], 0) + n
        for k, n in rec["variants"].items():
            by_variant[k] = by_variant.get(k, 0) + n
        variants[f"{tag}/{rec['leg']}"] = {
            "runs": rec["runs"], "tokens_per_run": rec["tokens_per_run"],
            "variants": rec["variants"]}
    print(json.dumps({
        "bench": tag, "argv": argv, "seconds": secs, "result": res,
        "legs": {leg: {"runs": r["runs"], "tokens_per_run":
                       r["tokens_per_run"], "kernels": r["kernels"],
                       "graph_pool_bytes": r.get("graph_pool_bytes")}
                 for leg, r in legs.items()},
        "gates": gates,
        "earlier_reading": (bench_earlier(e2e, workload) if workload
                            else None)}), flush=True)
    if set(res) != set(keys) or res["metric"] not in names:
        raise AssertionError(f"bench {tag}: keys {sorted(res)} and metric "
                             f"{res['metric']}, the repository's bench.py "
                             f"gives {sorted(keys)} and one of {names}")
    values = [res[k] for k in keys if k in ("value", "decode_tok_s_plain",
                                            "decode_tok_s_spec",
                                            "plain_rebracket")]
    if not all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0
               for v in values):
        raise AssertionError(f"bench {tag}: {res}")
    missing = [k for k in kernels if not launched.get(k)]
    if missing:
        raise AssertionError(f"bench {tag}: its timed legs never launched "
                             f"{missing}: {launched}")
    if tag == "g_lm_head_int8" and not any(
            "int8" in v for rec in legs.values() for v in rec["variants"]
            if v.startswith("dense_gemv/")):
        raise AssertionError("bench g_lm_head_int8: no int8 head launched")
    return {"kernels": launched, "variants": by_variant}


def bench_phase(torch, e2e):
    """Phase 14 (see the module docstring): the bench and its two tools as
    their own processes. Returns each bench run's launches of its timed
    legs, as bench_<tag>."""
    import shutil

    t0 = time.time()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    per_row: dict[int, int] = {}
    variants: dict[str, dict] = {}
    secs = {}
    launches = {}
    try:
        for tag, flags, names, keys, kernels, workload in BENCH_RUNS:
            t1 = time.time()
            launches[f"bench_{tag}"] = bench_run(
                tag, flags, names, keys, kernels, workload, e2e, tmp,
                per_row, variants)
            secs[tag] = time.time() - t1
        rc, out, err, s = python_m(
            "llama_cu_awq_torch.tools.trace_summary",
            [os.path.join(tmp, "h_profile"), "--families", "--top", "12"],
            300)
        secs["h_trace_summary"] = s
        print(json.dumps({"bench": "h_trace_summary", "seconds": s,
                          "summary": out.splitlines()[:40]}), flush=True)
        if rc != 0 or not out.startswith("device busy:"):
            raise AssertionError(f"trace_summary: exit {rc}\n{out[-2000:]}"
                                 f"\n{err[-2000:]}")
        for tag, argv, metrics in BENCH_SCALING_RUNS:
            rc, out, err, s = python_m(
                "llama_cu_awq_torch.tools.bench_scaling", argv, 900)
            secs[tag] = s
            lines = [json.loads(ln) for ln in out.splitlines()
                     if ln.startswith("{")]
            print(json.dumps({"bench": tag, "argv": argv, "seconds": s,
                              "lines": lines}), flush=True)
            if rc != 0 or [ln["metric"] for ln in lines] != metrics:
                raise AssertionError(f"bench_scaling {argv}: exit {rc}, "
                                     f"{lines}\n{err[-3000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"phase": "bench", "seconds": time.time() - t0,
                      "seconds_by_run": secs,
                      "launches_per_section6_row": dict(sorted(
                          per_row.items())),
                      "variants_by_leg": variants}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 15: data-parallel x tensor-parallel across processes

MULTIHOST = (2, 2)  # host processes, ranks a host: dp 2 x tp 2, 4 ranks
MULTIHOST_BATCH = 4
MULTIHOST_STEPS = 8
MULTIHOST_PATH = "multihost_dp2_tp2"
MULTIHOST_NOTE = ("4 ranks sharing one card, gloo through the host: not a "
                  "dp or TP speed")
# tools/bench_scaling --nprocs 2 --tps 1,2 at 7B: 2 slots and 2 requests
# (both replayed by the batch gate) of 8 steps, chunks of 4
MULTIHOST_SCALING = ["--config", "7b", "--tps", "1,2", "--slots", "2",
                     "--requests", "2", "--steps", "8", "--chunk-size", "4",
                     "--repeats", "1"]


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def multihost_reference(torch, params, cfg):
    """The single-device forward on the worker's weights (phase 4's seed-0
    params, of which the ranks hold shards) and inputs: the global logits
    (steps, B, V) on the card."""
    from llama_cu_awq_torch.models import forward, init_kv_cache
    from llama_cu_awq_torch.tools.multihost_worker import (WINDOW,
                                                           build_model_inputs)

    toks = torch.from_numpy(build_model_inputs(MULTIHOST_STEPS,
                                               MULTIHOST_BATCH)).cuda()
    cache = init_kv_cache(cfg, MULTIHOST_BATCH, WINDOW)
    out = []
    for i in range(MULTIHOST_STEPS):
        logits, cache = forward(
            params, cfg, toks[i][:, None],
            torch.full((MULTIHOST_BATCH,), i, dtype=torch.int32,
                       device="cuda"), cache, attn_len=WINDOW)
        out.append(logits.float())
    return torch.stack(out)


def multihost_worker_run(torch, params, cfg, tmp, launches):
    """(a) tools/multihost_worker at 7B as 2 host processes of 2 ranks on
    cuda:0 over gloo, held to the single-device forward; the e2e line.
    Returns the seconds the processes took."""
    hosts, per_host = MULTIHOST
    port = free_port()
    argvs = [["--role", "worker", "--nprocs", str(hosts), "--pid", str(p),
              "--tp", str(per_host), "--batch", str(MULTIHOST_BATCH),
              "--steps", str(MULTIHOST_STEPS), "--config", "7b",
              "--port", str(port), "--dump", tmp] for p in range(hosts)]
    outs, secs = host_processes("llama_cu_awq_torch.tools.multihost_worker",
                                argvs, 600)
    for rc, out, err in outs:
        if rc != 0 or "MULTIHOST OK" not in out:
            raise AssertionError(f"multihost_worker: exit {rc}\n{out}\n"
                                 f"{err[-3000:]}")
    sums = [float(ln.split()[1]) for _, out, _ in outs
            for ln in out.splitlines() if ln.startswith("CHECKSUM ")]
    ref = multihost_reference(torch, params, cfg)
    tol = logit_tolerance(ref)
    b = MULTIHOST_BATCH // hosts
    by_rank, kernels, variants = {}, {}, {}
    for rank in range(hosts * per_host):
        rec = torch.load(os.path.join(tmp, f"rank{rank}.pt"))
        r = rec["dp_index"]
        want = ref[:, r * b:(r + 1) * b].cpu()
        got = rec["logits"]
        steps_ms = [s * 1e3 for s in rec["step_s"]]
        coll = rec["collectives"]
        by_rank[rank] = {
            "dp_index": r, "tp_rank": rec["tp_rank"],
            "device": rec["device"], "backend": rec["backend"],
            "max_abs_logit_diff": float((got - want).abs().max()),
            "finite": bool(got.isfinite().all()),
            "ms_per_step": statistics.median(steps_ms[1:]),
            "first_step_ms": steps_ms[0],
            "collectives_per_step": {k: n / MULTIHOST_STEPS
                                     for k, n in coll.items()},
            "collective_ms_per_step": {
                k: t * 1e3 / MULTIHOST_STEPS
                for k, t in rec["collective_s"].items()},
            "launches": {k: n for k, n in rec["kernels"].items() if n}}
        for k, n in rec["kernels"].items():
            kernels[k] = kernels.get(k, 0) + n
        for k, n in rec["variants"].items():
            variants[k] = variants.get(k, 0) + n
    launches[MULTIHOST_PATH] = dict(kernels=kernels, variants=variants)
    print(json.dumps({"path": MULTIHOST_PATH, **launches[MULTIHOST_PATH]}),
          flush=True)
    want_sum = float(ref[-1].sum())
    print(json.dumps({
        "e2e": MULTIHOST_PATH, "model": "llama2-7b", "hosts": hosts,
        "ranks_per_host": per_host, "batch": MULTIHOST_BATCH,
        "steps": MULTIHOST_STEPS,
        "ms_per_step": statistics.median(
            v["ms_per_step"] for v in by_rank.values()),
        "checksums": sums, "single_device_checksum": want_sum,
        "max_abs_logit_diff": max(v["max_abs_logit_diff"]
                                  for v in by_rank.values()),
        "max_abs_logit": float(ref.abs().max()), "tolerance": tol,
        "by_rank": by_rank, "processes_s": secs,
        "note": MULTIHOST_NOTE}), flush=True)
    n_layers = cfg.n_layers
    for rank, v in by_rank.items():
        per = v["collectives_per_step"]
        if per != {"all_reduce": 2 * n_layers, "all_gather": 1,
                   "dp_gather": 1}:
            raise AssertionError(f"multihost rank {rank}: collectives a "
                                 f"step {per}")
        missing = [k for k in ("int4_matmul_fused", "dense_gemv")
                   if not v["launches"].get(k)]
        if missing:
            raise AssertionError(f"multihost rank {rank} never launched "
                                 f"{missing}")
        if not v["finite"] or v["max_abs_logit_diff"] > tol:
            raise AssertionError(f"multihost rank {rank}: logits differ "
                                 f"from the single-device forward by "
                                 f"{v['max_abs_logit_diff']} > {tol}")
    if len(sums) != hosts or max(sums) - min(sums) > 1e-3:
        raise AssertionError(f"multihost: the hosts' checksums {sums}")
    return secs


def multihost_scaling_run():
    """(b) tools/bench_scaling --nprocs 2 --tps 1,2 at 7B as 2 processes,
    each its own replica (tp 2: 2 ranks of its own) on cuda:0: both
    processes' lines, each width through the bench's batch gate. Returns
    the seconds the processes took."""
    hosts = MULTIHOST[0]
    config = MULTIHOST_SCALING[MULTIHOST_SCALING.index("--config") + 1]
    coord = f"127.0.0.1:{free_port()}"
    argvs = [MULTIHOST_SCALING + ["--nprocs", str(hosts), "--pid", str(p),
                                  "--coordinator", coord]
             for p in range(hosts)]
    outs, secs = host_processes("llama_cu_awq_torch.tools.bench_scaling",
                                argvs, 600)
    for pid, (rc, out, err) in enumerate(outs):
        lines = [json.loads(ln) for ln in out.splitlines()
                 if ln.startswith("{")]
        gates = [ln for ln in err.splitlines()
                 if ln.startswith(("batch gate", "--tp"))]
        print(json.dumps({"bench": f"multihost_scaling_{config}",
                          "pid": pid,
                          "argv": argvs[pid], "lines": lines,
                          "gates": gates, "seconds": secs}), flush=True)
        want = [f"scaling_tok_s_{config}_tp1_proc{pid}",
                f"scaling_tok_s_{config}_tp2_proc{pid}",
                f"scaling_efficiency_{config}_tp2"]
        if rc != 0 or [ln["metric"] for ln in lines] != want or \
                sum(g.startswith("batch gate") for g in gates) != 2:
            raise AssertionError(f"bench_scaling --nprocs {hosts} pid {pid}:"
                                 f" exit {rc}, {lines}\n{err[-3000:]}")
    return secs


def multihost_phase(torch, timer, rows, params, launches):
    """Phase 15 (see the module docstring): (a) the worker, (b)
    bench_scaling --nprocs 2, then the kernel rows of (a)'s m=2 shapes."""
    import shutil

    from llama_cu_awq_torch.config import LLAMA2_7B

    t0 = time.time()
    torch.cuda.empty_cache()  # the ranks share this process's card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_multihost_")
    try:
        t_worker = multihost_worker_run(torch, params, LLAMA2_7B, tmp,
                                        launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t_scaling = multihost_scaling_run()
    t1 = time.time()
    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    m = MULTIHOST_BATCH // MULTIHOST[0]
    tp_int4_rows(torch, timer, rows, g,
                 ms=((m, f"m{m}_", MULTIHOST_PATH),))
    tp_head_rows(torch, timer, rows, g,
                 ((f"tp2_bf16_m{m}", m, MULTIHOST_PATH),))
    print(json.dumps({"phase": "multihost", "seconds": time.time() - t0,
                      "worker_s": t_worker, "bench_scaling_s": t_scaling,
                      "kernel_rows_s": time.time() - t1}), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from llama_cu_awq_torch.ops.cuda import _build
    except ImportError as e:
        print(f"chip_smoke: the llama_cu_awq_torch package is missing "
              f"({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    e2e = E2eLines(sys.stdout)
    sys.stdout = e2e
    card = card_line()
    print(card, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      **toolkit_versions(),
                      "device": torch.cuda.get_device_name(0),
                      "device_count": torch.cuda.device_count()}),
          flush=True)

    secs = _build.build_all(ptxas_verbose=True)
    for name, log in _build.PTXAS_INFO.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    print(json.dumps({"phase": "build", "seconds": secs}), flush=True)

    from llama_cu_awq_torch.config import LLAMA2_7B

    rows: list[dict] = []
    timer = Timer(torch)
    launches: dict[str, dict] = {}

    def timed(fn, *args):
        """fn(*args), then a line with its wall seconds."""
        t0 = time.time()
        out = fn(*args)
        print(json.dumps({"phase_seconds": fn.__name__,
                          "seconds": time.time() - t0}), flush=True)
        return out

    timed(kernel_phase, torch, timer, rows)
    params = timed(e2e_phase, torch, launches)
    timed(prefill_phase, torch, params, launches)
    timed(graph_phase, torch, params, launches)
    timed(slice3_phase, torch, params, launches)
    timed(slice4_phase, torch, timer, rows, params, launches)
    timed(chain_phase, torch, timer, rows, params, launches)
    timed(act_dtype_phase, torch, timer, rows, params, launches)
    timed(served_head_cost, torch, params, LLAMA2_7B)
    timed(tp_phase, torch, rows, launches)
    launches.update(timed(dp_tp_phase, torch, params))
    launches.update(timed(trainer_phase, torch))
    launches.update(timed(bench_phase, torch, e2e.lines))
    timed(multihost_phase, torch, timer, rows, params, launches)
    # each row's launches of its own variant on the run that carries it;
    # a check-only row (path None) reports what every run launched of its
    # variant, which is none
    for r in rows:
        if r["path"] is None:
            r["launches"] = sum(v["variants"].get(r["variant"], 0)
                                for v in launches.values())
        else:
            r["launches"] = launches[r["path"]]["variants"].get(
                r["variant"], 0)
        r["check_only"] = r["path"] is None
    missing = [r["name"] for r in rows
               if not r["check_only"] and r["launches"] == 0]
    if missing:
        raise AssertionError(f"variants never launched on their run: "
                             f"{missing}")
    for r in rows:
        for k in ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err"):
            v = r[k]
            if v is not None and not math.isfinite(v):
                raise AssertionError(f"{r['name']}: {k} = {v}")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
