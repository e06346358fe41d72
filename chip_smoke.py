#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llama_cu_awq_torch) on one NVIDIA card.

    python3 chip_smoke.py    # needs one card

Phases (any failure raises, so the script exits non-zero; none is caught):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build every kernel from llama_cu_awq_torch/csrc (one nvcc per source,
     all at once) and print the build seconds;
  3. kernels at Llama-2 7B shapes: each kernel and variant against its
     plain PyTorch version on the same inputs on the card, within the
     stated tolerance, timed with CUDA events (median after warm-up, L2
     flushed before every timed launch) beside its bound;
     The prefill kernels (prefill_attention at T=128 over a 2048-row
     window at position 1024; the int4 GEMM at m=128) join them, with
     the GEMV-against-GEMM sweep over m that sets GEMM_MIN_M; decode
     attention (the split kernels) at position 1500 and at B=8 over
     positions 960-1100;
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
     256-token prompt with int8 KV, a profile of one 128-token block, the
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
     stream, replayed step by step through plain decode; and one 7B
     forward step at position 1500 through attention_step_kv4 and through
     batched_decode_attention, kernels against plain versions;
  7. continuous batching and serving: the down_qkv chain kernel at m=1 and
     m=8 against its plain version and bit for bit against the standalone
     GEMV pair it replaces; 32 batch-1 decode steps at the 2048 bucket
     (fused_step, bf16 KV) with LLAMA_TPU_DOWN_QKV=1 and without it, in
     turns (equal streams, 31 chain launches a step); BatchEngine with 8
     slots serving 16 greedy requests with prompts of 20 to 1000 tokens,
     without and with the switch (aggregate tokens/s, latency, launches
     per kernel variant, equal streams, the m=8 chain launched), a
     profile of one 8-step chunk of 8 slots at positions around 1000, a
     check that dispatching a chunk does not synchronize with the one in
     flight, and profiles of run()'s one-chunk lookahead and of a loop of
     synchronous steps over the same 4 chunks, in turns (run() also
     queues a fifth, which it discards: the lookahead's cost at the end
     of a drain), with run()'s host time split into dispatch and fetch;
     the HTTP server (spec="ngram", a toy tokenizer) answering 8
     concurrent completions, 4 of them streamed, two replayed step by step
     through the single-sequence engine (each token within 0.1 of the
     replayed argmax); and one 7B step at B=8 with the chain, kernels
     against plain versions;
  8. the retired chain experiment (tools/experiments/int4_chain.py), from
     llama_cu_awq_torch/experiments: ffn_chain (with the next layer's qkv)
     at m=1 and m=8, and mono_layer at m=1 over bf16 and int8 KV at
     position 1500 and at m=8 over bf16 KV at positions 960-1100, each
     against its plain version and against the launch sequence it
     replaces (composed_ms beside ms): ffn_chain bit for bit; mono_layer's
     new cache rows and scales bit for bit and the rest within chain_tol,
     since its attention walks the window unsplit where attention_step
     splits it; then e2e chain_step_7b: after a 1024-token prompt, 32
     greedy decode steps at the 2048 bucket (a) through
     forward(attn_impl="fused_step"), (b) through attention_step and
     ffn_chain in each layer and (c) through mono_layer in each layer, in
     turns, for bf16 and int8 KV (decode tokens/s, launches per kernel a
     step; (a) and (b) give equal streams, (c)'s is compared and
     printed), with a profile of one step each; and one 7B step at B=8
     through (a), (b) and (c) from the same random cache, (b)'s logits
     bit-equal to (a)'s and (c)'s within 2 % of the largest logit.
The kernel phase also times one PyTorch call that computes each row's
product where there is one (library_ms): F.linear, F.scaled_dot_product_
attention, torch._weight_int4pack_mm; the port never calls them.
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


def sdpa_library(torch, q, k_rows, v_rows, mask=None):
    """F.scaled_dot_product_attention of bf16 q (B, H, D) over the given
    rows (B, rows, Hkv, D), laid out as it wants them outside the timed
    call (GQA through enable_gqa); no RoPE and no row quantize."""
    qh = q.bfloat16()[:, :, None, :].contiguous()
    kh = k_rows.bfloat16().transpose(1, 2).contiguous()
    vh = v_rows.bfloat16().transpose(1, 2).contiguous()
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
    # decode step (m=1, the GEMV) and a prefill block (m=128, the GEMM) ---
    cases = [
        ("qkv_prescale", dim, 3 * dim, "prescale"),
        ("o_residual_ss", dim, dim, "residual"),
        ("gate_up_prescale", dim, 2 * hid, "prescale"),
        ("down_silu_residual_ss", hid, dim, "silu"),
    ]
    for m, prefix, path in ((1, "", "main"), (128, "gemm_", "prefill")):
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
            rows.append(dict(
                name=f"int4_matmul_fused/{tag}", kernel="int4_matmul_fused",
                route="cuda", source=int4_source(variant),
                replaces="llama_cu_awq_tpu/ops/pallas/int4_matmul.py:543",
                variant=variant, path=path, **chk,
                ms=timer(lambda: int4_matmul_fused(x, qt, **kw)),
                plain_ms=timer(lambda: int4_matmul_fused(x, qt, plain=True,
                                                         **kw)),
                bound_ms=b, bound_by=src,
                library_ms=timer(int4pack_library(torch, qt, x))))

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
        rows.append(dict(
            name=f"int4_matmul/{tag}", kernel="int4_matmul", route="cuda",
            source=int4_source(variant),
            replaces="llama_cu_awq_tpu/ops/pallas/int4_matmul.py:281",
            variant=variant, path=path, **chk, ms=timer(lambda: int4_matmul(x, qt)),
            plain_ms=timer(lambda: int4_matmul(x, qt, plain=True)),
            bound_ms=b, bound_by=src, library_ms=timer(lib)))

    # --- dense_gemv: the 7B lm_head, bf16 and int8 rows ---
    w = (randn(vocab, dim, dtype=torch.float32) * 0.02).bfloat16()
    w8 = quantize_dense_int8(w)
    x1, x128 = randn(1, dim), randn(128, dim)
    # bf16_m128: every row of a prefill block (logits_all), in 16 passes
    for tag, x, args, path in (
            ("bf16", x1, (w,), "main"),
            ("int8", x1, (w8.w8, w8.scale), "lm_head_int8"),
            ("bf16_m128", x128, (w,), "prefill")):
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
            source="llama_cu_awq_torch/csrc/dense_gemv.cu",
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
    for r in rows:
        print(json.dumps({"kernel_check": r["name"], "kernel_ms": r["ms"],
                          **{k: r[k] for k in (
                              "max_abs_err", "rtol", "atol", "plain_ms",
                              "library_ms", "bound_ms", "bound_by")}}),
              flush=True)


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
    a 128-token block at position 1024 over a 2048-row cache. The bf16
    rows are also timed against F.scaled_dot_product_attention over the
    window the block sees, with the causal mask (GQA through
    enable_gqa)."""
    from llama_cu_awq_torch.ops.cuda.prefill_attention import (
        prefill_attention)

    B, T, S, D, H, pos_v = 1, 128, 2048, 128, 32, 1024
    pos = torch.tensor([pos_v], dtype=torch.int32, device="cuda")
    horizon = pos_v + T  # keys the block reads
    for n_kv in (32, 8):
        q = torch.randn(B, T, H, D, device="cuda", generator=g).bfloat16()
        for quant in (False, True):
            tag = f"{'mha' if n_kv == H else 'gqa'}{H}_{n_kv}_" + (
                "int8" if quant else "bf16")
            if quant:
                kc, vc = (torch.randint(-127, 128, (B, S, n_kv, D),
                                        dtype=torch.int8, device="cuda",
                                        generator=g) for _ in range(2))
                ks, vs = (torch.rand(B, S, n_kv, device="cuda", generator=g)
                          * 0.02 for _ in range(2))
            else:
                kc, vc = (torch.randn(B, S, n_kv, D, device="cuda",
                                      generator=g).bfloat16()
                          for _ in range(2))
                ks = vs = None
            args = (q, kc, vc, pos, ks, vs)
            out, variant = launched_variant(
                lambda: prefill_attention(*args, attn_len=S))
            ref = prefill_attention(*args, attn_len=S, plain=True)
            torch.cuda.synchronize()
            chk = check_close(f"prefill_attention/{tag}", out, ref,
                              **ATTN_TOL)
            kv_bytes = horizon * n_kv * (D * kc.element_size()
                                         + (4 if quant else 0)) * 2
            causal_keys = T * pos_v + T * (T + 1) // 2
            b, src = bound_ms(kv_bytes + nbytes(q, out),
                              4 * causal_keys * H * D)
            lib = None
            if not quant:
                qh = q.transpose(1, 2).contiguous()
                kh = kc[:, :horizon].transpose(1, 2).contiguous()
                vh = vc[:, :horizon].transpose(1, 2).contiguous()
                s_idx = torch.arange(horizon, device="cuda")
                t_idx = torch.arange(T, device="cuda")
                mask = s_idx[None, :] <= pos_v + t_idx[:, None]
                lib = timer(lambda: torch.nn.functional
                            .scaled_dot_product_attention(
                                qh, kh, vh, attn_mask=mask,
                                enable_gqa=n_kv != H))
            rows.append(dict(
                name=f"prefill_attention/{tag}", kernel="prefill_attention",
                route="cuda",
                source="llama_cu_awq_torch/csrc/prefill_attention.cu",
                replaces="llama_cu_awq_tpu/ops/pallas/prefill_attention.py"
                         ":189",
                variant=variant,
                path=(None if n_kv != H else
                      "prefill_int8kv" if quant else "prefill"), **chk,
                ms=timer(lambda: prefill_attention(*args, attn_len=S)),
                plain_ms=timer(lambda: prefill_attention(
                    *args, attn_len=S, plain=True), iters=5),
                bound_ms=b, bound_by=src, library_ms=lib))


def gemm_crossover(torch, timer, g):
    """The GEMV and the GEMM on 7B's qkv shape at m rows, each launched
    directly (these launches are not counted): the data behind
    GEMM_MIN_M."""
    from llama_cu_awq_torch.ops.cuda.int4_matmul import GEMM_MIN_M, _launch
    from llama_cu_awq_torch.quant.qtensor import QTensor

    qt = random_qtensor(torch, QTensor, 4096, 3 * 4096, g)
    sweep = []
    for m in (1, 2, 4, 8, 12, 16, 24, 32, 64, 128):
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


def profile_run(torch, label, prepare, run, n, per):
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
        "top_device_ops": [{"name": n_[:80], "count": c, "ms": us / 1e3}
                           for n_, (c, us) in top],
        "top_host_ops_self_cpu": [{"name": n_[:60], "count": c,
                                   "ms": us / 1e3}
                                  for n_, (c, us) in top_host]}),
          flush=True)


def profile_decode(torch, eng, prompt, steps=16):
    """One decode chunk of `steps` tokens after the prompt."""

    def prepare():
        eng.reset()
        eng._prefill(prompt[:-1])
        token = torch.tensor([prompt[-1]], dtype=torch.int32, device="cuda")
        coins = eng._coins(steps)
        torch.cuda.synchronize()
        return token, coins

    def run(token, coins):
        eng._decode_chunk(token, coins, eng._bucket_for(eng.pos + steps))

    profile_run(torch, "decode_chunk", prepare, run, steps, "token")


def random_cache(torch, cfg, kv_quant, g, kv_bits=8, batch=1):
    """A 2048-row KV cache of random rows (bf16; int8 codes and scales;
    or with kv_bits=4 random packed bytes and scales) for `batch` slots,
    as a kernels-against-plain check starts from."""
    from llama_cu_awq_torch.models import init_kv_cache

    cache = init_kv_cache(cfg, batch, 2048, quantized=kv_quant,
                          kv_bits=kv_bits)
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
                                      generator=g).bfloat16())
    return cache


def forward_check(torch, params, cfg, label, tok, pos, kv_quant, g,
                  kv_bits=8, **kw):
    """One 7B forward from the same random cache through the kernels and
    through the plain versions: the largest logit difference within 2 %
    of the largest logit, and the same argmax on every row whose plain
    top-2 gap is wider than that."""
    from llama_cu_awq_torch.models import forward, init_kv_cache

    B = tok.shape[0]
    cache = random_cache(torch, cfg, kv_quant, g, kv_bits, batch=B)
    logits = {}
    for plain in (False, True):
        c = init_kv_cache(cfg, B, 2048, quantized=kv_quant, kv_bits=kv_bits)
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
    eng.generate_benchmark(prompt, 16)  # warm-up
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

    cfg = LLAMA2_7B
    prompt = [1] + [3 + (7919 * i) % 31990 for i in range(1919)]

    def engine(**kw):
        return InferenceEngine(params, cfg, None, temperature=0.0,
                               seed=1234, max_seq=2048, **kw)

    eng = engine()
    eng.generate_benchmark(prompt[:256], 256)  # warm-up: 2 blocks, 1 step

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

    def prepare_block():
        eng.reset()
        eng._prefill(prompt[:1024])
        torch.cuda.synchronize()
        return (prompt[1024:1152],)

    profile_run(torch, "prefill_block_pos1024", prepare_block, eng._prefill,
                1, "block")

    # perplexity of a 1023-token sequence: 8 blocks with every row's
    # logits, through the kernels, then with the engine's forward bound
    # to the plain versions on the card
    seq = [3 + (104729 * i) % 31990 for i in range(1023)]
    t0 = time.perf_counter()
    ppl_k = run_path(torch, "perplexity",
                     lambda: token_perplexity(eng, seq), launches)
    dt_k = time.perf_counter() - t0
    kernel_forward = engine_mod.forward
    engine_mod.forward = functools.partial(kernel_forward, plain=True)
    try:
        ppl_p = token_perplexity(eng, seq)
    finally:
        engine_mod.forward = kernel_forward
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
                                      device="cuda"), eng._positions(1),
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
    eng4.generate_benchmark(prompt[:256], 256)  # warm-up: 2 blocks, 1 step

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

    # --- speculative decoding: 256 greedy steps on a repetitive prompt,
    # beside the plain stream, then replayed through plain decode ---
    rep_prompt = [1] + [5 + i % 11 for i in range(32)]
    plain_eng = engine(max_seq=512)
    base, _, tps_plain = plain_eng.generate_benchmark(rep_prompt, 256)
    spec_eng = engine(max_seq=512, spec="ngram")
    spec_eng.generate_benchmark(rep_prompt, 48)  # warm-up
    spec_eng.spec_stats = {k: 0 for k in spec_eng.spec_stats}
    got, dt, tps_spec = run_path(
        torch, "spec", lambda: spec_eng.generate_benchmark(rep_prompt, 256),
        launches)
    st = spec_eng.spec_stats
    print(json.dumps({
        "e2e": "spec_ngram", "model": "llama2-7b", "steps": 256,
        "spec_k": spec_eng.spec_k, "max_seq": 512, "tok_per_s": tps_spec,
        "plain_tok_per_s_same_prompt": tps_plain, "seconds": dt,
        "spec_stats": st, "acceptance_rate": (
            st["accepted"] / st["proposed"] if st["proposed"] else 0.0),
        "tokens_equal_to_plain": got == base, "first_tokens": got[:8]}),
        flush=True)
    if len(got) != 256 - len(rep_prompt) + 1 or not valid(got):
        raise AssertionError(f"spec: bad stream of {len(got)} tokens")
    if st["verifies"] == 0:
        raise AssertionError("spec: no proposal was verified")
    replay_check(torch, params, cfg, rep_prompt, got, base, 512)
    del plain_eng, spec_eng

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
    streamed, then /health and /stats; two blocking requests' token_ids
    replayed step by step through the single-sequence engine."""
    from llama_cu_awq_torch.engine import BatchEngine, InferenceEngine
    from llama_cu_awq_torch.serve import make_server
    from llama_cu_awq_torch.tokenizer import Tokenizer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    tok = Tokenizer(write_toy_tokenizer(os.path.join(tmp, "tok.bin"),
                                        cfg.vocab_size), cfg.vocab_size)
    be = BatchEngine(params, cfg, tok, n_slots=8, max_seq=512, chunk_size=8,
                     spec="ngram")
    httpd, seng = make_server(be, tok, host="127.0.0.1", port=0)
    seng.start()
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    prompts = [("the cat sat on the mat" * (1 + i % 3)) + " a" * i
               for i in range(8)]
    results = {}

    def client(i):
        body = {"prompt": prompts[i], "max_tokens": 32, "temperature": 0.0}
        results[i] = http_json(base + "/v1/completions", body,
                               stream=i % 2 == 1)

    def run():
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        return time.perf_counter() - t0

    try:
        wall = run_path(torch, "serve_http", run, launches)
        health = http_json(base + "/health")
        stats = http_json(base + "/stats")[1]
    finally:
        httpd.shutdown()
        seng.stop()
        httpd.server_close()
        server.join(timeout=30)
    n_tokens = sum(len(r[1]["choices"][0]["token_ids"])
                   for i, r in results.items() if i % 2 == 0)
    done = [i for i, r in results.items() if r[0] == 200 and (
        r[2] == "stop" if i % 2 else
        r[1]["choices"][0]["finish_reason"] == "stop")]
    print(json.dumps({
        "e2e": "serve_http", "model": "llama2-7b", "slots": 8,
        "max_seq": 512, "spec": "ngram", "requests": 8, "streamed": 4,
        "finished": len(done), "wall_s": wall,
        "blocking_tokens": n_tokens, "health": health,
        "server_stats": stats, "spec_stats": be.spec_stats,
        "scheduler": type(be.scheduler).__name__}), flush=True)
    if sorted(done) != list(range(8)) or health != (200, {"status": "ok"}):
        raise AssertionError(f"serve_http: finished {done}, health {health}")
    if stats["requests"] != 8 or stats["active_slots"] != 0:
        raise AssertionError(f"serve_http: stats {stats}")
    del be
    for i in (0, 2):
        ids = tok.encode(prompts[i], bos=True, eos=False)
        stream = results[i][1]["choices"][0]["token_ids"]
        if not stream:
            raise AssertionError(f"serve_http: request {i} got no tokens")
        plain = InferenceEngine(params, cfg, None, temperature=0.0,
                                max_seq=512)
        base_stream = plain.generate_benchmark(
            ids, len(ids) + len(stream) - 1)[0]
        del plain
        replay_check(torch, params, cfg, ids, stream, base_stream, 512)


def profile_batch_chunk(torch, be):
    """Where the time of one serving chunk goes: 8 slots decoding at
    positions around 1000 (the 1024 bucket: fused_step attention), one
    chunk of chunk_size steps at B=8, without and with the chain."""
    deep = [[1] + [3 + (7919 * (i + 977 * j)) % 31990 for i in range(999)]
            for j in range(8)]

    def prepare():
        be.reset()
        for p in deep:
            be.submit(p, max_new=64)
        be.step()  # admission, the prompts' block prefill, a first chunk
        torch.cuda.synchronize()
        return ()

    for on in (False, True):
        with down_qkv_switch(on):
            profile_run(torch, "batch_chunk_b8_pos1000" + (
                "_chain" if on else ""), prepare, be.step,
                be.chunk_size, "step")


def profile_batch_run(torch, be):
    """BatchEngine.run()'s lookahead against a loop of synchronous steps,
    on the same work: 8 slots near position 1000 after their prompts'
    block prefill and a first chunk, then 4 chunks of 8 steps each (run()
    also queues a fifth, which it discards). First the check that a
    dispatch queues its chunk without waiting for the chunk in flight:
    under sync debug mode "error" a stream or device synchronization
    raises. The profiles run in turns (run, steps, steps, run), since the
    host clock drifts between runs; then one run() split into the host's
    time in dispatch and in fetching and routing tokens: a fetch that
    waits about nothing means the host, not the card, bounds the loop."""
    deep = [[1] + [3 + (7919 * (i + 977 * j)) % 31990 for i in range(999)]
            for j in range(8)]
    n_steps = 4 * be.chunk_size

    def prepare():
        be.reset()
        for p in deep:
            be.submit(p, max_new=40)
        be.step()
        torch.cuda.synchronize()
        return ()

    def steps():
        while be.pending:
            be.step()

    prepare()
    first = be._dispatch_chunk()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = be._dispatch_chunk()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    be._process_chunk(first)
    be._process_chunk(second)
    print(json.dumps({"check": "batch_dispatch_queues_without_sync",
                      "ok": True}), flush=True)
    for label, fn in (("batch_run_b8_pos1000", be.run),
                      ("batch_steps_b8_pos1000", steps),
                      ("batch_steps_b8_pos1000_again", steps),
                      ("batch_run_b8_pos1000_again", be.run)):
        profile_run(torch, label, prepare, fn, n_steps, "step")

    spent = {"_dispatch_chunk": 0.0, "_process_chunk": 0.0}

    def timed(name):
        fn = getattr(be, name)

        def wrapped(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                spent[name] += time.perf_counter() - t0
        return wrapped

    prepare()
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
        "host_split": "batch_run_b8_pos1000", "steps": n_steps,
        "wall_ms_per_step": wall / n_steps * 1e3,
        "dispatch_ms_per_step": spent["_dispatch_chunk"] / n_steps * 1e3,
        "fetch_and_route_ms_per_step":
            spent["_process_chunk"] / n_steps * 1e3}), flush=True)


def slice4_phase(torch, timer, rows, params, launches):
    """Continuous batching, serving and the down_qkv chain at 7B (see the
    module docstring, phase 7)."""
    from llama_cu_awq_torch.config import LLAMA2_7B
    from llama_cu_awq_torch.engine import BatchEngine, InferenceEngine

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

    # --- BatchEngine: 16 greedy requests over 8 slots, prompts of 20 to
    # 1000 tokens (forced stream and interleaved block prefill), windows
    # into the 1024 and 2048 buckets, where fused_step and the chain apply
    lengths = [20, 36, 48] + [60 + (1000 - 60) * i // 12 for i in range(13)]
    prompts = [[1] + [3 + (104729 * (i + 131 * j)) % 31990
                      for i in range(n - 1)]
               for j, n in enumerate(lengths)]
    be = BatchEngine(params, cfg, None, n_slots=8, max_seq=2048,
                     chunk_size=8, spec=None)
    for p in prompts[:2]:  # warm-up
        be.submit(p, max_new=8)
    be.run()
    outs = {}
    for on, name in ((False, "batch_engine"), (True, "batch_engine_dq")):
        be.reset()

        def serve_all():
            rids = [be.submit(p, max_new=64) for p in prompts]
            out = be.run()
            return [out[r] for r in rids]

        with down_qkv_switch(on):
            outs[on] = run_path(torch, name, serve_all, launches)
        st = be.stats()
        print(json.dumps({
            "e2e": name, "model": "llama2-7b", "slots": 8, "max_seq": 2048,
            "chunk_size": 8, "requests": len(prompts),
            "prompt_tokens": sum(lengths), "max_new": 64,
            "down_qkv_switch": on, **st,
            "scheduler": type(be.scheduler).__name__,
            "chain_m8_launches": launches[name]["variants"].get(
                chain_variant, 0)}), flush=True)
        if st["finished"] != len(prompts) or not all(outs[on]):
            raise AssertionError(f"{name}: {st}")
    profile_batch_chunk(torch, be)
    profile_batch_run(torch, be)
    del be
    print(json.dumps({"e2e": "batch_engine_streams",
                      "equal_with_and_without_chain":
                          outs[True] == outs[False]}), flush=True)
    if outs[True] != outs[False]:
        raise AssertionError("batch_engine: the chain changed a stream")
    if not launches["batch_engine_dq"]["variants"].get(chain_variant) or \
            launches["batch_engine"]["kernels"]["down_qkv"]:
        raise AssertionError("batch_engine: the m=8 chain never launched "
                             "with the switch, or launched without it")

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


def vs_composed(name, got, want, near=()):
    """The kernel's outputs against the launch sequence it replaces: bit
    for bit, but the outputs numbered in `near` within chain_tol (mono's
    attention stage walks the window unsplit where attention_step splits
    it, so its attention rows and what follows them agree to bf16
    rounding of p; its new cache rows and scales stay bit-equal)."""
    diffs = [float((a.float() - b.float().reshape(a.shape)).abs().max())
             for a, b in zip(got, want) if a is not None]
    exact = [i for i in range(len(got)) if i not in near]
    equal = all(torch_equal(got[i], want[i]) for i in exact)
    for i in near:
        check_close(f"{name}/vs_composed/{i}", got[i],
                    want[i].reshape(got[i].shape), **chain_tol(want[i]))
    print(json.dumps({
        "check": f"{name}/vs_composed", "max_abs_err": max(diffs),
        "max_abs_err_each_output": diffs, "bit_equal": equal,
        "bit_equal_outputs": exact, "within_chain_tol_outputs": list(near),
        "why": "each column sums in the standalone GEMV's order, each rms "
               "scale in rms_scale's, and mono's new cache rows come from "
               "attention_step's phase 1 (attention_step.cuh new_row)"}),
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
            bound, lib, lib_call, replaces):
        rows.append(dict(
            name=name, kernel=kernel, route="cuda",
            source="llama_cu_awq_torch/csrc/int4_chain.cu",
            replaces=replaces, variant=variant, path=path, **chk, ms=ms,
            plain_ms=plain_ms, composed_ms=composed_ms, bound_ms=bound[0],
            bound_by=bound[1], library_ms=lib, library_call=lib_call))
        r = rows[-1]
        print(json.dumps({"kernel_check": r["name"], "kernel_ms": r["ms"],
                          **{k: r[k] for k in (
                              "max_abs_err", "rtol", "atol", "plain_ms",
                              "composed_ms", "library_ms", "bound_ms",
                              "bound_by")}}), flush=True)

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

        want, prods = composed()
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
        # x_out, ss and qkv follow the attention rows; the cache rows and
        # scales (2-5) are bit-equal
        vs_composed(name, got, want, near=(0, 1, 6))
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
            "tools/experiments/int4_chain.py:627")
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

    pos = eng._positions(1)
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
        # (a) and (b) run the same split attention_step and sum alike:
        # equal streams; (c) walks attention unsplit (mono_layer), so its
        # stream is compared and printed, not required equal
        streams = [r[0] for letter in "ab" for r in res[letter]]
        equal = all(s == streams[0] for s in streams)
        c_equal = [r[0] == streams[0] for r in res["c"]]
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
            "launches_per_step": per_step, "streams_equal_a_b": equal,
            "streams_c_equal_a": c_equal,
            "first_tokens": streams[0][:8]}), flush=True)
        if not equal:
            raise AssertionError(f"chain_step_7b_{fmt}: (a) and (b) gave "
                                 f"different streams")
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
    # (c): the 7B forward bar of forward_check, 2 % of the largest logit
    tol = 2e-2 * max(1.0, float(a.abs().max()))
    print(json.dumps({
        "forward_7b": "chain_b8", "rows": 8, "positions": pos8.tolist(),
        "max_abs_logit_diff_vs_a": diffs, "bit_equal_vs_a": equal,
        "max_abs_logit": float(a.abs().max()), "tolerance_c": tol,
        "argmax_c_equal_a_rows": int((logits["c"].argmax(-1)
                                      == a.argmax(-1)).sum()),
        "finite": bool(torch.isfinite(a).all()),
        "why": "(b) sums every column, rms scale and attention row in the "
               "order of (a)'s launches; (c) walks attention unsplit, so "
               "its p rounds against other maxima"}), flush=True)
    if not (equal["b"] and diffs["c"] <= tol
            and bool(torch.isfinite(a).all())
            and bool(torch.isfinite(logits["c"]).all())):
        raise AssertionError(f"forward_7b chain_b8: logits differ from (a): "
                             f"{diffs}")
    lb8 = launches["forward_7b_chain_b8"]["kernels"]
    if lb8["ffn_chain"] != cfg.n_layers or lb8["mono_layer"] != cfg.n_layers:
        raise AssertionError(f"forward_7b chain_b8: launches {lb8}")
    del cache


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

    card = card_line()
    print(card, flush=True)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "device_count": torch.cuda.device_count()}),
          flush=True)

    secs = _build.build_all(ptxas_verbose=True)
    for name, log in _build.PTXAS_INFO.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    print(json.dumps({"phase": "build", "seconds": secs}), flush=True)

    rows: list[dict] = []
    timer = Timer(torch)
    kernel_phase(torch, timer, rows)
    launches: dict[str, dict] = {}
    params = e2e_phase(torch, launches)
    prefill_phase(torch, params, launches)
    slice3_phase(torch, params, launches)
    slice4_phase(torch, timer, rows, params, launches)
    chain_phase(torch, timer, rows, params, launches)
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
