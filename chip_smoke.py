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
  4. end to end: synthetic 7B w4-g128 weights on the card, 256 greedy
     decode steps through InferenceEngine.generate_benchmark, then short
     runs through the options that reach the other kernels (fused_step
     attention, int8 KV, int8 and w4 lm_head), each with the launch
     counters set to 0 just before and read just after; a profile of one
     16-token decode chunk (host wall time, device time per operation,
     device idle share); then one full 7B forward step through the
     kernels and through the plain versions.
Prints the card line and a {"kernels": [...]} line, then
{"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

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


def random_qtensor(torch, QTensor, n_in, n_out, g):
    groups = -(-n_in // 128)
    qw = torch.randint(0, 256, (n_out, n_in // 2), dtype=torch.uint8,
                       device="cuda", generator=g).view(torch.int32)
    scales = (0.01 * (1 + 0.1 * torch.randn(n_out, groups, device="cuda",
                                            generator=g))).half()
    zeros = torch.randint(0, 16, (n_out, groups), dtype=torch.uint8,
                          device="cuda", generator=g)
    return QTensor(qw, scales, zeros, n_in, n_out)


INT4_TOL = dict(rtol=2e-2, atol=2e-3, why=(
    "the int4 bar of tests/test_pallas_int4.py:68; kernel and plain "
    "dequantize exactly alike, sum in f32 in another order, and a bf16 "
    "output or staged x may round one ulp apart"))
GEMV_TOL = dict(rtol=1e-3, atol=1e-4, why=(
    "operands widen exactly to f32; only the order of the f32 sums differs"))
ATTN_TOL = dict(rtol=2e-2, atol=2e-3, why=(
    "same chunking as the plain version; f32 sums in another order can "
    "move p by one bf16 ulp before the PV product"))


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
    e2e_phase whose launches it reports (`path`), or None where no run
    launches its variant: GQA attention (7B is MHA) and int4_matmul at
    m=16 (prompts take the T=1 path in this slice) are checks only."""
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

    # --- int4_matmul_fused, the four projections of a 7B layer ---
    cases = [
        ("qkv_prescale", dim, 3 * dim, "prescale"),
        ("o_residual_ss", dim, dim, "residual"),
        ("gate_up_prescale", dim, 2 * hid, "prescale"),
        ("down_silu_residual_ss", hid, dim, "silu"),
    ]
    for tag, n_in, n_out, kind in cases:
        qt = random_qtensor(torch, QTensor, n_in, n_out, g)
        x = randn(1, n_in)
        kw = {}
        extra = []
        if kind == "prescale":
            ss = torch.rand(1, 1, device="cuda", generator=g) + 0.5
            nw = torch.rand(n_in, device="cuda", generator=g) + 0.5
            kw = dict(prescale=(ss, nw))
            extra = [ss, nw]
        else:
            res = randn(1, n_out)
            kw = dict(residual=res, emit_ss_eps=1e-5)
            extra = [res]
            if kind == "silu":
                kw["silu_u"] = randn(1, n_in)
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
            2 * n_in * n_out)
        rows.append(dict(
            name=f"int4_matmul_fused/{tag}", kernel="int4_matmul_fused",
            route="cuda", source="llama_cu_awq_torch/csrc/int4_gemv.cu",
            replaces="llama_cu_awq_tpu/ops/pallas/int4_matmul.py:543",
            variant=variant, path="main", **chk, ms=timer(lambda: int4_matmul_fused(x, qt, **kw)),
            plain_ms=timer(lambda: int4_matmul_fused(x, qt, plain=True,
                                                     **kw)),
            bound_ms=b, bound_by=src, library_ms=None))

    # --- int4_matmul: the w4 lm_head at m=1, a 16-row block on qkv ---
    for tag, m, n_in, n_out, path in (
            ("m1_lm_head", 1, dim, vocab, "lm_head_w4"),
            ("m16_qkv", 16, dim, 3 * dim, None)):
        qt = random_qtensor(torch, QTensor, n_in, n_out, g)
        x = randn(m, n_in)
        out, variant = launched_variant(lambda: int4_matmul(x, qt))
        ref = int4_matmul(x, qt, plain=True)
        torch.cuda.synchronize()
        chk = check_close(f"int4_matmul/{tag}", out, ref, **INT4_TOL)
        b, src = bound_ms(nbytes(qt.qw, qt.scales, qt.zeros, x, out),
                          2 * m * n_in * n_out)
        rows.append(dict(
            name=f"int4_matmul/{tag}", kernel="int4_matmul", route="cuda",
            source="llama_cu_awq_torch/csrc/int4_gemv.cu",
            replaces="llama_cu_awq_tpu/ops/pallas/int4_matmul.py:281",
            variant=variant, path=path, **chk, ms=timer(lambda: int4_matmul(x, qt)),
            plain_ms=timer(lambda: int4_matmul(x, qt, plain=True)),
            bound_ms=b, bound_by=src, library_ms=None))

    # --- dense_gemv: the 7B lm_head, bf16 and int8 rows ---
    w = (randn(vocab, dim, dtype=torch.float32) * 0.02).bfloat16()
    w8 = quantize_dense_int8(w)
    x = randn(1, dim)
    for tag, args, path in (("bf16", (w,), "main"),
                            ("int8", (w8.w8, w8.scale), "lm_head_int8")):
        out, variant = launched_variant(lambda: dense_gemv(x, *args))
        ref = dense_gemv(x, *args, plain=True)
        torch.cuda.synchronize()
        chk = check_close(f"dense_gemv/{tag}", out, ref, **GEMV_TOL)
        b, src = bound_ms(nbytes(*args, x, out), 2 * dim * vocab)
        lib = (timer(lambda: torch.nn.functional.linear(x, w))
               if tag == "bf16" else None)
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
            rows.append(dict(
                name=f"attention_step/{tag}", kernel="attention_step",
                route="cuda",
                source="llama_cu_awq_torch/csrc/attention_step.cu",
                replaces="llama_cu_awq_tpu/ops/pallas/attention_step.py:425",
                variant=variant, path=path, **chk,
                ms=timer(lambda: attention_step(*args, n_heads=H)),
                plain_ms=timer(lambda: attention_step(*args, n_heads=H,
                                                      plain=True), iters=5),
                bound_ms=b, bound_by=src, library_ms=None))
    for r in rows:
        print(json.dumps({"kernel_check": r["name"], "kernel_ms": r["ms"],
                          **{k: r[k] for k in (
                              "max_abs_err", "rtol", "atol", "plain_ms",
                              "library_ms", "bound_ms", "bound_by")}}),
              flush=True)


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


def profile_decode(torch, eng, prompt, steps=16):
    """Where a decode chunk's time goes: one chunk of `steps` tokens after
    the prompt, timed on the host clock without the profiler (median of
    3), then traced once with torch.profiler for the device's own time per
    kernel name. Device idle share = 1 - device busy / unprofiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def prepare():
        eng.reset()
        eng._prefill(prompt[:-1])
        token = torch.tensor([prompt[-1]], dtype=torch.int32, device="cuda")
        coins = eng._coins(steps)
        torch.cuda.synchronize()
        return token, coins

    def run(token, coins):
        t0 = time.perf_counter()
        eng._decode_chunk(token, coins, eng._bucket_for(eng.pos + steps))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall = statistics.median(run(*prepare()) for _ in range(3))
    args = prepare()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_wall = run(*args)
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    top_host = sorted(host.items(), key=lambda kv: -kv[1][1])[:10]
    print(json.dumps({
        "profile": "decode_chunk", "steps": steps,
        "wall_ms_per_token": wall / steps * 1e3,
        "traced_wall_ms_per_token": traced_wall / steps * 1e3,
        "device_ops_per_token": sum(v[0] for v in by_name.values()) / steps,
        "device_busy_ms_per_token": busy_ms / steps,
        "device_idle_share": (1 - busy_ms / (wall * 1e3)
                              if busy_ms else None),
        "top_device_ops": [{"name": n[:80], "count": c, "ms": us / 1e3}
                           for n, (c, us) in top],
        "top_host_ops_self_cpu": [{"name": n[:60], "count": c,
                                   "ms": us / 1e3}
                                  for n, (c, us) in top_host]}),
          flush=True)


def e2e_phase(torch, launches):
    from llama_cu_awq_torch.config import LLAMA2_7B
    from llama_cu_awq_torch.engine import InferenceEngine
    from llama_cu_awq_torch.models import (forward, init_kv_cache,
                                           quantize_lm_head,
                                           synthetic_params)

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
    logits = {}
    for kv_quant in (False, True):
        cache = init_kv_cache(cfg, 1, 2048, quantized=kv_quant)
        for l in range(cfg.n_layers):
            for buf, sc in ((cache.k[l], cache.k_scale), (cache.v[l],
                                                          cache.v_scale)):
                if kv_quant:
                    buf.copy_(torch.randint(-127, 128, buf.shape,
                                            dtype=torch.int8, device="cuda",
                                            generator=g))
                    sc[l].copy_(torch.rand(sc[l].shape, device="cuda",
                                           generator=g) * 0.02)
                else:
                    buf.copy_(torch.randn(buf.shape, device="cuda",
                                          generator=g).bfloat16())
        for plain in (False, True):
            c = init_kv_cache(cfg, 1, 2048, quantized=kv_quant)
            for dst, src in zip(c.k + c.v + c.k_scale + c.v_scale,
                                cache.k + cache.v + cache.k_scale
                                + cache.v_scale):
                dst.copy_(src)
            out, _ = forward(params, cfg, tok, pos, c,
                             attn_impl="fused_step", plain=plain)
            logits[plain] = out.float()
            del c
        k, p = logits[False], logits[True]
        if not bool(k.isfinite().all()):
            raise AssertionError("non-finite logits from the kernel path")
        diff = float((k - p).abs().max())
        scale = float(p.abs().max())
        tol = 2e-2 * max(1.0, scale)
        print(json.dumps({
            "forward_7b": "int8_kv" if kv_quant else "bf16_kv",
            "max_abs_logit_diff": diff, "max_abs_logit": scale,
            "tolerance": tol, "argmax_kernel": int(k.argmax()),
            "argmax_plain": int(p.argmax()),
            "why": "32 layers of bf16 activations: one-ulp roundings in "
                   "either path propagate; bound 2% of the largest logit"}),
            flush=True)
        if diff > tol:
            raise AssertionError(f"7B forward: kernel and plain logits "
                                 f"differ by {diff} > {tol}")


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
    e2e_phase(torch, launches)
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
