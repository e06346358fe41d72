"""The port's bench (llama_cu_awq_torch.bench) against the repository's
bench.py on the CPU, and its two tools.

bench.py's main() runs in this process with sys.argv set and its tuned
TPU defaults (bench_defaults.json) hidden, since the port reads none;
its dual decode run gets each leg's process from a stand-in for
subprocess.run that runs main() in-process. bench.py points JAX's
persistent compilation cache at a fixed directory (BENCH_PY_CACHE); here
that setting is sent to a temporary directory of the test's own, the
fixed one must come out as it went in, and the settings are restored
afterwards. The
numerics cases hold the port's generate_benchmark and its --model decode
leg to the JAX engine bound to forward(fused=True), the path the port
runs (tests/test_torch_engine.py).
"""

import contextlib
import functools
import importlib.util
import io
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch import bench as tb
from llama_cu_awq_torch.engine import InferenceEngine
from llama_cu_awq_torch.io.checkpoint import load_checkpoint
from llama_cu_awq_torch.models import params_from_checkpoint, synthetic_params
from llama_cu_awq_torch.tools import bench_scaling, trace_summary
from llama_cu_awq_torch.utils.profiling import profile_trace
from llama_cu_awq_tpu.config import ModelConfig
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint, save_checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--config", "tiny", "--steps", "24", "--repeats", "1"]
JAX_SETTINGS = ("jax_platforms", "jax_compilation_cache_dir",
                "jax_persistent_cache_min_compile_time_secs")
BENCH_PY_CACHE = "/tmp/llama_tpu_jax_cache"  # bench.py:183-184
# the numerics model: tests/test_torch_engine.py's CLI_CFG and seed, whose
# greedy margins stay above the two packages' bf16 rounding
BIN_CFG = ModelConfig(dim=256, hidden_dim=384, n_layers=2, n_heads=2,
                      n_kv_heads=1, vocab_size=512, seq_len=256)
BIN_SEED = 7


def _listing(path: str):
    return sorted(os.listdir(path)) if os.path.isdir(path) else None


def _last_json(text: str) -> dict:
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


class JaxBench:
    """bench.py's main() in this process, each flag set run once."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        spec = importlib.util.spec_from_file_location(
            "jax_root_bench", os.path.join(ROOT, "bench.py"))
        self.mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(self.mod)
        self.cache = {}
        self.legs = {}

    def _main(self, argv, mp):
        out = io.StringIO()
        mp.setattr(sys, "argv", ["bench.py", *argv])
        with contextlib.redirect_stdout(out):
            self.mod.main()
        return out.getvalue()

    def __call__(self, argv) -> dict:
        key = tuple(argv)
        if key in self.cache:
            return self.cache[key]
        from jax._src import compilation_cache

        saved = {k: getattr(jax.config, k) for k in JAX_SETTINGS}
        fixed = _listing(BENCH_PY_CACHE)
        exists = os.path.exists
        update = jax.config.update
        legs = self.legs.setdefault(key, [])
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(os.path, "exists", lambda p: False if str(
                    p).endswith("bench_defaults.json") else exists(p))
                mp.setattr(jax.config, "update", lambda name, value: update(
                    name, self.cache_dir
                    if name == "jax_compilation_cache_dir" else value))

                def leg(cmd, **_):
                    text = self._main(cmd[2:], mp)
                    legs.append(_last_json(text))
                    return types.SimpleNamespace(returncode=0, stdout=text)

                mp.setattr("subprocess.run", leg)
                res = _last_json(self._main(list(argv), mp))
        finally:
            for k, v in saved.items():
                jax.config.update(k, v)
            compilation_cache.reset_cache()
        assert _listing(BENCH_PY_CACHE) == fixed
        self.cache[key] = res
        return res


@pytest.fixture(scope="module")
def jax_bench(tmp_path_factory):
    return JaxBench(str(tmp_path_factory.mktemp("jax_cache")))


@pytest.fixture(autouse=True)
def one_thread_children(monkeypatch):
    """A default decode run's speculative leg is a child process: one
    torch thread there too, as in this process."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def port(argv) -> dict:
    return tb.run([*argv, "--device", "cpu"])


@pytest.fixture(scope="module")
def model_bin(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench") / "model.bin")
    save_checkpoint(path, random_checkpoint(BIN_CFG, seed=BIN_SEED))
    return path


@pytest.mark.parametrize("extra", [
    ["--spec", "none"],
    ["--spec", "ngram"],
    ["--mode", "prefill"],
    ["--mode", "batch", "--slots", "4", "--requests", "8"],
    ["--mode", "batch", "--slots", "4", "--requests", "8",
     "--admit-long", "70"],
    ["--spec", "none", "--kv-bits", "4", "--lm-head-bits", "8",
     "--decode-steps", "8", "--prompt-len", "16"],
], ids=["decode", "spec", "prefill", "batch", "admit_long", "kv4_lmh8_ctx"])
def test_single_leg_keys_match_jax_bench(jax_bench, extra):
    got = port(COMMON + extra)
    want = jax_bench(COMMON + extra + ["--platform", "cpu"])
    assert set(got) == set(want)
    assert got["metric"] == want["metric"]
    assert got["unit"] == want["unit"] == "tok/s"
    assert got["value"] > 0
    assert (got["vs_baseline"] is None) == (want["vs_baseline"] is None)


def test_default_decode_run_keys_match_jax_dual_run(jax_bench):
    """The default decode run: plain, spec and the re-bracket in one line
    with the same keys; the headline is one of the two legs' metrics."""
    got = port(COMMON)
    want = jax_bench(COMMON + ["--platform", "cpu"])
    legs = jax_bench.legs[tuple(COMMON + ["--platform", "cpu"])]
    assert len(legs) == 3
    assert set(got) == set(want)
    for k in ("decode_tok_s_plain", "decode_tok_s_spec", "plain_rebracket",
              "window_drift", "spec_acceptance"):
        assert got[k] is not None
    assert got["metric"] in {leg["metric"] for leg in legs[:2]}
    assert got["value"] == max(got["decode_tok_s_plain"],
                               got["decode_tok_s_spec"])


def test_model_decode_leg_keys_match_jax_bench(jax_bench, model_bin):
    extra = ["--model", model_bin, "--spec", "none"]
    got = port(COMMON + extra)
    want = jax_bench(COMMON + extra + ["--platform", "cpu"])
    assert set(got) == set(want)
    assert got["metric"] == want["metric"] == "decode_tok_s_real_w4g128_b1"
    assert got["vs_baseline"] is None and want["vs_baseline"] is None


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX engine bound to forward(fused=True)."""
    from llama_cu_awq_tpu.engine import engine as j_engine_mod
    from llama_cu_awq_tpu.models import llama as jl

    monkeypatch.setattr(j_engine_mod, "forward",
                        functools.partial(jl.forward, fused=True))
    return j_engine_mod


def _jax_engine(j_engine_mod, path, spec=None, max_seq=128):
    from llama_cu_awq_tpu.io.checkpoint import load_checkpoint as j_load
    from llama_cu_awq_tpu.models import llama as jl

    ckpt = j_load(path)
    return j_engine_mod.InferenceEngine(
        jl.params_from_checkpoint(ckpt), ckpt.config, tokenizer=None,
        act_dtype=jnp.bfloat16, matmul_impl="dequant", max_seq=max_seq,
        temperature=0.0, seed=1234, chunk_size=128, spec=spec, spec_k=7)


@pytest.mark.parametrize("spec", [None, "ngram"])
def test_generate_benchmark_untimed_prefill_matches_jax(jax_fused, model_bin,
                                                        spec):
    """The same tokens and the same timed count, untimed_prefill False
    (steps - 1) and True (the decode tokens), plain and spec."""
    ckpt = load_checkpoint(model_bin)
    t_eng = InferenceEngine(params_from_checkpoint(ckpt, device="cpu",
                                                   param_dtype=None),
                            ckpt.config, None, temperature=0.0, seed=1234,
                            max_seq=128, chunk_size=128, spec=spec,
                            device="cpu")
    j_eng = _jax_engine(jax_fused, model_bin, spec)
    prompt = [1] + [5 + (7 * i) % 97 for i in range(19)]
    for untimed in (False, True):
        steps = 20 + 14 if untimed else 30
        t_tok, t_dt, t_rate = t_eng.generate_benchmark(prompt, steps, untimed)
        j_tok, j_dt, j_rate = j_eng.generate_benchmark(prompt, steps, untimed)
        assert t_tok == [int(t) for t in j_tok]
        assert round(t_rate * t_dt) == round(j_rate * j_dt)
        assert round(t_rate * t_dt) == (len(t_tok) if untimed
                                        else steps - 1)


def test_model_decode_leg_stream_matches_jax(jax_fused, model_bin):
    """The port's --model decode leg and the JAX engine on the same .bin:
    the same greedy stream, token for token."""
    args = tb.parse_args([*COMMON, "--model", model_bin, "--spec", "none",
                          "--device", "cpu"])
    args.config = "real"
    s = tb.load(args, torch.device("cpu"), None, load_checkpoint(model_bin))
    leg = tb.decode_leg(s, None, 1, "plain")
    j_eng = _jax_engine(jax_fused, model_bin, max_seq=s.max_seq)
    j_tok, _, _ = j_eng.generate_benchmark(list(range(5, 13)), 24)
    assert leg.tokens == [int(t) for t in j_tok]
    assert leg.result["metric"] == "decode_tok_s_real_w4g128_b1"


def test_spec_both_with_decode_steps_runs_both_legs():
    got = port([*COMMON, "--spec", "both", "--decode-steps", "8",
                "--prompt-len", "16"])
    assert got["decode_tok_s_plain"] and got["decode_tok_s_spec"]
    assert got["metric"].endswith("_ctx16")
    assert "window_drift" in got and "spec_acceptance" in got


@pytest.mark.parametrize("mode", ["batch", "prefill"])
def test_spec_both_outside_decode_is_an_error(mode, capsys):
    with pytest.raises(SystemExit) as e:
        tb.parse_args(["--mode", mode, "--spec", "both"])
    assert e.value.code == 2
    assert "--spec both" in capsys.readouterr().err


@pytest.mark.parametrize("leg", ["plain", "spec"])
def test_failed_leg_fails_the_run(monkeypatch, capsys, leg):
    """A leg that fails ends the run, with no result line: the plain leg
    raising in this process, or the speculative leg's process exiting
    non-zero."""
    if leg == "plain":
        def broken(self, *a, **k):
            raise RuntimeError("leg failed")

        monkeypatch.setattr(InferenceEngine, "_decode_chunk", broken)
        with pytest.raises(RuntimeError, match="leg failed"):
            tb.main([*COMMON, "--device", "cpu"])
    else:
        monkeypatch.setattr(tb, "leg_command", lambda args, out: [
            sys.executable, "-c", "raise SystemExit(3)"])
        with pytest.raises(SystemExit, match="exited with 3"):
            tb.main([*COMMON, "--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_spec_stream_that_parts_from_plain_fails_the_gate(monkeypatch,
                                                          capsys):
    """A spec stream that parts from the plain one away from a near-tie
    fails the replay gate: the run exits non-zero, printing nothing."""
    real = tb.spec_leg

    def corrupt(s):
        leg = real(s)
        toks = leg.tokens
        leg.tokens = (toks[:3] + [(toks[3] + 1) % s.cfg.vocab_size]
                      + toks[4:])
        return leg

    monkeypatch.setattr(tb, "spec_leg", corrupt)
    with pytest.raises(SystemExit) as e:
        tb.main([*COMMON, "--device", "cpu"])
    assert "below the replayed argmax" in str(e.value.code)
    assert capsys.readouterr().out == ""


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        tb.run(["--config", "tiny"])


def test_batch_window_log_records_each_decode_position():
    """BatchEngine.window_log: every position a request's decode chunks
    stepped, at the window of its chunk; nothing while it is None."""
    from llama_cu_awq_torch.engine import BatchEngine

    cfg = tb.tiny_config()
    eng = BatchEngine(synthetic_params(cfg, device="cpu"), cfg, None,
                      n_slots=2, max_seq=64, temperature=0.0, chunk_size=4,
                      device="cpu")
    log = eng.window_log = {}
    rids = [eng.submit([1, 5, 6], max_new=6), eng.submit([1, 7], max_new=9)]
    out = eng.run()
    for rid, n_prompt in zip(rids, (3, 2)):
        last = n_prompt + len(out[rid]) - 2  # the step that emitted the last
        assert set(range(last + 1)) <= set(log[rid])
        assert set(log[rid].values()) <= set(eng._buckets)
    eng.window_log = None
    eng.reset()
    eng.submit([1, 5], max_new=3)
    eng.run()
    assert set(log) == set(rids)


def test_tp_batch_on_cpu_replays_its_streams(capsys):
    """--tp 2 over gloo on the CPU: the batch mode's leader serves, the
    follower follows, and both replay the streams."""
    got = port([*COMMON, "--mode", "batch", "--tp", "2", "--slots", "4",
                "--requests", "6", "--steps", "8"])
    assert got["metric"] == "batch_tok_s_tiny_w4g128_s4_r6_tp2"
    assert "batch gate" in capsys.readouterr().err


def test_trace_summary_of_a_cpu_run(tmp_path, capsys):
    """A CPU engine call's trace holds no device operations, and the
    summary says so."""
    eng = InferenceEngine(synthetic_params(tb.tiny_config(), device="cpu"),
                          tb.tiny_config(), None,
                          temperature=0.0, max_seq=64, device="cpu")
    with profile_trace(str(tmp_path)):
        eng.generate_benchmark([1, 5, 6, 7], 8)
    res = trace_summary.summarize(str(tmp_path), top=5, families=True)
    out = capsys.readouterr().out
    assert res["device_ops"] == 0 and res["busy_ms"] == 0.0
    assert "no device operations in the trace" in out
    assert "host operations" in out
    assert trace_summary.main([str(tmp_path / "trace.json")]) == 0


def test_trace_summary_device_numbers(tmp_path, capsys):
    """Busy time, occupancy, gaps over 0.1 ms and families of a trace
    with device events."""
    ev = [  # (name, ts us, dur us)
        ("void k::gemv<8, float>(Params)", 0, 50),
        ("void k::gemv<1, float>(Params)", 60, 40),   # 10 us gap: none
        ("attn_split_kernel_2", 300, 100),            # 200 us gap
        ("Memcpy HtoD (Pinned -> Device)", 410, 10),
    ]
    trace = {"traceEvents": [
        {"ph": "X", "cat": "gpu_memcpy" if n.startswith("Memcpy") else
         "kernel", "name": n, "ts": t, "dur": d} for n, t, d in ev]
        + [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
            "dur": 900}]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    res = trace_summary.summarize(str(tmp_path), families=True)
    assert res["busy_ms"] == pytest.approx(0.2)
    assert res["span_ms"] == pytest.approx(0.42)
    assert res["gaps"] == 1 and res["gap_ms"] == pytest.approx(0.2)
    assert res["families"]["k::gemv"] == [pytest.approx(0.09), 2]
    assert res["families"]["attn_split_kernel"][1] == 1
    only = trace_summary.summarize(str(path), module="gemv")
    assert only["device_ops"] == 2
    assert "occupancy" in capsys.readouterr().out


@pytest.mark.parametrize("name,fam", [
    ("void ns::k<4, at::native::Op<float>>(int, float*)", "ns::k"),
    ("ampere_bf16_s16816gemm_128x64_ldg8_stages_64x3_tn",
     "ampere_bf16_s16816gemm_128x64_ldg8_stages_64x3_tn"),
    ("int4_gemv_tile_8", "int4_gemv_tile"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
])
def test_trace_summary_families(name, fam):
    assert trace_summary.family(name) == fam


def test_bench_scaling_smoke(capsys):
    assert bench_scaling.main(["--smoke"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["metric"] for ln in lines] == [
        "scaling_tok_s_tiny_tp1", "scaling_tok_s_tiny_tp2",
        "scaling_efficiency_tiny_tp2"]
    assert lines[2]["target"] == 0.8 and lines[1]["devices"] == 2
    assert all(np.isfinite(ln["value"]) and ln["value"] > 0
               for ln in lines)
