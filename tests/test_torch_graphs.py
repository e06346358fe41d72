"""The engine's device-resident loops on the CPU, held to the JAX engine.

The port's engine keeps its step state on the device and runs each decode
step, forced prompt step and prefill block as a step body that a CUDA
graph captures on the card (engine/graphs.py); on the CPU the same bodies
run eagerly, so these tests hold exactly the code that is captured. The
oracle is the JAX engine, whose decode chunks run as one lax.scan
(_decode_chunk_fn), short prompts as a scanned forced chunk
(_forced_chunk_fn) and the full blocks of a prompt of 2 * 128 + 1 tokens
and more as one scan (_prefill_scan_fn). Its forward is bound either to
its own fused=True path (the staging the port runs), as
tests/test_torch_prefill.py binds it, or to the port's forward. The two
packages' forwards round apart by one bf16 ulp now and then (logits a few
1e-3 apart after some steps at these widths), which a greedy stream with
its wide margins survives and a sampled one at temperature 0.5 does not:
a sampled stream parts at the first near-tie in its sorted
probabilities. So the sampled and chat cases run the JAX engine's loop
(scans, sampler, coins, buckets) over the port's forward, under
jax.disable_jit so that the scans loop in Python on concrete arrays:
they hold the port's loop to the JAX loop, where the greedy, EOS and
prefill cases hold the whole port to the whole JAX engine. Inputs come
from the JAX package's seeded random checkpoint.

Tolerances: token streams, replies, positions and xorshift states must
be identical; the cache rows and last logits after a prompt are held to
tests/test_torch_prefill.py's bars (rtol/atol 2e-2: two paths that round
differently, and a scan whose window is the chunk's end bucket where the
port keeps each block's own). The launch bookkeeping is exact.
"""

import contextlib
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.cli import main as t_main
from llama_cu_awq_torch.engine import InferenceEngine as TEngine
from llama_cu_awq_torch.engine.graphs import collector_off, record_launches
from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_torch.ops.cuda import (LAUNCHES, VARIANT_LAUNCHES, count,
                                         reset_launches)
from llama_cu_awq_torch.tokenizer import EOS_TOKEN
from llama_cu_awq_torch.tokenizer import Tokenizer as TTokenizer
from llama_cu_awq_torch.utils.profiling import TRACE_FILE, profile_trace
from llama_cu_awq_tpu.config import ModelConfig
from llama_cu_awq_tpu.engine.engine import InferenceEngine as JEngine
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint
from llama_cu_awq_tpu.models import llama as jl
from llama_cu_awq_tpu.tokenizer import Tokenizer as JTokenizer
from tests.test_tokenizer import write_toy_tokenizer
from tests.test_torch_engine import _toy_vocab, _write_model
from tests.torch_graph_standins import (_CountingSet, _SplitSet, _StaleSet,
                                        check_split_job, split_job)

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
# (tens of times slower on small tensors); it also fixes the CPU sum order
torch.set_num_threads(1)

# head_dim 128 (the JAX forward engages its Pallas prefill kernel), GQA
# 2/1; a 256-row cache has the attention buckets 128 and 256, a 512-row
# one room for the JAX engine's scanned prefill (257 tokens and more)
CFG = ModelConfig(dim=256, hidden_dim=384, n_layers=2, n_heads=2,
                  n_kv_heads=1, vocab_size=512, seq_len=256)
CFG512 = dataclasses.replace(CFG, seq_len=512)
LOGITS = dict(rtol=2e-2, atol=2e-2)


def _fused_fwd(cfg, params, tokens, pos, cache, **kw):
    return jl.forward(params, cfg, tokens, pos, cache, fused=True, **kw)


@functools.lru_cache(maxsize=None)
def _tree(cfg, seed=3):
    """The JAX package's params as numpy arrays (the tree both packages
    are built from)."""
    jp = jl.params_from_checkpoint(random_checkpoint(cfg, seed=seed),
                                   param_dtype=jnp.bfloat16)
    return jax.tree_util.tree_map(np.asarray, jp)


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _port_fwd(tp, cfg, params, tokens, pos, cache, *, attn_len,
              no_logits=False, logits_all=False, **_):
    """The JAX engine's _fwd over the port's forward (attn_impl "auto", the
    port engine's), on concrete arrays: jax.disable_jit only."""
    tc = tl.kv_cache_from_numpy(jax.tree_util.tree_map(np.asarray, cache),
                                device="cpu")
    logits, tc = tl.forward(tp, cfg, torch.from_numpy(np.array(tokens)),
                            torch.from_numpy(np.array(pos)), tc,
                            attn_len=attn_len, attn_impl="auto",
                            no_logits=no_logits, logits_all=logits_all)
    new = jl.KVCache(*([jnp.asarray(_np(t)) for t in ts]
                       for ts in (tc.k, tc.v, tc.k_scale, tc.v_scale)))
    return (None if logits is None else jnp.asarray(logits.numpy())), new


def _engines(cfg, tree, tok_path=None, jax_forward="fused", **kw):
    """The JAX engine and the port's on the same weights; the JAX engine's
    forward is its fused path ("fused") or the port's ("port")."""
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = tl.params_from_numpy(tree, cfg, device="cpu")
    jtok = JTokenizer(tok_path, cfg.vocab_size) if tok_path else None
    ttok = TTokenizer(tok_path, cfg.vocab_size) if tok_path else None
    je = JEngine(jp, cfg, jtok, max_seq=cfg.seq_len, **kw)
    je._fwd = (functools.partial(_fused_fwd, cfg) if jax_forward == "fused"
               else functools.partial(_port_fwd, tp, cfg))
    te = TEngine(tp, cfg, ttok, max_seq=cfg.seq_len, device="cpu", **kw)
    return je, te


@pytest.fixture(scope="module")
def toy_tok(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok") / "tok.bin")
    write_toy_tokenizer(path, _toy_vocab(CFG.vocab_size))
    return path


# a 120-token prompt: block prefill, then decode from position 119 in
# chunks of 5 whose windows cross from the 128 bucket into the 256 one;
# 23 decode tokens end in a short chunk of 3
PROMPT = [1] + [3 + (37 * i) % 500 for i in range(119)]
STEPS = len(PROMPT) + 22


@pytest.mark.parametrize("temperature,jax_forward", [(0.0, "fused"),
                                                     (0.5, "port")])
def test_decode_streams_match_jax_generate(temperature, jax_forward):
    """generate_benchmark's chained device chunks against the JAX
    engine's scanned chunks: greedy over the JAX forward, and sampled at
    the CLI's defaults (temperature 0.5, topp 0.6) over the port's."""
    je, te = _engines(CFG, _tree(CFG), jax_forward=jax_forward,
                      temperature=temperature, topp=0.6, seed=99,
                      chunk_size=5)
    with (jax.disable_jit() if jax_forward == "port"
          else contextlib.nullcontext()):
        jt, _, _ = je.generate_benchmark(PROMPT, STEPS)
    tt, _, _ = te.generate_benchmark(PROMPT, STEPS)
    assert len(tt) == STEPS - len(PROMPT) + 1 == 23
    assert tt == jt
    assert te.pos == je.pos == len(PROMPT) - 1 + 23
    assert te.rng.state == je.rng.state


def test_decode_eos_rewind_matches_jax():
    """A mid-chunk EOS: the lm_head row of EOS is set to the row of the
    token the greedy stream first emits at a step j inside its second
    chunk of 4, in both packages, so both emit EOS there (argmax takes the
    first of equal logits). The streams, positions and the rewound
    xorshift states are equal."""
    tree = _tree(CFG)
    _, te = _engines(CFG, tree, temperature=0.0, chunk_size=4)
    te._prefill(PROMPT[:-1])
    first = torch.tensor([PROMPT[-1]], dtype=torch.int32)
    plain, hit = te._decode_tokens(first, 12)
    assert not hit and EOS_TOKEN not in plain
    j = next(j for j in range(5, 8) if plain[j] not in plain[:j])
    head = np.array(tree.lm_head)
    head[EOS_TOKEN] = head[plain[j]]
    je, te = _engines(CFG, dataclasses.replace(tree, lm_head=head),
                      temperature=0.0, chunk_size=4)
    got = {}
    for name, e in (("jax", je), ("torch", te)):
        e._prefill(PROMPT[:-1])
        e._consume_coins(len(PROMPT) - 1)
        tok = (jnp.asarray([PROMPT[-1]], jnp.int32) if name == "jax"
               else first)
        got[name] = e._decode_tokens(tok, 12)
    assert got["torch"] == got["jax"] == (plain[:j] + [EOS_TOKEN], True)
    assert te.pos == je.pos == len(PROMPT) - 1 + j + 1
    assert te.rng.state == je.rng.state


def test_chat_after_reset_matches_jax(toy_tok):
    """Two sampled chat turns (short prompts: the forced T=1 steps),
    reset(), two more: the replies equal the JAX engine's (its loop over
    the port's forward), and reset() zeroes the cache in place, keeping
    the addresses the graphs hold."""
    je, te = _engines(CFG, _tree(CFG), toy_tok, jax_forward="port",
                      temperature=0.5, topp=0.6, seed=5, chunk_size=4)
    ptrs = [t.data_ptr() for t in te.cache.k + te.cache.v]
    # a turn without EOS runs to its step budget: the second turn gets a
    # larger one
    turns = [("the cat sat", "be brief", 60), ("on the mat", None, 120)]
    replies = {"jax": [], "torch": []}
    for rnd in range(2):
        for name, e in (("jax", je), ("torch", te)):
            if rnd:
                e.reset()
            for user, system, steps in turns:
                with jax.disable_jit():
                    replies[name].append(e.chat_turn(user, system, steps))
    assert replies["torch"] == replies["jax"]
    assert all(replies["torch"])
    assert te.pos == je.pos > 0
    assert te.rng.state == je.rng.state
    te.reset()
    assert [t.data_ptr() for t in te.cache.k + te.cache.v] == ptrs
    assert all(not t.any() for t in te.cache.k + te.cache.v)


def test_scanned_prefill_matches_jax():
    """A 300-token prompt, where the JAX engine runs its first two full
    blocks as one scan (_prefill_scan_fn, window 256) and the rest block
    by block; the port replays its block body per block, each at its own
    window. Cache rows and the last token's logits agree."""
    je, te = _engines(CFG512, _tree(CFG512), temperature=0.0)
    assert je._prefill_scan_ok()
    scans = []
    real = je._prefill_scan_fn

    def spy(params, rows, *args, **kw):
        scans.append(rows.shape)
        return real(params, rows, *args, **kw)

    je.__dict__["_prefill_scan_fn"] = spy
    prompt = [1] + [3 + (53 * i) % 500 for i in range(299)]
    want = np.asarray(je._prefill(prompt))
    got = te._prefill(prompt).numpy()
    assert scans == [(2, 128)]
    assert je.pos == te.pos == 300
    np.testing.assert_allclose(got, want, **LOGITS)
    for a, b in zip(je.cache.k + je.cache.v, te.cache.k + te.cache.v):
        np.testing.assert_allclose(np.asarray(a, np.float32)[:, :300],
                                   b.float().numpy()[:, :300], **LOGITS)


# ---------------------------------------------------------------------------
# the graphs' launch bookkeeping, without a card

def test_record_launches_takes_back_what_the_body_counted():
    reset_launches()
    count("dense_gemv", "bf16/m1")

    def body():
        count("int4_matmul_fused", "gemv/a")
        count("int4_matmul_fused", "gemv/b")
        count("dense_gemv", "bf16/m1")
        return 7

    out, (kernels, variants) = record_launches(body)
    assert out == 7
    assert kernels == {"int4_matmul_fused": 2, "dense_gemv": 1}
    assert variants == {"int4_matmul_fused/gemv/a": 1,
                        "int4_matmul_fused/gemv/b": 1,
                        "dense_gemv/bf16/m1": 1}
    assert LAUNCHES["int4_matmul_fused"] == 0 and LAUNCHES["dense_gemv"] == 1
    assert VARIANT_LAUNCHES == {"dense_gemv/bf16/m1": 1}


@pytest.mark.parametrize("enabled", [True, False])
def test_collector_off_while_any_capture_runs(enabled):
    """Captures on two threads overlap: the collector stays off from the
    first one's start to the last one's end, then is as it was."""
    import gc
    import threading

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        first_in, release = threading.Event(), threading.Event()
        seen = {}

        def first():
            with collector_off():
                first_in.set()
                release.wait(timeout=30)
                seen["first_end"] = gc.isenabled()

        t = threading.Thread(target=first)
        t.start()
        assert first_in.wait(timeout=30)
        with collector_off():
            seen["second"] = gc.isenabled()
        seen["after_second"] = gc.isenabled()
        release.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert seen == {"second": False, "after_second": False,
                        "first_end": False}
        assert gc.isenabled() == enabled
        with pytest.raises(RuntimeError):
            with collector_off():
                raise RuntimeError("a capture that fails")
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


def test_replays_count_as_launches():
    """run(key, body, n): the first call runs the body eagerly (counted by
    the wrappers), captures it (counted, then taken back), and replays n -
    1 times, each adding the body's launches; a later run of the key
    replays only. The counters read as n eager bodies would leave them."""
    reset_launches()
    calls = []

    def body():
        calls.append(1)
        count("attention_step", "bf16/B1")
        count("int4_matmul_fused", "gemv/qkv")
        count("int4_matmul_fused", "gemv/o")

    gs = _CountingSet()
    gs.run(("decode", 1, 128), body, 5)
    assert len(calls) == 2 and len(gs.graphs) == 1
    g = gs.graphs[("decode", 1, 128)]
    assert g.graph.n == 4
    assert LAUNCHES["attention_step"] == 5
    assert LAUNCHES["int4_matmul_fused"] == 10
    assert VARIANT_LAUNCHES == {"attention_step/bf16/B1": 5,
                                "int4_matmul_fused/gemv/qkv": 5,
                                "int4_matmul_fused/gemv/o": 5}
    gs.run(("decode", 1, 128), body, 3)
    gs.run(("decode", 1, 128), body, 0)
    assert len(calls) == 2 and g.graph.n == 7
    assert LAUNCHES["int4_matmul_fused"] == 16
    gs.run(("decode", 1, 256), body, 1)
    assert len(gs.graphs) == 2 and len(calls) == 4
    assert LAUNCHES["attention_step"] == 9
    reset_launches()


class _TwoRanks:
    """torch.distributed's two collectives for a group of two ranks that
    hold the same tensors, in one process: a sum doubles, a gather
    repeats."""

    ReduceOp = torch.distributed.ReduceOp

    @staticmethod
    def all_reduce(x, op=None, group=None):
        x.mul_(2)

    @staticmethod
    def all_gather(parts, x, group=None):
        for p in parts:
            p.copy_(x)


@pytest.fixture
def two_ranks(monkeypatch):
    """A TPGroup of two ranks on the CPU whose collectives are _TwoRanks'."""
    from llama_cu_awq_torch.parallel import mesh

    monkeypatch.setattr(mesh, "dist", _TwoRanks)
    return mesh.TPGroup(0, 2, None, "gloo", torch.device("cpu"), (0, 1))


def test_split_capture_segments_and_collectives_in_order(two_ranks):
    """A body with two all-reduces and a gather captures 4 segments
    around 3 collective steps, in order: the segments' launches sum to the
    eager call's, a replay runs segment, collective, segment, ... on the
    tensors the body gave, and a collective on another thread during the
    capture, or outside one, runs at once (see check_split_job). x starts
    at 1 and doubles at each all-reduce run: twice eagerly, none in the
    capture, twice in the replay."""
    check_split_job(split_job(two_ranks), 16.0)
    reset_launches()


def test_body_without_collectives_is_one_segment():
    """A single-device body (no collective) captures as one segment, and
    its replays count its launches as before."""
    reset_launches()

    def body():
        count("int4_matmul_fused", "gemv/qkv")
        count("dense_gemv", "bf16/m1")

    gs = _SplitSet()
    gs.run(("step",), body, 3)
    g = gs.graphs[("step",)]
    assert g.segments == 1 and g.splits == []
    assert gs.log == [("end", 0), ("segment", 0, gs.log[1][2]),
                      ("segment", 0, gs.log[1][2])]
    assert LAUNCHES["int4_matmul_fused"] == 3 and LAUNCHES["dense_gemv"] == 3
    reset_launches()


def test_failed_split_capture_raises_and_ends_the_split(two_ranks):
    """A body that raises mid-capture: the body's error comes out, the
    unfinished segment's capture is ended, no graph is kept, and the
    thread's collectives run at once again."""
    from llama_cu_awq_torch.parallel.mesh import all_reduce_sum

    x = torch.ones(1)
    calls = []

    def body():
        all_reduce_sum(x, two_ranks)
        if calls:
            raise RuntimeError("a body that cannot be captured")
        calls.append(1)

    gs = _SplitSet()
    with pytest.raises(RuntimeError, match="cannot be captured"):
        gs.run(("step",), body, 2)
    assert gs.log == [("end", 0), ("end", 1)] and not gs.graphs
    all_reduce_sum(x, two_ranks)
    assert x.tolist() == [4.0]  # the eager call's and this one


def test_graph_keys_hold_the_host_choices(monkeypatch):
    """One key per kind, block width, window and forward's plan: the
    window's attn_impl after "auto", the cache format and the down_qkv
    switch change it; no chunk length is in it."""
    cfg = dataclasses.replace(CFG, seq_len=2048)
    tp = tl.params_from_numpy(_tree(CFG), cfg, device="cpu")
    e = TEngine(tp, cfg, None, device="cpu")
    assert e._graphs is None  # no graphs on the CPU
    k128, k1024 = e._graph_key("decode", 1, 128), e._graph_key(
        "decode", 1, 1024)
    assert k128 != k1024
    assert k128[3].attn_impl is None and k1024[3].attn_impl == "fused_step"
    assert e._graph_key(("prompt", True), 128, 1024)[3].pfk
    e8 = TEngine(tp, cfg, None, device="cpu", kv_quant=True)
    assert e8._graph_key("decode", 1, 1024) != k1024
    monkeypatch.setattr(tl.dq, "supported", lambda *a: True)
    monkeypatch.setenv("LLAMA_TPU_DOWN_QKV", "1")
    assert e._graph_key("decode", 1, 1024)[3].dq_chain
    assert e._graph_key("decode", 1, 128) == k128


@pytest.mark.parametrize("temperature,jax_forward", [(0.0, "fused"),
                                                     (0.1, "port")])
def test_spec_verify_replayed_stale_matches_jax(temperature, jax_forward):
    """spec="ngram" decode whose verifies (and plain chunks) replay the
    first body of their key (_StaleSet): the streams, spec_stats,
    positions and xorshift states equal the JAX engine's, greedy over its
    fused forward and sampled over the port's (see the module
    docstring). Verifies cross the 128 and 256 buckets."""
    prompt = [1, 5, 9, 13, 7, 5, 9, 13] * 14
    je, te = _engines(CFG, _tree(CFG), jax_forward=jax_forward,
                      temperature=temperature, topp=0.9, seed=3,
                      chunk_size=5, spec="ngram", spec_k=4)
    te._graphs = _StaleSet()
    with (jax.disable_jit() if jax_forward == "port"
          else contextlib.nullcontext()):
        jt, _, _ = je.generate_benchmark(prompt, len(prompt) + 40)
    tt, _, _ = te.generate_benchmark(prompt, len(prompt) + 40)
    assert tt == jt and len(tt) == 41
    assert te.spec_stats == je.spec_stats
    assert te.spec_stats["verifies"] > 1
    assert te.pos == je.pos and te.rng.state == je.rng.state
    verifies = [k for k in te._graphs.graphs if k[0] == "verify"]
    assert {k[2] for k in verifies} == {128, 256}
    assert all(k[1] == 5 for k in verifies)


# ---------------------------------------------------------------------------
# --profile DIR

def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "t")):
        torch.ones(4).sum()
    with open(tmp_path / "t" / TRACE_FILE) as f:
        assert "traceEvents" in json.load(f)


def test_cli_profile_writes_a_trace(tmp_path, capsys):
    path, tok_path = _write_model(tmp_path, CFG)
    out = tmp_path / "prof"
    assert t_main([path, "-n", "20", "-i", "the cat", "-t", "0", "-z",
                   tok_path, "--device", "cpu", "--profile", str(out)]) == 0
    assert "achieved tok/s" in capsys.readouterr().out
    with open(out / TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
