"""Speculative decoding (spec="ngram") in the port, held to the JAX engine
and to the port's own plain decode on the CPU.

The JAX engine is driven with its forward bound to fused=True (the fused
staging the port runs), as tests/test_torch_engine.py's replay does. The
contract, as in tests/test_spec_decode.py: the spec stream is the plain
stream, greedy or sampled (verify positions sample on the coins plain
decode would draw there), and exactly the emitted count of coins is
consumed. The streams are compared token for token; the model and seeds
are fixed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.engine import InferenceEngine as TEngine
from llama_cu_awq_torch.engine.engine import propose_ngram as t_propose
from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_tpu.config import ModelConfig
from llama_cu_awq_tpu.engine.engine import InferenceEngine as JEngine
from llama_cu_awq_tpu.engine.engine import propose_ngram as j_propose
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint
from llama_cu_awq_tpu.models import llama as jl

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
# (tens of times slower on small tensors); it also fixes the CPU sum order
torch.set_num_threads(1)

CFG = ModelConfig(dim=128, hidden_dim=256, n_layers=2, n_heads=4,
                  n_kv_heads=4, vocab_size=256, seq_len=128)
# a repetitive prompt: the trailing 3-gram (5, 9, 13) recurs, so the first
# decode round already proposes
PROMPT = [1, 5, 9, 13, 7, 5, 9, 13]


@functools.lru_cache(maxsize=None)
def _params(seed=4):
    jp = jl.params_from_checkpoint(random_checkpoint(CFG, seed=seed),
                                   param_dtype=jnp.bfloat16)
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), CFG,
                              device="cpu")
    return jp, tp


def _fused_fwd(params, tokens, pos, cache, **kw):
    return jl.forward(params, CFG, tokens, pos, cache, fused=True, **kw)


def _t_engine(**kw):
    kw.setdefault("temperature", 0.0)
    kw.setdefault("max_seq", 128)
    kw.setdefault("chunk_size", 8)
    return TEngine(_params()[1], CFG, kw.pop("tokenizer", None),
                   device="cpu", **kw)


def _j_engine(**kw):
    kw.setdefault("temperature", 0.0)
    kw.setdefault("max_seq", 128)
    kw.setdefault("chunk_size", 8)
    e = JEngine(_params()[0], CFG, kw.pop("tokenizer", None), **kw)
    e._fwd = _fused_fwd
    return e


def test_propose_ngram_matches_jax(rng):
    assert t_propose([1, 2, 3, 4, 9, 7, 2, 3, 4], 4)[0] == 9
    assert t_propose([1, 2, 3, 4, 5, 6, 7, 8], 4) is None
    assert t_propose([5, 6, 7, 42, 9, 5, 6, 7], 6) == [42, 9, 5, 6, 7, 7]
    for _ in range(300):
        n = int(rng.integers(0, 40))
        hist = rng.integers(0, int(rng.integers(2, 8)), n).tolist()
        k = int(rng.integers(1, 9))
        assert t_propose(hist, k) == j_propose(hist, k), (hist, k)


def test_greedy_spec_stream_matches_plain_and_jax():
    """The spec stream equals the port's plain stream and the JAX spec
    stream, with the same spec_stats; proposals are really accepted."""
    plain, _, _ = _t_engine().generate_benchmark(PROMPT, 60)
    te = _t_engine(spec="ngram", spec_k=4)
    got, _, _ = te.generate_benchmark(PROMPT, 60)
    je = _j_engine(spec="ngram", spec_k=4)
    want, _, _ = je.generate_benchmark(PROMPT, 60)
    assert got == plain == want and len(got) == 60 - len(PROMPT) + 1
    assert te.spec_stats == je.spec_stats
    assert te.spec_stats["verifies"] > 0 and te.spec_stats["accepted"] > 0
    assert te.pos == je.pos == 60


def test_sampled_spec_stream_matches_plain():
    """temperature > 0: the same draws as plain decode, and the same
    number of coins consumed (equal xorshift state at the end)."""
    kw = dict(temperature=0.2, topp=0.9, seed=7)
    pe = _t_engine(**kw)
    plain, _, _ = pe.generate_benchmark(PROMPT, 60)
    te = _t_engine(spec="ngram", spec_k=4, **kw)
    got, _, _ = te.generate_benchmark(PROMPT, 60)
    assert te.spec_stats["verifies"] > 0
    assert got == plain
    assert te.rng.state == pe.rng.state


def test_spec_respects_max_seq():
    """Near the end of the cache no proposal is verified (k + 1 rows would
    not fit); the engine falls back to plain steps and fills the cache to
    max_seq exactly, with the plain stream."""
    plain, _, _ = _t_engine(max_seq=32).generate_benchmark(PROMPT, 64)
    te = _t_engine(spec="ngram", spec_k=4, max_seq=32)
    got, _, _ = te.generate_benchmark(PROMPT, 64)
    assert te.pos == 32 and got == plain
    assert te.spec_stats["verifies"] > 0


def test_spec_unknown_mode_rejected():
    with pytest.raises(ValueError, match="unknown spec mode"):
        _t_engine(spec="medusa")


class _FakeTok:
    """Ids as text: encode returns a fixed repetitive prompt."""

    def encode(self, s, bos=True, eos=False):
        return [1, 7, 7, 9, 7, 7]

    def decode(self, prev, t):
        return f"<{t}>"

    def safe_piece(self, p):
        return p


def test_spec_generate_text_and_chat():
    """generate() (echo and the one-step print lag) and a chat turn with
    spec on print what the plain engine prints."""
    te = _t_engine(tokenizer=_FakeTok(), spec="ngram", spec_k=4)
    pe = _t_engine(tokenizer=_FakeTok())
    t1, stats = te.generate("x", steps=40)
    t0, _ = pe.generate("x", steps=40)
    assert t1 == t0 and stats["tokens"] == 39
    assert te.spec_stats["verifies"] > 0
    for e in (te, pe):
        e.reset()
    assert te.chat_turn("x", steps=60) == pe.chat_turn("x", steps=60)
    assert te.pos == pe.pos
