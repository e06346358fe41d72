"""The port's engine and CLI on the CPU, held to a stepwise JAX replay.

The JAX engine on the CPU runs its unfused path (models/llama.py:547-550),
which rounds differently from the fused path the port runs, so the oracle
is the JAX forward(fused=True, matmul_impl="dequant") stepped with the
engine's schedule: the prompt teacher-forced at T=1 (one xorshift coin
burnt per prompt step), then each sampled token fed back. Token streams
must be identical.
"""

import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cu_awq_torch.cli import main as t_main
from llama_cu_awq_torch.engine import InferenceEngine
from llama_cu_awq_torch.engine import attn_buckets as t_attn_buckets
from llama_cu_awq_torch.io.checkpoint import random_checkpoint as t_random
from llama_cu_awq_torch.io.checkpoint import save_checkpoint as t_save
from llama_cu_awq_torch.models import llama as tl
from llama_cu_awq_torch.tokenizer import Tokenizer as TTokenizer
from llama_cu_awq_tpu.engine.engine import attn_buckets as j_attn_buckets
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint
from llama_cu_awq_tpu.models import llama as jl
from llama_cu_awq_tpu.sampling import XorshiftRNG, sample_token
from llama_cu_awq_tpu.tokenizer import Tokenizer as JTokenizer
from tests.test_tokenizer import write_toy_tokenizer


def _toy_vocab(vocab_size):
    """tests/test_engine.py's toy vocab, padded to vocab_size."""
    vocab = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    vocab += [(bytes([b]), -1000.0) for b in range(256)]
    words = [b" the", b" cat", b" sat", b" on", b" mat", b"s", b" a",
             b"the", b"cat", b" "]
    vocab += [(w, -float(i)) for i, w in enumerate(words)]
    mids = [b"th", b"he", b"ca", b"at", b"sa", b" t", b" c", b" s", b" th",
            b" ca"]
    vocab += [(m, -100.0 - i) for i, m in enumerate(mids)]
    vocab += [(b"<pad%d>" % i, -2000.0)
              for i in range(vocab_size - len(vocab))]
    return vocab


@pytest.fixture
def setup(tmp_path, tiny_config):
    tok_path = str(tmp_path / "tok.bin")
    write_toy_tokenizer(tok_path, _toy_vocab(tiny_config.vocab_size))
    jp = jl.params_from_checkpoint(random_checkpoint(tiny_config, seed=21),
                                   param_dtype=jnp.bfloat16)
    tp = tl.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              tiny_config, device="cpu")
    return tiny_config, jp, tp, tok_path


def _jax_replay(cfg, jp, prompt, n_steps, temperature=0.0, topp=0.6,
                seed=0):
    """The engine's schedule on the JAX fused forward: prompt[:-1]
    teacher-forced, then n_steps sampled steps from prompt[-1]."""
    rng = XorshiftRNG(seed)
    cache = jl.init_kv_cache(cfg, 1, cfg.seq_len)

    def step(tok, pos, no_logits=False):
        return jl.forward(jp, cfg, jnp.asarray([[tok]], jnp.int32),
                          jnp.asarray([pos], jnp.int32), cache, fused=True,
                          matmul_impl="dequant", no_logits=no_logits)

    for i, t in enumerate(prompt[:-1]):
        _, cache = step(t, i, no_logits=True)
        rng.random_f32()
    tok, out = prompt[-1], []
    for s in range(n_steps):
        logits, cache = step(tok, len(prompt) - 1 + s)
        coin = jnp.asarray([rng.random_f32()], jnp.float32)
        tok = int(sample_token(logits, coin, temperature, topp)[0])
        out.append(tok)
    return out


def test_attn_buckets_match_jax():
    for n in (64, 96, 100, 512, 4096, 128 * 1024):
        assert t_attn_buckets(n) == j_attn_buckets(n)


def test_greedy_stream_matches_jax_replay(setup):
    cfg, jp, tp, _ = setup
    prompt = [1, 40, 300, 7, 99]
    steps = 24
    eng = InferenceEngine(tp, cfg, None, temperature=0.0, device="cpu",
                          chunk_size=5)
    toks, _, _ = eng.generate_benchmark(prompt, steps)
    assert toks == _jax_replay(cfg, jp, prompt, steps - len(prompt) + 1)


def test_generate_text_matches_jax_replay(setup):
    """generate(): the prompt is echoed, and the last generated token is
    never printed (the reference's one-step print lag)."""
    cfg, jp, tp, tok_path = setup
    ttok = TTokenizer(tok_path, cfg.vocab_size)
    jtok = JTokenizer(tok_path, cfg.vocab_size)
    steps = 14
    prompt = jtok.encode("the cat sat", bos=True, eos=False)
    assert ttok.encode("the cat sat", bos=True, eos=False) == prompt
    want = _jax_replay(cfg, jp, prompt, steps - len(prompt) + 1)
    eng = InferenceEngine(tp, cfg, ttok, temperature=0.0, device="cpu")
    pieces = []
    text, stats = eng.generate("the cat sat", steps=steps,
                               on_piece=pieces.append)
    stream = prompt + want[:-1]
    expect = "".join(jtok.safe_piece(jtok.decode(a, b))
                     for a, b in zip(stream, stream[1:]))
    assert text == expect == "".join(pieces)
    assert stats["tokens"] == steps - 1
    assert stats["generated"] == len(want) - 1


@pytest.mark.parametrize("temperature,topp", [(0.9, 0.6), (1.0, 1.0)])
def test_seeded_sampling_deterministic_and_matches_jax(setup, temperature,
                                                       topp):
    cfg, jp, tp, _ = setup
    prompt = [1, 5, 77, 300]
    steps = 20
    runs = []
    for _ in range(2):
        eng = InferenceEngine(tp, cfg, None, temperature=temperature,
                              topp=topp, seed=4242, device="cpu",
                              chunk_size=6)
        eng._consume_coins(len(prompt) - 1)  # as generate() does
        token = torch.tensor([prompt[-1]], dtype=torch.int32)
        eng._prefill(prompt[:-1])
        toks, _ = eng._decode_tokens(token, steps, stop_at_eos=False)
        runs.append(toks)
    assert runs[0] == runs[1]
    assert runs[0] == _jax_replay(cfg, jp, prompt, steps,
                                  temperature=temperature, topp=topp,
                                  seed=4242)


def _write_model(tmp_path, cfg):
    path = str(tmp_path / "model.bin")
    t_save(path, t_random(cfg, seed=5))
    tok_path = str(tmp_path / "tok.bin")
    write_toy_tokenizer(tok_path, _toy_vocab(cfg.vocab_size))
    return path, tok_path


def test_cli_generate_on_cpu(tmp_path, tiny_config, capsys):
    path, tok_path = _write_model(tmp_path, tiny_config)
    args = [path, "-n", "12", "-i", "the cat", "-t", "0", "-s", "3", "-z",
            tok_path, "--device", "cpu"]
    assert t_main(args) == 0
    out = capsys.readouterr().out
    assert "achieved tok/s" in out
    # the same greedy run twice prints the same text
    assert t_main(args) == 0
    again = capsys.readouterr().out
    strip = [ln for ln in out.splitlines() if "tok/s" not in ln]
    assert strip == [ln for ln in again.splitlines() if "tok/s" not in ln]


def test_cli_chat_on_cpu(tmp_path, tiny_config, capsys, monkeypatch):
    path, tok_path = _write_model(tmp_path, tiny_config)
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))  # EOF after turn 1
    assert t_main([path, "-m", "chat", "-i", "the cat", "-y", "be brief",
                   "-t", "0", "-z", tok_path, "--device", "cpu"]) == 0
    reply = capsys.readouterr().out.split("Assistant: ", 1)[1]
    assert reply.split("\nUser: ")[0].strip()


@pytest.mark.parametrize("extra", [["-m", "perplexity"], ["--spec", "ngram"],
                                   ["--kv-bits", "4"], ["--tp", "2"],
                                   ["--attn-impl", "batched"]])
def test_cli_unported_options_raise(tmp_path, tiny_config, extra):
    path, tok_path = _write_model(tmp_path, tiny_config)
    with pytest.raises(NotImplementedError):
        t_main([path, "-z", tok_path, "--device", "cpu", *extra])


def test_batch_engine_not_ported_yet(setup):
    from llama_cu_awq_torch.engine.batch import BatchEngine

    cfg, _, tp, _ = setup
    with pytest.raises(NotImplementedError):
        BatchEngine(tp, cfg)
