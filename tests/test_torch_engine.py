"""The port's engine and CLI on the CPU, held to a stepwise JAX replay.

The JAX engine on the CPU runs its unfused path (models/llama.py:547-550),
which rounds differently from the fused path the port runs, so the oracle
is the JAX forward(fused=True, matmul_impl="dequant") stepped with the
engine's schedule: the prompt teacher-forced at T=1 (one xorshift coin
burnt per prompt step), then each sampled token fed back. Token streams
must be identical.
"""

import functools
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
from llama_cu_awq_tpu.config import ModelConfig
from llama_cu_awq_tpu.engine.engine import attn_buckets as j_attn_buckets
from llama_cu_awq_tpu.io.checkpoint import random_checkpoint
from llama_cu_awq_tpu.models import llama as jl
from llama_cu_awq_tpu.sampling import XorshiftRNG, sample_token
from llama_cu_awq_tpu.tokenizer import Tokenizer as JTokenizer
from tests.test_tokenizer import write_toy_tokenizer

# one intra-op thread per process: the suite runs in several worker
# processes, and torch's default pool in each oversubscribes the cores
# (tens of times slower on small tensors); it also fixes the CPU sum order
torch.set_num_threads(1)


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


def _write_model(tmp_path, cfg, seed=5):
    path = str(tmp_path / "model.bin")
    t_save(path, t_random(cfg, seed=seed))
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


def test_cli_perplexity_on_cpu(tmp_path, tiny_config, capsys, monkeypatch):
    """-m perplexity -q: the port's CLI and the JAX CLI (its engine bound
    to the fused forward the port runs, as _jax_replay steps it) print the
    same sequence count and perplexities that agree to f32 sum order."""
    from llama_cu_awq_tpu.cli import main as j_main
    from llama_cu_awq_tpu.engine import engine as j_engine_mod

    path, tok_path = _write_model(tmp_path, tiny_config)
    data = tmp_path / "data.txt"
    # three sequences, the last longer than seq_len (truncated)
    data.write_text("the cat sat on the mat<|endoftext|>a cat<|endoftext|>"
                    + "the cat sat " * 40)
    args = [path, "-m", "perplexity", "-q", str(data), "-z", tok_path]

    def geomean_line():
        out = capsys.readouterr().out
        (line,) = [ln for ln in out.splitlines()
                   if ln.startswith("Geomean perplexity on ")]
        assert "Truncated to 95 tokens" in out
        head, value = line.rsplit(" ", 1)
        return head, float(value)

    assert t_main([*args, "--device", "cpu"]) == 0
    t_head, t_val = geomean_line()
    monkeypatch.setattr(j_engine_mod, "forward",
                        functools.partial(jl.forward, fused=True))
    assert j_main(args) == 0
    j_head, j_val = geomean_line()
    assert t_head == j_head == "Geomean perplexity on 3 sequences:"
    assert t_val == pytest.approx(j_val, rel=1e-4)


def test_cli_perplexity_past_max_seq(tmp_path, tiny_config, capsys):
    """-m perplexity --max-seq N on a sequence longer than N scores its
    first N - 1 tokens and prints the geometric mean line."""
    path, tok_path = _write_model(tmp_path, tiny_config)
    data = tmp_path / "data.txt"
    data.write_text("the cat sat on the mat<|endoftext|>"
                    + "the cat sat " * 40)
    assert t_main([path, "-m", "perplexity", "-q", str(data), "-z",
                   tok_path, "--max-seq", "40", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Truncated to 39 tokens" in out
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith("Geomean perplexity on 2 sequences: ")]
    assert np.isfinite(float(line.rsplit(" ", 1)[1]))


def test_cli_perplexity_needs_dataset(tmp_path, tiny_config, capsys):
    path, tok_path = _write_model(tmp_path, tiny_config)
    assert t_main([path, "-m", "perplexity", "-z", tok_path,
                   "--device", "cpu"]) == 1
    assert "perplexity mode requires -q" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [["--tp", "2"]])
def test_cli_unported_options_raise(tmp_path, tiny_config, extra):
    """The options the port refuses raise before any work: --tp 2 on
    tiny_config (dim 64) would give each rank 16 of kv_dim's inputs and
    cut wo's 128-row groups, which the port refuses
    (parallel/tp.py _check_divisible) before it starts a rank."""
    path, tok_path = _write_model(tmp_path, tiny_config)
    with pytest.raises(ValueError, match="multiple of 128"):
        t_main([path, "-z", tok_path, "--device", "cpu", *extra])


# head_dim 128 and a 256-row cache: every kernel of the JAX forward takes
# these shapes (its batched kernel in interpret mode), and so does the
# port's batched kernel, which would refuse head_dim 16
CLI_CFG = ModelConfig(dim=256, hidden_dim=384, n_layers=2, n_heads=2,
                      n_kv_heads=1, vocab_size=512, seq_len=256)
# the streams are compared token for token, so the random model is fixed:
# one whose greedy margins stay above the two packages' bf16 rounding for
# these runs (seed 5's batched run meets a near-tie at its fifth step)
CLI_SEED = 7


@pytest.mark.parametrize("mode,extra", [
    ("generate", ["--kv-bits", "4"]),
    ("generate", ["--attn-impl", "batched"]),
    ("generate", ["--attn-impl", "batched_static", "--kv-quant"]),
    ("generate", ["--spec", "ngram", "--spec-k", "4"]),
    ("chat", ["--spec", "ngram", "--kv-bits", "4"]),
    ("perplexity", ["--kv-bits", "4"]),
    ("generate", ["--profile", "{tmp}/trace"]),
])
def test_cli_options_match_jax(tmp_path, capsys, monkeypatch, mode, extra):
    """The port's CLI and the JAX CLI (its engine bound to the fused
    forward the port runs) print the same text, spec line and sequence
    count; perplexities agree to f32 sum order. Greedy, fixed seeds.
    ("{tmp}" in an option stands for the test's directory.)"""
    from llama_cu_awq_tpu.cli import main as j_main
    from llama_cu_awq_tpu.engine import engine as j_engine_mod

    extra = [a.format(tmp=tmp_path) for a in extra]
    path, tok_path = _write_model(tmp_path, CLI_CFG, seed=CLI_SEED)
    args = [path, "-m", mode, "-z", tok_path, "-t", "0", "-s", "3", *extra]
    if mode == "perplexity":
        data = tmp_path / "data.txt"
        data.write_text("the cat sat on the mat<|endoftext|>"
                        + "the cat sat " * 30)
        args += ["-q", str(data)]
    else:
        args += ["-n", "60", "-i", "the cat sat on the mat the cat sat on"]
    if mode == "chat":
        args += ["-y", "be brief"]
        monkeypatch.setattr(sys, "stdin", io.StringIO(""))  # one turn

    def lines():
        out = capsys.readouterr().out
        return [ln for ln in out.splitlines() if "tok/s" not in ln]

    assert t_main([*args, "--device", "cpu"]) == 0
    got = lines()
    monkeypatch.setattr(j_engine_mod, "forward",
                        functools.partial(jl.forward, fused=True))
    assert j_main(args) == 0
    want = lines()
    if mode == "perplexity":
        (t_line,) = [ln for ln in got if ln.startswith("Geomean")]
        (j_line,) = [ln for ln in want if ln.startswith("Geomean")]
        assert t_line.rsplit(" ", 1)[0] == j_line.rsplit(" ", 1)[0]
        assert float(t_line.rsplit(" ", 1)[1]) == pytest.approx(
            float(j_line.rsplit(" ", 1)[1]), rel=1e-3)
        return
    assert got == want
    if "--spec" in extra and mode == "generate":
        (spec_line,) = [ln for ln in got if ln.startswith("spec: ")]
        assert " 0/" not in spec_line  # proposals were accepted


def test_batch_engine_not_ported_yet(setup):
    """BatchEngine defaults to the card and raises without one, like every
    entry point of the port; with device="cpu" it serves
    (tests/test_torch_batch.py holds it to the JAX engine)."""
    from llama_cu_awq_torch.engine.batch import BatchEngine

    cfg, _, tp, _ = setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BatchEngine(tp, cfg)
    be = BatchEngine(tp, cfg, device="cpu", max_seq=64)
    rid = be.submit([1, 5, 9], max_new=3)
    assert len(be.run()[rid]) == 3
