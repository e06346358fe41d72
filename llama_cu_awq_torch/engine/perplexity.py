"""Perplexity evaluation (the counterpart of
llama_cu_awq_tpu/engine/perplexity.py, itself the reference's
perplexity.h protocol).

The dataset is split on "<|endoftext|>"; each sequence is encoded without
BOS/EOS, truncated to min(seq_len, the engine's max_seq) - 1 tokens (what
the engine's cache holds: the JAX engine truncates to seq_len - 1 alone,
and its cache writes clamp silently past a smaller max_seq), prefixed
with BOS and teacher-forced through the network in prefill blocks; row i
of the logits predicts token i. A sequence scores exp(-mean(log p(token_i
| prefix))) with an f32 softmax per row and f64 log accumulation; the
dataset score is the geometric mean over sequences.
"""

from __future__ import annotations

import numpy as np

from llama_cu_awq_torch.tokenizer import BOS_TOKEN

END_OF_TEXT = "<|endoftext|>"


def _softmax_f32(row: np.ndarray) -> np.ndarray:
    row = row.astype(np.float32)
    row = np.exp(row - row.max())
    return row / row.sum()


def token_perplexity(engine, data_tokens: list[int],
                     verbose: bool = False) -> float:
    """Perplexity of one encoded sequence (perplexity.h:57-96); NaN for
    an empty one. Needs no tokenizer."""
    n = len(data_tokens)
    limit = min(engine.cfg.seq_len, engine.max_seq)
    if n >= limit:
        n = limit - 1
        if verbose:
            print(f"\nTruncated to {n} tokens", flush=True)
    if n == 0:
        return float("nan")
    engine.reset()
    # inputs: [BOS] + data[:n-1]; row i predicts data[i]
    inputs = [BOS_TOKEN] + list(data_tokens[:n - 1])
    logits = engine._prefill(inputs, collect_logits=True).numpy()
    total = 0.0  # f64 accumulation (perplexity.h:29)
    for i in range(n):
        probs = _softmax_f32(logits[i])
        total += float(np.log(np.float64(probs[data_tokens[i]])))
    return float(np.exp(-total / n))


def sequence_perplexity(engine, text: str, verbose: bool = False) -> float:
    """Perplexity of one text sequence, encoded without BOS/EOS."""
    data_tokens = engine.tokenizer.encode(text, bos=False, eos=False)
    return token_perplexity(engine, data_tokens, verbose)


def dataset_perplexity(engine, dataset_text: str, verbose: bool = False):
    """Split on <|endoftext|> and take the geometric mean of the sequence
    perplexities (perplexity.h:99-139); empty sequences are skipped.
    Returns (geomean, count, per-sequence list)."""
    values = []
    for seq in dataset_text.split(END_OF_TEXT):
        p = sequence_perplexity(engine, seq, verbose)
        if np.isfinite(p):
            values.append(p)
            if verbose:
                print(f"\nPerplexity computed: {p:f}", flush=True)
    if not values:
        return float("nan"), 0, []
    log_mean = np.mean([np.log(v) for v in values])
    return float(np.exp(log_mean)), len(values), values
