"""Single-sequence inference engine: generate and chat.

The counterpart of llama_cu_awq_tpu/engine/engine.py. Each decode chunk is
a Python loop of forward + sample steps in which the sampled token stays on
the device and feeds the next step's embedding lookup; the chunk's coins
are one device tensor, and the host syncs once per chunk, when it reads the
chunk's tokens (the role the JAX package's lax.scan chunk plays). Prompts
of PREFILL_BLOCK // 2 tokens and more go through blocks of PREFILL_BLOCK
tokens, one forward each (the JAX package's per-block loop; its scanned
multi-block prefill has no counterpart yet); shorter ones through the T=1
path, teacher-forced and without the lm_head (the reference's
token-by-token prefill). The xorshift coin stream and the reference's
one-step print lag follow the JAX engine exactly.

Speculative decoding (spec="ngram", the JAX engine's prompt lookup):
propose_ngram takes the spec_k tokens that followed the latest earlier
occurrence of the history's trailing n-gram, one teacher-forced forward
over [last token, proposal] gives the model's choice at every position,
and the longest agreeing prefix plus the model's token at the first
mismatch is emitted: the plain stream, up to spec_k + 1 tokens for one
pass over the weights. Sampled verify positions use the coins plain
decode would draw there (peeked, then consumed only for emitted tokens).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from llama_cu_awq_torch.config import ModelConfig
from llama_cu_awq_torch.device import resolve_device
from llama_cu_awq_torch.models.llama import (LlamaParams, forward,
                                             init_kv_cache)
from llama_cu_awq_torch.sampling import XorshiftRNG, sample_token
from llama_cu_awq_torch.tokenizer import EOS_TOKEN, Tokenizer

# teacher-forced prefill block width (the JAX engine's PREFILL_BLOCK)
PREFILL_BLOCK = 128


def propose_ngram(hist, k: int, ns=(3, 2)) -> list[int] | None:
    """The k tokens that followed the most recent earlier occurrence of
    the trailing n-gram of hist (the largest n in ns first), padded by
    repeating the last when the match lands near the end; None without a
    match. Host-side numpy, O(len(hist)) a call."""
    h = np.asarray(hist, np.int32)
    for n in ns:
        if len(h) <= n:
            continue
        win = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
        hits = np.nonzero((win == h[-n:]).all(axis=1))[0]
        if hits.size:
            s = int(hits[-1]) + n
            prop = [int(t) for t in h[s:s + k]]
            if prop:
                # a padded token is emitted only if the model agrees
                return prop + [prop[-1]] * (k - len(prop))
    return None


def attn_buckets(seq_len: int, first: int = 128, n_bins: int = 8):
    """Seq-len bins like the reference's graph bins (llama2_q4.cu:354-360)."""
    bins = []
    b = first
    for _ in range(n_bins - 1):
        if b >= seq_len:
            break
        bins.append(b)
        b *= 2
    bins.append(seq_len)
    return bins


class InferenceEngine:
    def __init__(self, params: LlamaParams, cfg: ModelConfig,
                 tokenizer: Tokenizer | None = None, *,
                 attn_impl: str | None = None, kv_quant: bool | int = False,
                 max_seq: int | None = None, temperature: float = 0.5,
                 topp: float = 0.6, seed: int = 0, chunk_size: int = 16,
                 spec: str | None = None, spec_k: int = 7, device="cuda"):
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params are on {params.device}, the engine "
                             f"runs on {self.device}")
        if spec not in (None, "ngram"):
            raise ValueError(f"unknown spec mode {spec!r} "
                             "(supported: 'ngram')")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.attn_impl = attn_impl if attn_impl is not None else "auto"
        # kv_quant: False -> bf16 cache, True or 8 -> int8, 4 -> int4
        self.kv_quant = bool(kv_quant)
        self.kv_bits = 4 if kv_quant == 4 else 8
        self.spec = spec
        self.spec_k = spec_k
        self.spec_stats = {"proposed": 0, "accepted": 0, "verifies": 0}
        self._hist: list[int] = []  # prompt and emitted tokens (spec)
        self.max_seq = max_seq or cfg.seq_len
        self.temperature = temperature
        self.topp = topp
        self.rng = XorshiftRNG(seed)
        self.chunk_size = chunk_size
        self._buckets = attn_buckets(self.max_seq)
        self.cache = self._init_cache()
        self.pos = 0  # persists across chat turns (llama2_q4.cu:526-527)

    def _init_cache(self):
        return init_kv_cache(self.cfg, 1, self.max_seq,
                             quantized=self.kv_quant, kv_bits=self.kv_bits,
                             device=self.device)

    def _bucket_for(self, seq: int) -> int:
        for b in self._buckets:
            if seq <= b:
                return b
        return self._buckets[-1]

    def _positions(self, n: int) -> torch.Tensor:
        return torch.arange(self.pos, self.pos + n, dtype=torch.int32,
                            device=self.device)

    def _decode_chunk(self, token: torch.Tensor, coins: torch.Tensor,
                      attn_len: int) -> torch.Tensor:
        """len(coins) sampled steps from self.pos; token (1,) on the device.
        Returns the (k, 1) sampled tokens, still on the device."""
        positions = self._positions(coins.shape[0])
        toks = []
        for i in range(coins.shape[0]):
            logits, _ = forward(self.params, self.cfg, token[:, None],
                                positions[i:i + 1], self.cache,
                                attn_len=attn_len, attn_impl=self.attn_impl)
            nxt = sample_token(logits, coins[i], self.temperature, self.topp)
            # garbage-token clamp (llama2_q4.cu:474)
            token = torch.where(nxt >= self.cfg.vocab_size,
                                torch.zeros_like(nxt), nxt)
            toks.append(token)
        return torch.stack(toks)

    def _coins(self, k: int) -> torch.Tensor:
        return torch.tensor([[self.rng.random_f32()] for _ in range(k)],
                            dtype=torch.float32, device=self.device)

    def reset(self):
        self.cache = self._init_cache()
        self.pos = 0
        self._hist = []

    def _prefill(self, tokens: list[int], *, collect_logits: bool = False):
        """Feed prompt tokens at the current position (the JAX engine's
        _prefill, engine.py:496-580).

        Fewer than PREFILL_BLOCK // 2 tokens without collect_logits: one
        teacher-forced T=1 step each, without the lm_head; returns None
        (callers seed decoding with the last prompt token). Otherwise
        blocks of PREFILL_BLOCK tokens, the last one padded with token 0
        (the mask keeps real rows from reading the padded rows' cache
        writes, which later steps overwrite), or single steps where a
        block would pass max_seq. Only the last block runs the lm_head (the
        JAX engine's scan takes the earlier blocks without it), every block
        with collect_logits. Returns the last token's f32 logits (vocab,)
        on the device, or with collect_logits the (len(tokens), vocab) f32
        rows on the host, moved one block at a time.
        """
        assert tokens
        self._hist.extend(tokens)
        if not collect_logits and len(tokens) < PREFILL_BLOCK // 2:
            attn_len = self._bucket_for(self.pos + len(tokens))
            toks = torch.tensor(tokens, dtype=torch.int32,
                                device=self.device)
            positions = self._positions(len(tokens))
            for i in range(len(tokens)):
                forward(self.params, self.cfg, toks[i:i + 1, None],
                        positions[i:i + 1], self.cache, attn_len=attn_len,
                        attn_impl=self.attn_impl, no_logits=True)
            self.pos += len(tokens)
            return None
        rows, last, i = [], None, 0
        while i < len(tokens):
            chunk = tokens[i:i + PREFILL_BLOCK]
            block = 1 if len(chunk) == 1 else PREFILL_BLOCK
            if self.pos + block > self.max_seq:
                block, chunk = 1, tokens[i:i + 1]
            padded = torch.tensor([chunk + [0] * (block - len(chunk))],
                                  dtype=torch.int32, device=self.device)
            # the lm_head runs on the prompt's last block only, or on every
            # block for collect_logits (perplexity)
            head = collect_logits or i + len(chunk) == len(tokens)
            logits, _ = forward(self.params, self.cfg, padded,
                                self._positions(1), self.cache,
                                attn_len=self._bucket_for(self.pos + block),
                                attn_impl=self.attn_impl, logits_all=head,
                                no_logits=not head)
            if collect_logits:
                rows.append(logits[0, :len(chunk)].cpu())
            if head:
                last = logits[0, len(chunk) - 1]
            self.pos += len(chunk)
            i += len(chunk)
        return torch.cat(rows) if collect_logits else last

    def _consume_coins(self, n: int):
        """One xorshift coin per teacher-forced step (sampler.h:45)."""
        for _ in range(n):
            self.rng.random_f32()

    def _clamp_steps(self, steps):
        if not steps or steps <= 0 or steps > self.cfg.seq_len:
            return self.cfg.seq_len
        return steps

    # ------------------------------------------------------------------
    # generate mode (llama2_q4.cu:436-492)

    def generate(self, prompt: str, steps: int | None = None,
                 on_piece=None, echo: bool = True):
        """Greedy/sampled generation. Returns (text, stats dict)."""
        tok = self.tokenizer
        prompt_tokens = tok.encode(prompt or "", bos=True, eos=False)
        if not prompt_tokens:
            raise ValueError("expected at least 1 prompt token")
        steps = self._clamp_steps(steps)

        self.reset()
        start = time.time()
        n_pref = min(len(prompt_tokens), steps)
        consumed = 0
        if n_pref > 1:
            self._prefill(prompt_tokens[:n_pref - 1])
            self._consume_coins(n_pref - 1)
            consumed = n_pref - 1
        pieces = []
        if echo:
            # the reference echoes prompt tokens as it processes them
            for i in range(1, n_pref):
                piece = tok.safe_piece(
                    tok.decode(prompt_tokens[i - 1], prompt_tokens[i]))
                if on_piece:
                    on_piece(piece)
                pieces.append(piece)

        prev_token = prompt_tokens[n_pref - 1]
        token = torch.tensor([prev_token], dtype=torch.int32,
                             device=self.device)
        generated, hit_eos = self._decode_auto(token, steps - n_pref + 1)

        # the reference prints the token from the previous iteration, so the
        # final generated token is never printed unless EOS stopped it
        to_print = generated if hit_eos else generated[:-1]
        n_gen = 0
        for nxt in to_print:
            piece = tok.safe_piece(tok.decode(prev_token, nxt))
            if on_piece:
                on_piece(piece)
            pieces.append(piece)
            n_gen += 1
            prev_token = nxt

        dt = time.time() - start
        timed = consumed + len(generated) - 1
        stats = {"tokens": timed, "seconds": dt,
                 "tok_per_s": timed / dt if dt > 0 else float("inf"),
                 "generated": n_gen}
        return "".join(pieces), stats

    def _decode_tokens(self, token: torch.Tensor, max_steps: int,
                       stop_at_eos: bool = True, on_token=None):
        """Up to max_steps sampled steps in device chunks, one host sync per
        chunk. Returns (tokens list, hit_eos). On a mid-chunk EOS the
        xorshift stream is rewound so exactly one coin per executed step is
        consumed; cache rows written past EOS sit beyond self.pos and are
        overwritten before any later read."""
        generated: list[int] = []
        done = 0
        while done < max_steps:
            if self.pos >= self.max_seq:
                break  # cache full
            k = min(self.chunk_size, max_steps - done,
                    self.max_seq - self.pos)
            snapshot = self.rng.state
            coins = self._coins(k)
            toks = self._decode_chunk(token, coins,
                                      self._bucket_for(self.pos + k))
            host = toks[:, 0].tolist()  # the per-chunk host sync point
            if stop_at_eos and EOS_TOKEN in host:
                used = host.index(EOS_TOKEN) + 1
                self.rng.state = snapshot  # one coin per executed step
                self._consume_coins(used)
                new = host[:used]
                generated.extend(new)
                if on_token:
                    on_token(new)
                self.pos += used
                return generated, True
            generated.extend(host)
            if on_token:
                on_token(host)
            self.pos += k
            done += k
            token = toks[-1]
        return generated, False

    # ------------------------------------------------------------------
    # speculative decoding (the JAX engine's engine.py:343-453,483-494)

    def _decode_auto(self, token: torch.Tensor, max_steps: int,
                     stop_at_eos: bool = True, on_token=None):
        """The speculative loop when spec is on, else the plain chunks."""
        if self.spec:
            self._hist.append(int(token[0]))
            return self._decode_tokens_spec(token, max_steps,
                                            stop_at_eos=stop_at_eos,
                                            on_token=on_token)
        return self._decode_tokens(token, max_steps, stop_at_eos=stop_at_eos,
                                   on_token=on_token)

    def _spec_verify(self, tokens: list[int], coins: torch.Tensor,
                     attn_len: int) -> list[int]:
        """One teacher-forced forward over [last, p_1..p_k] at self.pos:
        out[t] is the model's token after consuming p_1..p_t (argmax at
        temperature 0, else the sampler on coins[t]). Cache rows written
        past what is later accepted lie beyond the rolled-back position
        and are overwritten before any step reads them."""
        toks = torch.tensor([tokens], dtype=torch.int32, device=self.device)
        logits, _ = forward(self.params, self.cfg, toks, self._positions(1),
                            self.cache, attn_len=attn_len,
                            attn_impl=self.attn_impl, logits_all=True)
        if self.temperature == 0.0:
            out = torch.argmax(logits, dim=-1)
        else:
            out = sample_token(logits, coins, self.temperature, self.topp)
        return out[0].tolist()  # the host sync of a verify

    def _decode_tokens_spec(self, token: torch.Tensor, max_steps: int,
                            stop_at_eos: bool = True, on_token=None):
        """Speculative _decode_tokens (B=1): the same token stream, one
        host sync per verify, or short plain chunks while nothing
        matches. Returns (tokens list, hit_eos)."""
        generated: list[int] = []
        last = int(token[0])
        while len(generated) < max_steps:
            k = self.spec_k
            prop = (propose_ngram(self._hist, k)
                    if self.pos + k + 1 <= self.max_seq else None)
            if prop is None:
                # a short plain chunk, so the n-gram check comes back
                # every spec_k steps
                budget = min(k, self.chunk_size, max_steps - len(generated))
                new, hit = self._decode_tokens(
                    torch.tensor([last], dtype=torch.int32,
                                 device=self.device), budget,
                    stop_at_eos=stop_at_eos, on_token=on_token)
                generated.extend(new)
                self._hist.extend(new)
                if hit or not new:
                    return generated, hit
                last = new[-1]
                continue
            if self.temperature > 0.0:
                # peek the next k+1 coins without consuming them: coin t
                # is the one plain decode draws at emitted step t
                saved = self.rng.state
                coins = self._coins(k + 1).T
                self.rng.state = saved
            else:
                coins = torch.zeros(1, k + 1, device=self.device)
            out = self._spec_verify([last] + prop, coins,
                                    self._bucket_for(self.pos + k + 1))
            m = 0
            while m < k and out[m] == prop[m]:
                m += 1
            self.spec_stats["proposed"] += k
            self.spec_stats["accepted"] += m
            self.spec_stats["verifies"] += 1
            emitted = out[:m + 1][:max_steps - len(generated)]
            hit = stop_at_eos and EOS_TOKEN in emitted
            if hit:
                emitted = emitted[:emitted.index(EOS_TOKEN) + 1]
            self.pos += len(emitted)
            self._consume_coins(len(emitted))
            generated.extend(emitted)
            self._hist.extend(emitted)
            if on_token:
                on_token(emitted)
            if hit:
                return generated, True
            last = emitted[-1]
        return generated, False

    def generate_benchmark(self, prompt_tokens: list[int], steps: int):
        """Timed generation without per-chunk host syncs or text decoding:
        prompt + device-chained decode chunks, one host read at the end.
        Returns (tokens, seconds, tok_per_s) with the reference's
        timed-token accounting (llama2_q4.cu:486-489)."""
        self.reset()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        start = time.time()
        n_pref = min(len(prompt_tokens), steps)
        if n_pref > 1:
            self._prefill(prompt_tokens[:n_pref - 1])
        token = torch.tensor([prompt_tokens[n_pref - 1]], dtype=torch.int32,
                             device=self.device)
        if self.spec:
            # the same accounting: the loop emits steps - n_pref + 1 tokens
            tokens, _ = self._decode_auto(token, steps - n_pref + 1,
                                          stop_at_eos=False)
            dt = time.time() - start
            return tokens, dt, (steps - 1) / dt
        outs = []
        remaining = steps - n_pref + 1
        while remaining > 0 and self.pos < self.max_seq:
            k = min(self.chunk_size, remaining, self.max_seq - self.pos)
            toks = self._decode_chunk(token, self._coins(k),
                                      self._bucket_for(self.pos + k))
            outs.append(toks)
            token = toks[-1]
            self.pos += k
            remaining -= k
        tokens = torch.cat(outs)[:, 0].tolist()
        dt = time.time() - start
        return tokens, dt, (steps - 1) / dt

    # ------------------------------------------------------------------
    # chat mode (llama2_q4.cu:507-601)

    def chat_turn(self, user_prompt: str, system_prompt: str | None = None,
                  steps: int | None = None, on_piece=None) -> str:
        """One assistant reply; KV cache and position persist across turns."""
        tok = self.tokenizer
        steps = self._clamp_steps(steps)
        if self.pos == 0 and system_prompt:
            rendered = (f"[INST] <<SYS>>\n{system_prompt}\n<</SYS>>\n\n"
                        f"{user_prompt} [/INST]")
        else:
            rendered = f"[INST] {user_prompt} [/INST]"
        prompt_tokens = tok.encode(rendered, bos=True, eos=False)

        if self.pos + len(prompt_tokens) + 1 >= min(steps, self.max_seq):
            return ""  # context exhausted

        if len(prompt_tokens) > 1:
            self._prefill(prompt_tokens[:-1])
        self._consume_coins(len(prompt_tokens) - 1)
        token = torch.tensor([prompt_tokens[-1]], dtype=torch.int32,
                             device=self.device)
        pieces = []
        budget = min(steps, self.max_seq) - 1 - self.pos
        state = {"prev": prompt_tokens[-1]}

        def emit(new_tokens):
            for nxt in new_tokens:
                if nxt == EOS_TOKEN:
                    return
                piece = tok.safe_piece(tok.decode(state["prev"], nxt))
                if on_piece:
                    on_piece(piece)
                pieces.append(piece)
                state["prev"] = nxt

        self._decode_auto(token, budget, on_token=emit)
        return "".join(pieces)

    def chat_loop(self, cli_user_prompt=None, cli_system_prompt=None,
                  steps=None, input_fn=input, print_fn=None):
        """Interactive chat REPL (llama2_q4.cu:529-601)."""
        if print_fn is None:
            def print_fn(s, end="\n"):
                print(s, end=end)
                sys.stdout.flush()

        first = True
        while True:
            if first and cli_system_prompt is None:
                system_prompt = input_fn("Enter system prompt (optional): ")
            else:
                system_prompt = cli_system_prompt if first else None
            if first and cli_user_prompt is not None:
                user_prompt = cli_user_prompt
            else:
                try:
                    user_prompt = input_fn("User: ")
                except EOFError:
                    return
            first = False
            print_fn("Assistant: ", end="")
            self.chat_turn(user_prompt, system_prompt, steps,
                           on_piece=lambda p: print_fn(p, end=""))
            print_fn("")
            if self.pos >= min(self._clamp_steps(steps), self.max_seq) - 1:
                return
