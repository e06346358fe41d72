"""Single-sequence inference engine: generate and chat.

The counterpart of llama_cu_awq_tpu/engine/engine.py. Each decode chunk is
a Python loop of forward + sample steps in which the sampled token stays on
the device and feeds the next step's embedding lookup; the chunk's coins
are one device tensor, and the host syncs once per chunk, when it reads the
chunk's tokens (the role the JAX package's lax.scan chunk plays). Prompts
are fed through the same T=1 path, teacher-forced and without the lm_head
(the reference's token-by-token prefill). The xorshift coin stream and the
reference's one-step print lag follow the JAX engine exactly.
"""

from __future__ import annotations

import sys
import time

import torch

from llama_cu_awq_torch.config import ModelConfig
from llama_cu_awq_torch.device import resolve_device
from llama_cu_awq_torch.models.llama import (LlamaParams, forward,
                                             init_kv_cache)
from llama_cu_awq_torch.sampling import XorshiftRNG, sample_token
from llama_cu_awq_torch.tokenizer import EOS_TOKEN, Tokenizer


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
                 spec: str | None = None, device="cuda"):
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params are on {params.device}, the engine "
                             f"runs on {self.device}")
        if spec is not None:
            raise NotImplementedError("speculative decoding (--spec) is "
                                      "not ported yet")
        if kv_quant == 4:
            raise NotImplementedError("the int4 KV cache (--kv-bits 4) is "
                                      "not ported yet")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.attn_impl = attn_impl if attn_impl is not None else "auto"
        self.kv_quant = bool(kv_quant)
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
                             quantized=self.kv_quant, device=self.device)

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

    def _prefill(self, tokens: list[int]) -> None:
        """Feed prompt tokens one by one, teacher-forced, without the
        lm_head; only the cache matters (callers seed decoding with the
        last prompt token)."""
        assert tokens
        attn_len = self._bucket_for(self.pos + len(tokens))
        toks = torch.tensor(tokens, dtype=torch.int32, device=self.device)
        positions = self._positions(len(tokens))
        for i in range(len(tokens)):
            forward(self.params, self.cfg, toks[i:i + 1, None],
                    positions[i:i + 1], self.cache, attn_len=attn_len,
                    attn_impl=self.attn_impl, no_logits=True)
        self.pos += len(tokens)

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
        generated, hit_eos = self._decode_tokens(token, steps - n_pref + 1)

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

        self._decode_tokens(token, budget, on_token=emit)
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
