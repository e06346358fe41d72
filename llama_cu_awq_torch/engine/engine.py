"""Single-sequence inference engine: generate and chat.

The counterpart of llama_cu_awq_tpu/engine/engine.py, with the
counterparts of its device-resident loops and its speculative verify. The step state lives on
the device in buffers of fixed address: the next position (_pos_buf),
the step's index (_idx) into the chunk's coins and tokens or into the
staged prompt, and the next input token (_tok). A step body computes
everything from them and advances them on the device:
- a decode step (_decode_body, the body of _decode_chunk_fn's scan)
  forwards _tok at _pos_buf, samples with coin _coin_buf[_idx], clamps
  the token and writes it to _out[_idx] and to _tok;
- a prompt step (_prompt_body) forwards _prompt_buf[_idx:_idx + T] at
  _pos_buf: T = 1 without the lm_head is the body of _forced_chunk_fn's
  scan (prompts of fewer than PREFILL_BLOCK // 2 tokens), T =
  PREFILL_BLOCK the body of _prefill_scan_fn's (blocks of a longer
  prompt, the last padded with token 0); with the head, the logits go to
  _logits;
- a verify (_verify_body, the body of _spec_verify_fn) is a prompt step
  with the head over [last token, proposal], then the argmax or the
  sampler on the peeked coins of _coin_buf, into _out[:T].
On the card each body is a CUDA graph (engine/graphs.py), captured once
per kind, block width, attention window and forward's plan
(models/llama.plan), and replayed once a step, block or verify: a chunk
of k steps is k replays of one graph, so a short last chunk, an EOS
rewind and the max_seq clamp take the graphs every full chunk takes. Each block
replays at its own window, as the JAX package's per-block loop does (its
scan widens the window to the chunk's end). On the CPU the same bodies
run eagerly, and `capture=False` runs them so on the card. The host syncs
once per chunk, where it reads the chunk's tokens. The xorshift coin
stream and the reference's one-step print lag follow the JAX engine.

Under a running profiler (utils/profiling.py) a request of generate or
generate_benchmark is the span seq.request, holding seq.reset, seq.prompt
(_prefill), seq.decode (a chunk's dispatch) and seq.wait (every host
sync: a chunk's tokens, a staging slot, the card before the clock).

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

import functools
import sys
import time

import numpy as np
import torch

from llama_cu_awq_torch.config import ModelConfig
from llama_cu_awq_torch.device import resolve_device
from llama_cu_awq_torch.engine.graphs import GraphSet
from llama_cu_awq_torch.models.llama import (LlamaParams, forward,
                                             init_kv_cache, plan)
from llama_cu_awq_torch.ops.cuda.attention_step import reserve_split_scratch
from llama_cu_awq_torch.parallel.mesh import TPGroup
from llama_cu_awq_torch.parallel.tp import tp_init_kv_cache
from llama_cu_awq_torch.sampling import XorshiftRNG, sample_token
from llama_cu_awq_torch.tokenizer import EOS_TOKEN, Tokenizer
from llama_cu_awq_torch.utils.profiling import span

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


class _Stage:
    """Host values on their way to a device buffer: on the card through
    pinned memory and a copy that does not block the host. A slot is
    written again only after the copy that read it has run (an event), so
    chunks chained without a host sync never see their inputs change.
    `wait` names the span of that wait."""

    def __init__(self, n: int, dtype, device: torch.device, slots: int,
                 wait: str = "seq.wait"):
        pin = device.type == "cuda"
        self.wait = wait
        self.host = [torch.zeros(n, dtype=dtype, pin_memory=pin)
                     for _ in range(slots)]
        self.done = [torch.cuda.Event() if pin else None
                     for _ in range(slots)]
        self.slot = 0

    def put(self, values, dst: torch.Tensor) -> None:
        """dst[:len(values)] = values (a list or a numpy array), in stream
        order."""
        s = self.slot
        self.slot = (s + 1) % len(self.host)
        if self.done[s] is not None:
            with span(self.wait):
                self.done[s].synchronize()
        src = self.host[s][:len(values)]
        src.copy_(torch.as_tensor(values, dtype=src.dtype))
        dst[:len(values)].copy_(src, non_blocking=True)
        if self.done[s] is not None:
            self.done[s].record()


class InferenceEngine:
    def __init__(self, params: LlamaParams, cfg: ModelConfig,
                 tokenizer: Tokenizer | None = None, *,
                 attn_impl: str | None = None, kv_quant: bool | int = False,
                 max_seq: int | None = None, temperature: float = 0.5,
                 topp: float = 0.6, seed: int = 0, chunk_size: int = 16,
                 spec: str | None = None, spec_k: int = 7, device="cuda",
                 capture: bool = True, act_dtype=torch.bfloat16,
                 tp: TPGroup | None = None):
        """capture=False runs the step bodies eagerly on the card too (how
        chip_smoke.py and the card tests hold the graphs to eager
        launches); on the CPU they always run eagerly. act_dtype (bf16,
        fp16 or f32; --act-dtype) is the activations' and the unquantized
        cache's type, as the JAX engine's (engine.py:197, 251-260).

        tp: this rank's TPGroup (parallel/mesh.py) for tensor parallelism,
        with the rank's shard of the params (parallel/tp.py): the cache
        holds the rank's kv heads, and every rank runs this same program
        on the same gathered logits with the same seed, so every rank
        draws the same tokens. Its step graphs are split at the
        collectives (engine/graphs.py): every rank captures and replays
        the same keys in the same order."""
        self.tp = tp
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
        self.act_dtype = act_dtype
        # kv_quant: False -> an act_dtype cache, True or 8 -> int8, 4 ->
        # int4
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
        self._init_step_state(capture)

    def _init_step_state(self, capture: bool):
        """The step bodies' device buffers (see the module docstring). The
        host's self.pos is the count; _pos_buf follows it, set from it at
        the start of every chunk, prompt and block run."""
        dev, cfg = self.device, self.cfg

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(*shape, dtype=dtype, device=dev)

        # a chunk's steps or a verify's positions
        n = max(self.chunk_size, self.spec_k + 1)
        self._pos_buf = zeros(1)
        self._idx = zeros(1, dtype=torch.int64)
        self._tok = zeros(1, 1)
        self._coin_buf = zeros(n, dtype=torch.float32)
        self._out = zeros(n)
        self._prompt_buf = zeros(self.max_seq + PREFILL_BLOCK)
        self._block_rows = torch.arange(PREFILL_BLOCK, device=dev)
        self._logits = zeros(PREFILL_BLOCK, cfg.vocab_size,
                             dtype=torch.float32)
        # coins double-buffered: generate_benchmark queues chunk i + 1
        # while chunk i's copy may not have run
        self._coin_stage = _Stage(n, torch.float32, dev, 2)
        self._prompt_stage = _Stage(self.max_seq + PREFILL_BLOCK,
                                    torch.int32, dev, 1)
        self._graphs = None
        if capture and dev.type == "cuda":
            self._graphs = GraphSet(dev, lambda: reserve_split_scratch(
                dev, 1, cfg.n_kv_heads // self._tp_size,
                cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, self.max_seq))

    def _init_cache(self):
        if self.tp is None:
            return init_kv_cache(self.cfg, 1, self.max_seq,
                                 dtype=self.act_dtype,
                                 quantized=self.kv_quant,
                                 kv_bits=self.kv_bits, device=self.device)
        return tp_init_kv_cache(self.cfg, 1, self.max_seq, self.tp.size,
                                dtype=self.act_dtype,
                                quantized=self.kv_quant,
                                kv_bits=self.kv_bits, device=self.device)

    @property
    def _tp_size(self) -> int:
        return self.tp.size if self.tp is not None else 1

    def _bucket_for(self, seq: int) -> int:
        for b in self._buckets:
            if seq <= b:
                return b
        return self._buckets[-1]

    # ------------------------------------------------------------------
    # step bodies on the device state, and their graphs

    def _advance(self, n: int):
        self._pos_buf.add_(n)
        self._idx.add_(n)

    def _decode_body(self, attn_len: int):
        """One sampled step: _tok at _pos_buf, coin _coin_buf[_idx]; the
        token to _out[_idx] and _tok."""
        logits, _ = forward(self.params, self.cfg, self._tok, self._pos_buf,
                            self.cache, attn_len=attn_len,
                            attn_impl=self.attn_impl,
                            act_dtype=self.act_dtype, tp=self.tp)
        coin = self._coin_buf.index_select(0, self._idx)
        nxt = sample_token(logits, coin, self.temperature, self.topp)
        # garbage-token clamp (llama2_q4.cu:474)
        nxt = torch.where(nxt >= self.cfg.vocab_size, torch.zeros_like(nxt),
                          nxt)
        self._out.index_copy_(0, self._idx, nxt)
        self._tok.copy_(nxt.view(1, 1))
        self._advance(1)

    def _prompt_body(self, attn_len: int, T: int, head: bool):
        """T teacher-forced tokens _prompt_buf[_idx:_idx + T] at _pos_buf;
        with head, their f32 logits to _logits[:T]."""
        rows = self._idx + self._block_rows[:T]
        toks = self._prompt_buf.index_select(0, rows)[None]
        logits, _ = forward(self.params, self.cfg, toks, self._pos_buf,
                            self.cache, attn_len=attn_len,
                            attn_impl=self.attn_impl,
                            act_dtype=self.act_dtype, logits_all=head,
                            no_logits=not head, tp=self.tp)
        if head:
            self._logits[:T].copy_(logits[0])
        self._advance(T)

    def _verify_body(self, attn_len: int, T: int):
        """A prompt step with the head over the T tokens at _idx, then
        the model's token at each position into _out[:T]: the argmax at
        temperature 0, else the sampler on the coins _coin_buf[:T]."""
        self._prompt_body(attn_len, T, head=True)
        logits = self._logits[:T]
        if self.temperature == 0.0:
            out = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            out = sample_token(logits, self._coin_buf[:T], self.temperature,
                               self.topp)
        self._out[:T].copy_(out)

    def _graph_key(self, kind, T: int, attn_len: int) -> tuple:
        """What a graph of a body holds fixed: its kind, block width and
        window, and forward's plan there (models/llama.plan: attn_impl
        after "auto", the cache format, the lm_head's type, the
        LLAMA_TPU_DOWN_QKV switch). No chunk length."""
        return (kind, T, attn_len, plan(self.params, self.cfg, self.cache,
                                        1, T, attn_len, self.attn_impl,
                                        self._tp_size))

    def _run(self, kind, T: int, attn_len: int, body, n: int = 1):
        """body() n times: eagerly without graphs, else through the graph
        of its key."""
        if self._graphs is None:
            for _ in range(n):
                body()
        else:
            self._graphs.run(self._graph_key(kind, T, attn_len), body, n)

    def _start(self):
        """The device state from the host's: position self.pos, index 0."""
        self._pos_buf.fill_(self.pos)
        self._idx.zero_()

    def _decode_chunk(self, k: int) -> torch.Tensor:
        """k sampled steps from self.pos, the first fed from _tok, at the
        window of pos + k; draws k xorshift coins. Returns the (k,) tokens
        on the device, a view of _out valid until the next chunk."""
        with span("seq.decode"):
            self._coin_stage.put([self.rng.random_f32() for _ in range(k)],
                                 self._coin_buf)
            self._start()
            attn_len = self._bucket_for(self.pos + k)
            self._run("decode", 1, attn_len,
                      functools.partial(self._decode_body, attn_len), k)
        return self._out[:k]

    def reset(self):
        # in place, where the JAX engine builds a new cache: the graphs
        # hold the cache's addresses
        with span("seq.reset"):
            c = self.cache
            for t in c.k + c.v + c.k_scale + c.v_scale:
                t.zero_()
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
        with span("seq.prompt"):
            assert tokens
            if self.pos + len(tokens) > self.max_seq:
                raise ValueError(f"{len(tokens)} tokens at position "
                                 f"{self.pos} pass max_seq {self.max_seq}")
            self._hist.extend(tokens)
            # the prompt on the device, padded with 0 to a whole block
            n_pad = -(-len(tokens) // PREFILL_BLOCK) * PREFILL_BLOCK
            self._prompt_stage.put(tokens + [0] * (n_pad - len(tokens)),
                                   self._prompt_buf)
            self._start()
            if not collect_logits and len(tokens) < PREFILL_BLOCK // 2:
                attn_len = self._bucket_for(self.pos + len(tokens))
                self._run(("prompt", False), 1, attn_len,
                          functools.partial(self._prompt_body, attn_len, 1,
                                            False), len(tokens))
                self.pos += len(tokens)
                return None
            rows, last, i = [], None, 0
            while i < len(tokens):
                n = min(PREFILL_BLOCK, len(tokens) - i)
                block = 1 if n == 1 else PREFILL_BLOCK
                if self.pos + block > self.max_seq:
                    block, n = 1, 1
                # the lm_head runs on the prompt's last block only, or on
                # every block for collect_logits (perplexity)
                head = collect_logits or i + n == len(tokens)
                attn_len = self._bucket_for(self.pos + block)
                self._run(("prompt", head), block, attn_len,
                          functools.partial(self._prompt_body, attn_len,
                                            block, head))
                if collect_logits:
                    with span("seq.wait"):
                        rows.append(self._logits[:n].to("cpu", copy=True))
                if head:
                    last = self._logits[n - 1].clone()
                self.pos += n
                i += n
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
        with span("seq.request"):
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
            with span("seq.wait"):  # a copy from pageable memory syncs
                token = torch.tensor([prev_token], dtype=torch.int32,
                                     device=self.device)
            generated, hit_eos = self._decode_auto(token, steps - n_pref + 1)

            # the reference prints the token from the previous iteration, so
            # the final generated token is never printed unless EOS stopped
            # it
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
        self._tok.copy_(token.view(1, 1))
        while done < max_steps:
            if self.pos >= self.max_seq:
                break  # cache full
            k = min(self.chunk_size, max_steps - done,
                    self.max_seq - self.pos)
            snapshot = self.rng.state
            out = self._decode_chunk(k)
            with span("seq.wait"):
                host = out.tolist()  # the host sync point
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

    def _spec_verify(self, tokens: list[int], coins: list[float] | None,
                     attn_len: int) -> list[int]:
        """One teacher-forced forward over [last, p_1..p_k] at self.pos:
        out[t] is the model's token after consuming p_1..p_t (argmax at
        temperature 0, else the sampler on coins[t]). Cache rows written
        past what is later accepted lie beyond the rolled-back position
        and are overwritten before any step reads them."""
        T = len(tokens)
        self._prompt_stage.put(tokens, self._prompt_buf)
        if coins is not None:
            self._coin_stage.put(coins, self._coin_buf)
        self._start()
        self._run("verify", T, attn_len,
                  functools.partial(self._verify_body, attn_len, T))
        with span("seq.wait"):
            return self._out[:T].tolist()  # the host sync of a verify

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
            coins = None
            if self.temperature > 0.0:
                # peek the next k+1 coins without consuming them: coin t
                # is the one plain decode draws at emitted step t
                saved = self.rng.state
                coins = [self.rng.random_f32() for _ in range(k + 1)]
                self.rng.state = saved
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

    def generate_benchmark(self, prompt_tokens: list[int], steps: int,
                           untimed_prefill: bool = False):
        """Timed generation without per-chunk host syncs or text decoding:
        prompt + device-chained decode chunks, one host read at the end.
        Returns (tokens, seconds, tok_per_s) with the reference's
        timed-token accounting (llama2_q4.cu:486-489): steps - 1 tokens.

        untimed_prefill: the prompt runs before the clock starts (the card
        synchronized after it), and the timed tokens are the decode
        tokens alone, len(tokens): decode tok/s at depth (the JAX
        engine's, engine.py:749-801)."""
        with span("seq.request"):
            self.reset()
            sync = self.device.type == "cuda"
            if sync:
                with span("seq.wait"):
                    torch.cuda.synchronize()
            start = time.time()
            n_pref = min(len(prompt_tokens), steps)
            if n_pref > 1:
                self._prefill(prompt_tokens[:n_pref - 1])
            with span("seq.wait"):  # a copy from pageable memory syncs
                token = torch.tensor([prompt_tokens[n_pref - 1]],
                                     dtype=torch.int32, device=self.device)
            if untimed_prefill:
                if sync:
                    with span("seq.wait"):
                        torch.cuda.synchronize()
                start = time.time()
            if self.spec:
                # the same accounting: the loop emits steps - n_pref + 1 tokens
                tokens, _ = self._decode_auto(token, steps - n_pref + 1,
                                              stop_at_eos=False)
            else:
                outs = []
                remaining = steps - n_pref + 1
                self._tok.copy_(token.view(1, 1))
                while remaining > 0 and self.pos < self.max_seq:
                    k = min(self.chunk_size, remaining,
                            self.max_seq - self.pos)
                    outs.append(self._decode_chunk(k).clone())
                    self.pos += k
                    remaining -= k
                with span("seq.wait"):
                    tokens = torch.cat(outs).tolist()
            dt = time.time() - start
            timed = len(tokens) if untimed_prefill else steps - 1
            return tokens, dt, timed / dt

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
