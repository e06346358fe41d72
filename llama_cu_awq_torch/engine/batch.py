"""Continuous-batching engine: many concurrent requests over one model.

The counterpart of llama_cu_awq_tpu/engine/batch.py. Design:

- The KV cache holds S slots (the leading batch axis of every per-layer
  buffer). A slot is one request's sequence; the slot scheduler
  (engine/scheduler.py) assigns queued requests to free slots between
  decode chunks.
- Decode runs ALL slots in one batched step (B=S, T=1): decode is
  weight-bandwidth-bound, so the S-fold batch rides along nearly free.
  Inactive slots compute garbage that the host discards; their cache
  writes land at rows that are rewritten before the slot reads them.
- A chunk is K steps in which every slot consumes one token: a
  teacher-forced prompt token where the force mask is set, else the
  slot's sampled token, which stays on the device (the carry, _tok). The
  host syncs once per chunk, when it reads the chunk's tokens; `run`
  queues chunk N+1 on the stream before it reads chunk N's tokens (one
  chunk of lookahead), so the card need not wait for the host's routing.
  Neither end waits for more: inputs reach the card from pinned memory
  without a stream sync (_Inputs), and a chunk's tokens are copied to the
  host right behind it, so reading them waits for that chunk only
  (_Fetch).
- Prompts of up to FORCED_PROMPT_MAX tokens feed through the forced
  stream; longer ones prefill block by block on their slot's cache rows
  between decode rounds (interleaved prefill), then join the forced
  stream with their last token.
- spec="ngram": speculative (S, T) blocks with prompt-lookup proposals,
  with the JAX engine's throttle.
- prefix_cache_size > 0: an LRU of prompt-prefix KV rows (clones of the
  slot cache's rows, never views of it). Its copies run eagerly, once an
  admission.

Under a running profiler (utils/profiling.py) step() is the span
batch.step, holding batch.admit, batch.prefill (a slot's block, staged
and launched), batch.dispatch (a chunk's or spec block's inputs and
launches), batch.wait (the host syncs) and batch.route (the tokens
routed); run()'s rounds and serve.py's calls open the same phases. A
chunk then counts the rows its attention_step launches read
(_count_attention), and on the card CUDA events time each prefill block
and each chunk's replays (_mark, _settle), read once a host sync has
passed them, whether or not the profiler still runs then.

The counterparts of the JAX engine's jitted _decode_chunk_fn (a scan),
_prefill_slot_fn and _spec_block_fn are step bodies on device buffers of
fixed address, as in engine/engine.py: _chunk_body (one step of a chunk:
the input token, forward at B=S, the sampler, the garbage clamp, the
token to _out[_idx] and the carry, positions and _idx advanced on the
device), _prefill_body (a B=1 block on one slot's rows) and _spec_body
(an (S, T) forward with every position's token into _spec_out). A
dispatch writes its host inputs into one staged buffer (_Inputs: per-slot
positions, coins, forced tokens and mask, temperatures, top-p values,
spec inputs, a prefill block), so no body reads a tensor made for one
call, and the host may go on mutating its arrays while a dispatched step
still runs (llama_cu_awq_tpu/engine/batch.py:59-71 documents the race
aliasing caused there). On the card each body is a CUDA graph
(engine/graphs.py) keyed by (kind, T, window, models/llama.plan), the
kind holding the host's other choices: ("chunk", sampled), ("spec",
sampled) or ("prefill", slot), since a slot's rows lie at their own
addresses. A chunk of k <= chunk_size steps replays its step graph k
times. On the CPU the same bodies run eagerly, and capture=False runs them
so on the card. Per-slot positions keep every slot causally independent
inside the shared step. Coins are consumed as the JAX engine consumes
them: k x S per chunk, S x T per sampled spec block, none for an
all-greedy block, so seeded sampled streams match it.

Tensor parallelism (tp, a TPGroup of parallel/mesh.py, with each rank's
shard of the params): rank 0, the leader, owns the requests, the
scheduler and every host decision; before each body it runs (a chunk, a
slot's prefill block, a spec block) and each prefix-cache copy, it writes
a header (what to run, T, the window, steps, slot, flags) into the
staged input buffer and broadcasts the whole buffer over the group. Ranks
1 and up run follow(): receive the buffer, run the same body on it, until
the leader's stop_followers(). Every body reads only that buffer and
static state, so the ranks run the same program; the collectives inside
forward pair up in order. Every rank runs the bodies through its own
graphs, split at the collectives (engine/graphs.py): a key's first run
is eager on every rank, its capture runs no collective, and its replays
run them between the segments. The broadcast of the staged buffer runs
outside the bodies, before each.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
import types
from collections import OrderedDict

import numpy as np
import torch

from llama_cu_awq_torch.config import ModelConfig
from llama_cu_awq_torch.device import resolve_device
from llama_cu_awq_torch.engine.engine import (PREFILL_BLOCK, _Stage,
                                              attn_buckets, propose_ngram)
from llama_cu_awq_torch.engine.graphs import GraphSet
from llama_cu_awq_torch.engine.scheduler import make_scheduler
from llama_cu_awq_torch.models.llama import (KVCache, LlamaParams, forward,
                                             init_kv_cache, plan)
from llama_cu_awq_torch.ops.cuda.attention_step import reserve_split_scratch
from llama_cu_awq_torch.parallel.mesh import TPGroup
from llama_cu_awq_torch.parallel.tp import tp_init_kv_cache
from llama_cu_awq_torch.sampling import (XorshiftRNG, sample_token,
                                         sample_token_vec)
from llama_cu_awq_torch.tokenizer import BOS_TOKEN, EOS_TOKEN
from llama_cu_awq_torch.utils.profiling import add, count, enabled, span


@dataclasses.dataclass
class _Fetch:
    """A dispatched result's copy to pinned host memory, queued on the
    stream right behind the work that makes it, and the event recorded
    after the copy."""
    host: torch.Tensor
    done: torch.cuda.Event


def _host(a) -> np.ndarray:
    """A chunk's or block's tokens on the host (the sync point), whether
    the caller already fetched them or not. A _Fetch waits for its own
    event only: a plain device-to-host copy would queue behind the chunk
    dispatched after it, and the lookahead would wait for that one too."""
    if isinstance(a, np.ndarray):
        return a
    if isinstance(a, _Fetch):
        a.done.synchronize()
        return a.host.numpy()
    return a.cpu().numpy()


class _Inputs:
    """A dispatch's host inputs as named regions of one int32 buffer: a
    numpy mirror the host fills (`host.<name>`), device views of fixed
    address that the step bodies read (`dev.<name>`), and push(), one
    copy of the whole buffer through a pinned staging slot, queued in
    stream order without a host sync (engine._Stage). float32 regions
    hold their bits. `slots` staging slots: a slot is rewritten only once
    the copy that read it has run."""

    def __init__(self, device: torch.device, slots: int, **fields):
        sizes = {k: math.prod(shape) for k, (shape, _) in fields.items()}
        n = sum(sizes.values())
        self._host = np.zeros(n, np.int32)
        self._dev = torch.zeros(n, dtype=torch.int32, device=device)
        self._stage = _Stage(n, torch.int32, device, slots, "batch.wait")
        host, dev, off = {}, {}, 0
        for name, (shape, dtype) in fields.items():
            h = self._host[off:off + sizes[name]]
            d = self._dev[off:off + sizes[name]]
            if dtype == torch.float32:
                h, d = h.view(np.float32), d.view(torch.float32)
            host[name], dev[name] = h.reshape(shape), d.view(shape)
            off += sizes[name]
        self.host = types.SimpleNamespace(**host)
        self.dev = types.SimpleNamespace(**dev)

    def push(self) -> None:
        self._stage.put(self._host, self._dev)


# the header's first word under tensor parallelism: what a follower runs
# (BatchEngine._send / follow)
_CHUNK, _PREFILL, _SPEC, _PREFIX_GET, _PREFIX_PUT, _PREFIX_DROP, _RESET, \
    _STOP, _NOOP = range(1, 10)
# an idle leader's heartbeat, well inside torch.distributed's timeout
# (30 minutes by default), which a follower's wait would otherwise reach
_IDLE_SEND_S = 60.0
_HEADER = 8  # words: code, T, window, steps, slot, flag, m, serial


class _PrefixCache:
    """LRU store of prompt-prefix KV rows at PREFILL_BLOCK-multiple
    lengths: multi-turn chat and shared-system-prompt serving re-send the
    same long prefix on every request. Rows of a causal model depend only
    on earlier tokens, so for an identical token prefix the cached rows
    are exact, and admission becomes a row copy plus a prefill of the
    tail. Entries hold per layer (1, m, Hkv, D) rows [+ (1, m, Hkv)
    scales when quantized], cloned off the slot cache. on_drop(rows) is
    called for rows that put() does not keep or evicts."""

    def __init__(self, capacity: int, on_drop=None):
        self.capacity = capacity
        self.on_drop = on_drop
        self._entries = OrderedDict()  # key: tuple(tokens) -> rows
        self.hits = 0
        self.misses = 0
        self.rows_saved = 0

    def match(self, tokens: list[int]) -> int:
        """Longest cached block-multiple prefix of `tokens`; 0 if none."""
        m = (len(tokens) // PREFILL_BLOCK) * PREFILL_BLOCK
        while m >= PREFILL_BLOCK:
            key = tuple(tokens[:m])
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                self.rows_saved += m
                return m
            m -= PREFILL_BLOCK
        self.misses += 1
        return 0

    def get(self, tokens: list[int], m: int):
        return self._entries[tuple(tokens[:m])]

    def put(self, tokens: list[int], m: int, rows) -> None:
        key = tuple(tokens[:m])
        if key in self._entries:
            self._entries.move_to_end(key)
            dropped = [rows]
        else:
            self._entries[key] = rows
            dropped = []
        while len(self._entries) > self.capacity:
            dropped.append(self._entries.popitem(last=False)[1])
        if self.on_drop is not None:
            for r in dropped:
                self.on_drop(r)


@dataclasses.dataclass
class _Req:
    id: int
    prompt: list[int]
    max_new: int
    temperature: float = 0.0
    topp: float = 0.6
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submit_t: float = 0.0
    first_token_t: float | None = None
    finish_t: float | None = None


class BatchEngine:
    # prompts up to this length feed through forced decode steps (they
    # share the batch's weight reads); longer ones get a block prefill on
    # their slot first
    FORCED_PROMPT_MAX = 48

    def __init__(self, params: LlamaParams, cfg: ModelConfig,
                 tokenizer=None, *, n_slots: int = 8,
                 max_seq: int | None = None, attn_impl: str | None = None,
                 kv_quant: bool | int = False, temperature: float = 0.0,
                 topp: float = 0.6, seed: int = 1234, chunk_size: int = 8,
                 spec: str | None = None, spec_k: int = 7,
                 prefix_cache_size: int = 0, device="cuda",
                 capture: bool = True, act_dtype=torch.bfloat16,
                 tp: TPGroup | None = None):
        """capture=False runs the step bodies eagerly on the card too (how
        chip_smoke.py and the card tests hold the graphs to eager
        launches); on the CPU they always run eagerly. act_dtype (bf16,
        fp16 or f32) is the activations' and the unquantized cache's type,
        as the JAX engine's (batch.py:141, 234-242). tp: this rank's
        TPGroup (see the module docstring); every rank makes its engine
        with the same arguments, rank 0 serves and the others follow();
        their graphs are split at the collectives (engine/graphs.py)."""
        self.tp = tp if tp is not None and tp.size > 1 else None
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"params are on {params.device}, the engine "
                             f"runs on {self.device}")
        if spec is not None and spec != "ngram":
            raise ValueError(f"unknown spec mode {spec!r} "
                             "(supported: 'ngram')")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.n_slots = n_slots
        self.max_seq = max_seq or min(512, cfg.seq_len)
        # None -> "auto": plain attention below FSTEP_MIN_WINDOW, the
        # attention_step kernel from it on (models/llama.forward)
        self.attn_impl = attn_impl if attn_impl is not None else "auto"
        self.act_dtype = act_dtype
        self.temperature = temperature
        self.topp = topp
        self.rng = XorshiftRNG(seed)
        self.chunk_size = chunk_size
        self._buckets = attn_buckets(self.max_seq)
        # kv_quant: False -> an act_dtype cache; True or 8 -> int8; 4 ->
        # int4
        self.kv_quant = bool(kv_quant)
        self.kv_bits = 4 if kv_quant == 4 else 8
        # speculative serving: decode runs as (S, T=spec_k+1) teacher-
        # forced blocks (prompt feed, prompt-lookup proposals and plain
        # decode in one weight pass); each slot advances by its accepted
        # prefix plus the model's correction token. Sampled slots accept
        # by equality on sampled verify tokens, which with a point-mass
        # draft is exact speculative rejection sampling.
        self.spec = spec
        self.spec_k = spec_k
        # adaptive throttle: a round with nothing to verify and no prompt
        # to feed takes a plain chunk; when recent proposing blocks accept
        # below spec_min_accept tokens per proposing slot, proposals pause
        # for spec_backoff rounds, then one block probes again
        self.spec_min_accept = 0.5
        self.spec_backoff = 8
        self.prefix_cache = (_PrefixCache(
            prefix_cache_size,
            on_drop=lambda rows: self._send(_PREFIX_DROP, serial=rows[0]))
            if prefix_cache_size > 0 else None)
        self._prefix_serial = 0
        self._reseed = False  # the next chunk starts from the staged carry
        self._sent_t = time.monotonic()  # the leader's last _send
        self._next_id = 0
        # None, or a dict the caller set: request id -> {position: the
        # attention window of the decode chunk that stepped it there}
        # (a spec block's positions are not recorded). A replay of a
        # request that takes these windows meets its rounding.
        self.window_log: dict[int, dict[int, int]] | None = None
        self.cache = self._init_cache()
        self._init_step_state(capture)
        self._reset_state()

    # ------------------------------------------------------------------

    def _init_cache(self) -> KVCache:
        if self.tp is None:
            return init_kv_cache(self.cfg, self.n_slots, self.max_seq,
                                 dtype=self.act_dtype,
                                 quantized=self.kv_quant,
                                 kv_bits=self.kv_bits, device=self.device)
        return tp_init_kv_cache(self.cfg, self.n_slots, self.max_seq,
                                self.tp.size, dtype=self.act_dtype,
                                quantized=self.kv_quant,
                                kv_bits=self.kv_bits, device=self.device)

    @property
    def _tp_size(self) -> int:
        return self.tp.size if self.tp is not None else 1

    def _init_step_state(self, capture: bool):
        """The step bodies' device buffers (see the module docstring): the
        staged inputs, the chunk's step index, the token carry and the
        outputs; and the GraphSet, its split scratch reserved for B = S
        at max_seq."""
        dev, cfg = self.device, self.cfg
        S, C, T = self.n_slots, self.chunk_size, self.spec_k + 1
        f32, i32 = torch.float32, torch.int32
        # a round pushes once a prefill block (one a slot) and once its
        # chunk or block, the spec fallback's carry once more: with two
        # rounds in flight (run()'s lookahead) a push does not wait for
        # a copy still queued, unless a drain prefills more blocks
        self._in = _Inputs(
            dev, 2 * (S + 2) + 1, pos=((S,), i32), temps=((S,), f32),
            topps=((S,), f32), carry=((S,), i32), coins=((C, S), f32),
            forced=((C, S), i32), mask=((C, S), i32),
            spec_tok=((S, T), i32), spec_coins=((S, T), f32),
            block=((1, PREFILL_BLOCK), i32), block_pos=((1,), i32),
            hdr=((_HEADER,), i32))
        self._idx = torch.zeros(1, dtype=torch.int64, device=dev)
        self._tok = torch.zeros(S, dtype=i32, device=dev)  # the carry
        self._out = torch.zeros(C, S, dtype=i32, device=dev)
        self._spec_out = torch.zeros(S, T, dtype=i32, device=dev)
        self._graphs = None
        if capture and dev.type == "cuda":
            self._graphs = GraphSet(dev, lambda: reserve_split_scratch(
                dev, S, cfg.n_kv_heads // self._tp_size,
                cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, self.max_seq))

    def _fetch(self, t: torch.Tensor):
        """Start copying a dispatched result, a view of a static output
        buffer, to the host (see _Fetch); on the CPU a clone, since the
        next dispatch rewrites the buffer."""
        if self.device.type != "cuda":
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return _Fetch(host, done)

    def _coins(self, rows: int, cols: int) -> np.ndarray:
        """(rows, cols) coins, drawn row by row."""
        return np.array([[self.rng.random_f32() for _ in range(cols)]
                         for _ in range(rows)], np.float32)

    def _bucket_for(self, seq: int) -> int:
        for b in self._buckets:
            if seq <= b:
                return b
        return self._buckets[-1]

    def _slot_cache(self, slot: int) -> KVCache:
        """Views of one slot's rows of every cache buffer (contiguous:
        forward writes through them in place)."""
        c = self.cache
        return KVCache(*[[a[slot:slot + 1] for a in field]
                         for field in (c.k, c.v, c.k_scale, c.v_scale)])

    # ------------------------------------------------------------------
    # step bodies on the device state, and their graphs

    def _chunk_body(self, attn_len: int, sampled: bool):
        """One step of a chunk: each slot's input is forced[_idx] where
        mask[_idx] is set, else the carry _tok; forward at B=S and the
        slots' positions; the sampled token (per-slot temperature and
        top-p, coin coins[_idx]) or the argmax, clamped, to _out[_idx]
        and _tok; positions and _idx advance by one."""
        d, i = self._in.dev, self._idx
        forced = d.mask.index_select(0, i)[0] != 0
        in_tok = torch.where(forced, d.forced.index_select(0, i)[0],
                             self._tok)
        logits, _ = forward(self.params, self.cfg, in_tok[:, None], d.pos,
                            self.cache, attn_len=attn_len,
                            attn_impl=self.attn_impl,
                            act_dtype=self.act_dtype, tp=self.tp)
        coin = d.coins.index_select(0, i)[0]
        if sampled:  # per-slot temperature and top-p
            nxt = sample_token_vec(logits, coin, d.temps, d.topps)
        else:        # all-greedy: no softmax, no sort
            nxt = sample_token(logits, coin, 0.0, 0.0)
        # garbage-token clamp (llama2_q4.cu:474)
        nxt = torch.where(nxt >= self.cfg.vocab_size, torch.zeros_like(nxt),
                          nxt)
        self._out.index_copy_(0, i, nxt[None])
        self._tok.copy_(nxt)
        d.pos.add_(1)
        i.add_(1)

    def _prefill_body(self, slot: int, attn_len: int, T: int):
        """B=1 teacher-forced block block[:, :T] at block_pos over one
        slot's cache rows, without the lm_head."""
        d = self._in.dev
        forward(self.params, self.cfg, d.block[:, :T], d.block_pos,
                self._slot_cache(slot), attn_len=attn_len, no_logits=True,
                act_dtype=self.act_dtype, tp=self.tp)

    def _spec_body(self, attn_len: int, sampled: bool):
        """One teacher-forced forward over the (S, T) blocks spec_tok with
        per-slot positions, the model's token choice at every position to
        _spec_out: greedy argmax, or with sampled=True per-position
        sampling on spec_coins with the slot's own temperature and top-p
        (point-mass-draft rejection sampling reduces to acceptance by
        equality on these tokens, see the JAX engine's _spec_block_fn)."""
        d = self._in.dev
        logits, _ = forward(self.params, self.cfg, d.spec_tok, d.pos,
                            self.cache, attn_len=attn_len,
                            attn_impl=self.attn_impl,
                            act_dtype=self.act_dtype, logits_all=True,
                            tp=self.tp)
        if not sampled:
            self._spec_out.copy_(torch.argmax(logits, dim=-1))
            return
        S, T, V = logits.shape
        toks = sample_token_vec(logits.reshape(S * T, V),
                                d.spec_coins.reshape(S * T),
                                d.temps[:, None].expand(S, T).reshape(-1),
                                d.topps[:, None].expand(S, T).reshape(-1))
        self._spec_out.copy_(toks.reshape(S, T))

    def _graph_key(self, kind: tuple, T: int, attn_len: int) -> tuple:
        """What a graph of a body holds fixed: its kind, ("chunk",
        sampled), ("spec", sampled) or ("prefill", slot), its block width
        and window, and forward's plan there (models/llama.plan: B = S, or
        B = 1 without an attn_impl for prefill, as _prefill_body calls
        forward). No chunk length."""
        B, impl = ((1, None) if kind[0] == "prefill"
                   else (self.n_slots, self.attn_impl))
        return (kind, T, attn_len, plan(self.params, self.cfg, self.cache,
                                        B, T, attn_len, impl, self._tp_size))

    def _run(self, kind: tuple, T: int, attn_len: int, body, n: int = 1):
        """body() n times: eagerly without graphs, else through the graph
        of its key. On a tensor-parallel leader, the followers are told
        first (_send)."""
        if kind[0] == "chunk":
            self._send(_CHUNK, T=T, window=attn_len, steps=n,
                       flag=int(kind[1]) | 2 * self._reseed)
            self._reseed = False
        elif kind[0] == "spec":
            self._send(_SPEC, T=T, window=attn_len, flag=int(kind[1]))
        else:
            self._send(_PREFILL, T=T, window=attn_len, slot=kind[1])
        if self._graphs is None:
            for _ in range(n):
                body()
        else:
            self._graphs.run(self._graph_key(kind, T, attn_len), body, n)

    def _prefill_slot(self, tokens: list[int], pos: int, slot: int,
                      attn_len: int) -> None:
        """B=1 teacher-forced block over one slot's cache rows."""
        T = len(tokens)
        h = self._in.host
        h.block[0, :T] = tokens
        h.block_pos[0] = pos
        self._in.push()
        e0 = self._mark()
        self._run(("prefill", slot), T, attn_len, functools.partial(
            self._prefill_body, slot, attn_len, T))
        self._timed_since(e0, "prefill", 1)

    # -- tracing ------------------------------------------------------------

    def _mark(self):
        """While tracing on the card, a timing event recorded on the
        current stream; else None."""
        if self.device.type != "cuda" or not enabled():
            return None
        return self._event()

    @staticmethod
    def _event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _timed_since(self, e0, phase: str, steps: int) -> None:
        """Keep the launches queued since _mark() gave e0, as `steps`
        steps of `phase`, until a sync has passed them (_settle)."""
        if e0 is not None:
            self._timed.append((phase, steps, e0, self._event()))

    def _take_timed(self) -> list:
        timed, self._timed = self._timed, []
        return timed

    @staticmethod
    def _settle(timed: list) -> None:
        """Add timed launches that a host sync has passed to the
        counters: <phase>_device_ms, and prefill_blocks or decode_steps.
        They were launched while tracing, so they count even where the
        profiler stopped before this sync."""
        for phase, steps, e0, e1 in timed:
            add(f"{phase}_device_ms", e0.elapsed_time(e1))
            add("prefill_blocks" if phase == "prefill" else "decode_steps",
                steps)

    def _count_attention(self, active: list[int], k: int,
                         attn_len: int) -> None:
        """A chunk's attention, while tracing: where forward's plan runs
        the attention_step kernel, attention_steps += k and, for each step
        j and slot s, the min(pos[s] + j, attn_len) cache rows one launch
        reads, as attention_rows_active for the slots in `active` and
        attention_rows_parked for the others (free, capped, or parked
        mid-prefill); elsewhere attention_plain_steps += k. Host
        arithmetic on the parked positions, before the chunk advances
        them."""
        if not plan(self.params, self.cfg, self.cache, self.n_slots, 1,
                    attn_len, self.attn_impl, self._tp_size).fstep:
            count("attention_plain_steps", k)
            return
        rows = np.minimum(self.pos[:, None].astype(np.int64)
                          + np.arange(k), attn_len).sum(axis=1)
        live = np.zeros(self.n_slots, bool)
        live[active] = True
        count("attention_steps", k)
        count("attention_rows_active", int(rows[live].sum()))
        count("attention_rows_parked", int(rows[~live].sum()))

    # -- tensor parallelism ----------------------------------------------

    @property
    def _leader(self) -> bool:
        return self.tp is not None and self.tp.rank == 0

    def _send(self, code: int, *, T=0, window=0, steps=0, slot=0, flag=0,
              m=0, serial=0) -> None:
        """On a tensor-parallel leader: the header into the staged inputs,
        the inputs to the device, and the device buffer broadcast to the
        followers. Elsewhere nothing."""
        if not self._leader:
            return
        self._in.host.hdr[:] = (code, T, window, steps, slot, flag, m,
                                serial)
        self._in.push()
        self._broadcast()
        self._sent_t = time.monotonic()

    def idle(self) -> None:
        """Called by the loop that steps the engine when it has nothing to
        dispatch: a leader that has sent nothing for _IDLE_SEND_S seconds
        sends a no-op, so the followers' waits never time out."""
        if self._leader and (time.monotonic() - self._sent_t
                             > _IDLE_SEND_S):
            self._send(_NOOP)

    def _broadcast(self) -> None:
        torch.distributed.broadcast(self._in._dev, src=self.tp.src,
                                    group=self.tp.group)

    def stop_followers(self) -> None:
        """End the followers' follow() loops (a tensor-parallel leader's
        last call)."""
        self._send(_STOP)

    def follow(self) -> None:
        """A tensor-parallel rank other than 0: run what the leader
        broadcasts (see the module docstring) until it stops."""
        if self.tp is None or self.tp.rank == 0:
            raise ValueError("follow() runs on tensor-parallel ranks >= 1")
        prefixes = {}  # serial -> this rank's cloned rows
        while True:
            self._broadcast()
            code, T, window, steps, slot, flag, m, serial = \
                self._in.dev.hdr.tolist()
            if code == _STOP:
                return
            if code == _CHUNK:
                self._idx.zero_()
                if flag & 2:
                    self._tok.copy_(self._in.dev.carry)
                sampled = bool(flag & 1)
                self._run(("chunk", sampled), T, window, functools.partial(
                    self._chunk_body, window, sampled), steps)
            elif code == _PREFILL:
                self._run(("prefill", slot), T, window, functools.partial(
                    self._prefill_body, slot, window, T))
            elif code == _SPEC:
                self._run(("spec", bool(flag)), T, window, functools.partial(
                    self._spec_body, window, bool(flag)))
            elif code == _PREFIX_GET:
                prefixes[serial] = self._clone_rows(slot, m)
            elif code == _PREFIX_PUT:
                self._copy_rows(prefixes[serial], slot)
            elif code == _PREFIX_DROP:
                del prefixes[serial]
            elif code == _RESET:
                self._reset_state()
            elif code != _NOOP:
                raise ValueError(f"unknown tensor-parallel header {code}")

    # -- prefix-cache rows -------------------------------------------------

    def _prefix_put(self, entry, slot: int) -> None:
        """Copy a prefix-cache entry (serial, rows) into one slot."""
        self._send(_PREFIX_PUT, slot=slot, serial=entry[0])
        self._copy_rows(entry[1], slot)

    def _prefix_get(self, slot: int, m: int):
        """A prefix-cache entry of rows [0, m) of one slot: (serial,
        clones); the serial names the followers' clones of their rows."""
        self._prefix_serial += 1
        self._send(_PREFIX_GET, slot=slot, m=m, serial=self._prefix_serial)
        return self._prefix_serial, self._clone_rows(slot, m)

    def _copy_rows(self, rows, slot: int) -> None:
        """Copy cached prefix rows into rows [0, m) of one slot."""
        sub = self._slot_cache(slot)
        for dst_field, src_field in zip(
                (sub.k, sub.v, sub.k_scale, sub.v_scale), rows):
            for dst, src in zip(dst_field, src_field):
                dst[:, :src.shape[1]].copy_(src)

    def _clone_rows(self, slot: int, m: int):
        """Clones of rows [0, m) of one slot."""
        sub = self._slot_cache(slot)
        return tuple([a[:, :m].clone() for a in field]
                     for field in (sub.k, sub.v, sub.k_scale, sub.v_scale))

    def _dispatch_spec_block(self, active, props=None):
        """Build and launch one (S, T) speculative block: pending prompt
        tokens first, then prompt-lookup proposals (generation slots'
        proposals arrive in `props`), then carry padding. Returns the
        block record for _process_spec_block."""
        T = self.spec_k + 1
        S = self.n_slots
        props = props or {}
        inputs = np.zeros((S, T), np.int32)
        n_forced = {}
        emitting = {}
        proposing = set()
        for s in range(S):
            if s not in active:
                continue
            pend = self._pending[s]
            F = min(len(pend), T)
            if F:
                inputs[s, :F] = pend[:F]
                del pend[:F]
            else:
                inputs[s, 0] = self._carry[s]
            n_forced[s] = F
            emitting[s] = not pend  # pending exhausted: emissions
            fill = F if F else 1
            if fill < T:
                prop = None
                if emitting[s]:
                    prop = props.get(s)
                    if prop is None and F:
                        # pending emptied in this block: propose from the
                        # now complete prompt context
                        req = self._slot_req[s]
                        prop = propose_ngram(req.prompt + req.out,
                                             T - fill)
                if prop is not None:
                    inputs[s, fill:] = prop
                    self.spec_stats["proposed"] += T - fill
                    proposing.add(s)
                else:
                    # carry padding: consumed only where the model agrees
                    inputs[s, fill:] = inputs[s, fill - 1]
        attn_len = self._bucket_for(int(self.pos[list(active)].max()) + T)
        # one coin per position for sampled blocks; greedy blocks take the
        # argmax and draw none
        sampled = bool((self.slot_temp[list(active)] > 0.0).any())
        h = self._in.host
        if sampled:
            h.spec_coins[:] = self._coins(S, T)
        h.spec_tok[:] = inputs
        h.pos[:] = self.pos
        h.temps[:] = self.slot_temp
        h.topps[:] = self.slot_topp
        self._in.push()
        self._run(("spec", sampled), T, attn_len, functools.partial(
            self._spec_body, attn_len, sampled))
        owners = {s: self._slot_req[s] for s in active}
        start_pos = {s: int(self.pos[s]) for s in active}
        self.spec_stats["blocks"] += 1
        return {"out": self._fetch(self._spec_out), "inputs": inputs,
                "owners": owners,
                "n_forced": n_forced, "emitting": emitting,
                "proposing": proposing, "start_pos": start_pos, "T": T,
                "timed": self._take_timed()}

    def _process_spec_block(self, blk):
        """Fetch a block's outputs (the host sync, unless the caller
        fetched them) and advance each slot by its valid-input count:
        forced prompt tokens are always valid; a proposal token is valid
        iff it equals the model's output at the previous position.
        Emissions are the outputs from the last forced position on: the
        accepted prefix plus the model's correction token."""
        with span("batch.wait"):
            out = _host(blk["out"])  # (S, T)
        self._settle(blk["timed"])
        with span("batch.route"):
            return self._route_spec_block(blk, out)

    def _route_spec_block(self, blk, out: np.ndarray):
        T = blk["T"]
        results = []
        now = time.time()
        n_prop = 0
        blk_accept = 0
        for s, req in blk["owners"].items():
            if self._slot_req[s] is not req or req.done:
                continue
            F = blk["n_forced"][s]
            V = F if F >= 1 else 1
            a = V
            if blk["emitting"][s]:
                emissions = [int(out[s, V - 1])]
                while a < T and blk["inputs"][s, a] == out[s, a - 1]:
                    a += 1
                    emissions.append(int(out[s, a - 1]))
                self.spec_stats["accepted"] += a - V
                if s in blk["proposing"]:
                    n_prop += 1
                    blk_accept += a - V
            else:
                emissions = []
            self.spec_stats["consumed"] += a
            self.pos[s] = blk["start_pos"][s] + a
            new = []
            for t in emissions:
                finished = self.scheduler.on_token(s, t == EOS_TOKEN)
                if t != EOS_TOKEN:
                    new.append(t)
                if finished:
                    req.done = True
                    req.finish_t = now
                    self._slot_req[s] = None
                    self._pending[s] = []
                    break
            if new:
                self._carry[s] = new[-1]
                if req.first_token_t is None:
                    req.first_token_t = now
            req.out.extend(new)
            if new or req.done:
                results.append((req.id, new, req.done))
        if n_prop:
            # throttle: proposing slots that accept about nothing make a
            # block worse than a plain chunk
            self._spec_recent.append(blk_accept / n_prop)
            self._spec_recent = self._spec_recent[-4:]
            if (len(self._spec_recent) >= 2
                    and (sum(self._spec_recent) / len(self._spec_recent)
                         < self.spec_min_accept)):
                self._spec_cooldown = self.spec_backoff
                self._spec_recent = []
        return results

    def _spec_eligible(self, active) -> bool:
        """Spec blocks need T rows of cache headroom per slot (a block
        writes rows pos..pos+T-1)."""
        if not active:
            return False
        T = self.spec_k + 1
        return all(int(self.pos[s]) + T <= self.max_seq for s in active)

    def dispatch_spec_round(self):
        """Admit and dispatch one speculative round without the host sync:
        ("block", blk) for a spec block, ("chunk", rec) where the round
        fell back to a plain chunk (no proposal fired, the throttle is
        cooling down, or a slot sits within T rows of the cache boundary),
        or None when idle. Pair with _process_spec_block or
        _process_chunk; serve.py reads the device result outside its
        engine lock."""
        self._admit()
        self._advance_prefill()
        active = [s for s in range(self.n_slots)
                  if self._slot_req[s] is not None
                  and s not in self._prefill_jobs
                  and int(self.pos[s]) < self.max_seq]
        if not active:
            return None
        T = self.spec_k + 1
        for s in range(self.n_slots):
            if s not in active:
                # park free or capped slots; mid-prefill slots park at the
                # dead tail rows (see _dispatch_chunk)
                self.pos[s] = (self.max_seq - T
                               if s in self._prefill_jobs else 0)
        throttled = self._spec_cooldown > 0
        want_block = False
        props = {}
        if self._spec_eligible(active):
            for s in active:
                if self._pending[s]:
                    # prompt feed: a block takes up to T prompt tokens in
                    # one weight pass; never throttled
                    want_block = True
                    continue
                if throttled:
                    continue
                req = self._slot_req[s]
                prop = propose_ngram(req.prompt + req.out, self.spec_k)
                if prop is not None:
                    props[s] = prop
                    want_block = True
        if throttled:
            self._spec_cooldown -= 1
            self.spec_stats["throttled_rounds"] += 1
        if not want_block:
            # nothing to verify and no prompt to feed: a plain chunk, its
            # device carry seeded from the host's next unconsumed tokens
            self._in.host.carry[:] = self._carry
            self._in.push()
            self._tok.copy_(self._in.dev.carry)
            self._reseed = True  # followers copy the carry too
            chunk = self._dispatch_chunk()
            return ("chunk", chunk) if chunk else None
        with span("batch.dispatch"):
            return ("block", self._dispatch_spec_block(active, props))

    def _step_spec(self):
        """One synchronous speculative round."""
        work = self.dispatch_spec_round()
        if work is None:
            return None
        kind, payload = work
        if kind == "chunk":
            return self._process_chunk(payload)
        return self._process_spec_block(payload)

    # ------------------------------------------------------------------
    # public API

    def reset(self):
        """Clear all requests and per-slot state. The cache and the token
        carry are zeroed in place, where the JAX engine builds new ones:
        the graphs hold their addresses. A tensor-parallel leader's
        followers reset too."""
        self._send(_RESET)
        self._reset_state()

    def _reset_state(self):
        S = self.n_slots
        self.scheduler = make_scheduler(S, self.max_seq)
        c = self.cache
        for t in c.k + c.v + c.k_scale + c.v_scale:
            t.zero_()
        self._tok.zero_()
        self.pos = np.zeros(S, np.int32)  # next write position
        # per-slot sampling parameters (a request may override the
        # engine's defaults at submit())
        self.slot_temp = np.zeros(S, np.float32)
        self.slot_topp = np.zeros(S, np.float32)
        self._requests: dict[int, _Req] = {}
        self._slot_req: list[_Req | None] = [None] * S
        self._pending: list[list[int]] = [[] for _ in range(S)]
        # slot -> in-flight interleaved block-prefill job
        self._prefill_jobs: dict[int, dict] = {}
        self._carry = np.zeros(S, np.int32)  # next unconsumed token
        self.spec_stats = {"blocks": 0, "consumed": 0, "proposed": 0,
                           "accepted": 0, "throttled_rounds": 0}
        self._spec_recent: list[float] = []  # accept/slot of last blocks
        self._spec_cooldown = 0
        # (phase, steps, start event, end event) launched while tracing on
        # the card, not yet passed by a sync (_mark)
        self._timed: list = []

    def submit(self, prompt: str | list[int], max_new: int = 0,
               temperature: float | None = None,
               topp: float | None = None) -> int:
        """Queue a request; returns its id. prompt: text (needs a
        tokenizer) or token ids (BOS added if missing). temperature and
        topp default to the engine's; per-request values ride the same
        batched step (sampling.sample_token_vec)."""
        if isinstance(prompt, str):
            tokens = self.tokenizer.encode(prompt, bos=True, eos=False)
        else:
            tokens = list(prompt)
            if not tokens or tokens[0] != BOS_TOKEN:
                tokens = [BOS_TOKEN] + tokens
        if len(tokens) + 1 > self.max_seq:
            raise ValueError(
                f"prompt of {len(tokens)} tokens exceeds max_seq "
                f"{self.max_seq}")
        rid = self._next_id
        self._next_id += 1
        req = _Req(rid, tokens, max_new,
                   temperature=(self.temperature if temperature is None
                                else max(temperature, 0.0)),
                   topp=self.topp if topp is None else topp,
                   submit_t=time.time())
        self._requests[rid] = req
        ok = self.scheduler.add(rid, len(tokens), max_new)
        assert ok, "scheduler rejected a size-checked request"
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a request (client disconnect, abort): frees its slot (a
        chunk in flight for it is discarded by _process_chunk's ownership
        check) or removes it from the queue. True if it was still live."""
        req = self._requests.get(rid)
        if req is None or req.done:
            return False
        req.done = True
        req.finish_t = time.time()
        where = self.scheduler.cancel(rid)
        if where >= 0:  # occupied slot `where`
            self._slot_req[where] = None
            self._pending[where] = []
            self._prefill_jobs.pop(where, None)
        return where != -1

    def drop_request(self, rid: int):
        """Forget a finished request's record and output (a long-running
        server would otherwise keep every request it served)."""
        self._requests.pop(rid, None)

    def _admit(self):
        with span("batch.admit"):
            for slot, rid in self.scheduler.admit():
                req = self._requests[rid]
                self._slot_req[slot] = req
                self.slot_temp[slot] = req.temperature
                self.slot_topp[slot] = req.topp
                tokens = req.prompt
                if len(tokens) <= self.FORCED_PROMPT_MAX:
                    self.pos[slot] = 0
                    self._pending[slot] = list(tokens)
                else:
                    self._start_prefill(slot, req)
                # the slot's carry stays stale: its first steps are forced

    # -- interleaved block prefill --------------------------------------
    #
    # A long prompt prefills one block per decode round instead of
    # running to completion at admission, so an admission never stalls
    # the other slots' decode. While a slot prefills, decode rounds park
    # its garbage writes at the dead tail rows [max_seq - k, max_seq):
    # beyond the prompt (the synchronous path below guarantees it), and
    # rewritten by the slot's own decode before any step attends to them.

    def _start_prefill(self, slot: int, req: _Req):
        """Begin prefilling all but the last prompt token on the slot's
        cache rows; the last token joins the forced stream, so its logits
        come from the batched step."""
        tokens = req.prompt
        body = tokens[:-1]
        pos = 0
        if self.prefix_cache is not None:
            pos = self.prefix_cache.match(body)
            if pos:
                self._prefix_put(self.prefix_cache.get(body, pos), slot)
        # near the cache boundary the parked tail rows would land on
        # prompt rows: prefill synchronously there (rare)
        tail = max(self.chunk_size, (self.spec_k + 1) if self.spec else 0)
        job = {"req": req, "tokens": tokens, "body": body, "pos": pos}
        if len(body) > self.max_seq - tail:
            while not self._finish_or_step(slot, job):
                pass
        else:
            self._prefill_jobs[slot] = job

    def _finish_or_step(self, slot: int, job) -> set:
        """Advance one PREFILL_BLOCK; on completion hand the slot to the
        forced stream. Returns {slot} when done, else an empty set."""
        body, pos = job["body"], job["pos"]
        if pos < len(body):
            chunk = body[pos:pos + PREFILL_BLOCK]
            block = 1 if len(chunk) == 1 else PREFILL_BLOCK
            if pos + block > self.max_seq:
                # a padded block would pass the cache's end
                block, chunk = 1, body[pos:pos + 1]
            padded = chunk + [0] * (block - len(chunk))
            with span("batch.prefill"):
                self._prefill_slot(padded, pos, slot,
                                   self._bucket_for(pos + block))
            job["pos"] = pos + len(chunk)
        if job["pos"] < len(body):
            return set()
        tokens = job["tokens"]
        if self.prefix_cache is not None:
            # store the freshly prefilled prefix (its rows are final:
            # decode writes only rows >= len(tokens) - 1)
            ms = (len(body) // PREFILL_BLOCK) * PREFILL_BLOCK
            if ms >= PREFILL_BLOCK:
                self.prefix_cache.put(body, ms, self._prefix_get(slot, ms))
        self.pos[slot] = len(tokens) - 1
        self._pending[slot] = [tokens[-1]]
        return {slot}

    def _advance_prefill(self):
        """Advance every prefill job by one block per decode round; when
        no slot can decode, drain the jobs instead (no one to starve)."""
        for slot in list(self._prefill_jobs):
            job = self._prefill_jobs[slot]
            if self._slot_req[slot] is not job["req"] or job["req"].done:
                del self._prefill_jobs[slot]  # cancelled mid-prefill
        if not self._prefill_jobs:
            return
        decodable = any(
            self._slot_req[s] is not None
            and s not in self._prefill_jobs
            and int(self.pos[s]) < self.max_seq
            for s in range(self.n_slots))
        while self._prefill_jobs:
            for slot in list(self._prefill_jobs):
                if self._finish_or_step(slot, self._prefill_jobs[slot]):
                    del self._prefill_jobs[slot]
            if decodable:
                break

    def _dispatch_chunk(self):
        """Admit and queue one mixed prefill/decode chunk on the device
        without waiting for its tokens. Returns a chunk record for
        _process_chunk, or None when no slot is active. The token carry
        chains chunk to chunk on the device (_tok), so a lookahead chunk
        needs no host round trip to start."""
        self._admit()
        self._advance_prefill()
        with span("batch.dispatch"):
            return self._queue_chunk()

    def _queue_chunk(self):
        # a slot already at the cache boundary (possible under lookahead:
        # the chunk in flight filled it, and processing that chunk retires
        # it) takes no step: it parks like a free slot and owns nothing
        active = [s for s in range(self.n_slots)
                  if self._slot_req[s] is not None
                  and s not in self._prefill_jobs
                  and int(self.pos[s]) < self.max_seq]
        if not active:
            return None
        k = self.chunk_size
        for s in active:  # a slot near the cache boundary caps the chunk
            k = min(k, self.max_seq - int(self.pos[s]))
        for s in range(self.n_slots):
            if s in active:
                continue
            # park free or capped slots at row 0; a slot mid-prefill at
            # the dead tail rows [max_seq - k, max_seq) instead, past its
            # prompt, where row 0 would overwrite its prefilled rows
            self.pos[s] = (self.max_seq - k
                           if s in self._prefill_jobs else 0)

        h = self._in.host
        h.forced[:] = 0
        h.mask[:] = 0
        emit_from = {}  # slot -> first step whose sampled output counts
        for s in active:
            pend = self._pending[s]
            n = min(len(pend), k)
            h.forced[:n, s] = pend[:n]
            h.mask[:n, s] = 1
            del pend[:n]
            # the step consuming the last prompt token emits generation
            # token 1; earlier forced outputs are teacher-forced noise
            emit_from[s] = k if pend else max(n - 1, 0)

        h.coins[:k] = self._coins(k, self.n_slots)
        h.pos[:] = self.pos
        h.temps[:] = self.slot_temp
        h.topps[:] = self.slot_topp
        self._in.push()
        self._idx.zero_()
        attn_len = self._bucket_for(int(self.pos[active].max()) + k)
        if enabled():
            self._count_attention(active, k, attn_len)
        # all-greedy chunks skip the per-row sampler (it sorts (S, vocab)
        # every step)
        sampled = bool((self.slot_temp[active] > 0.0).any())
        if self.window_log is not None:
            for s in active:
                p0 = int(self.pos[s])
                self.window_log.setdefault(self._slot_req[s].id, {}).update(
                    dict.fromkeys(range(p0, p0 + k), attn_len))
        e0 = self._mark()
        self._run(("chunk", sampled), 1, attn_len, functools.partial(
            self._chunk_body, attn_len, sampled), k)
        self._timed_since(e0, "decode", k)
        # owners at dispatch: a slot freed while this chunk is in flight
        # has its tokens discarded at process time
        owners = {s: self._slot_req[s] for s in active}
        self.pos += k
        return {"toks": self._fetch(self._out[:k]), "k": k,
                "owners": owners, "emit_from": emit_from,
                "timed": self._take_timed()}

    def _process_chunk(self, chunk) -> list[tuple[int, list[int], bool]]:
        """Fetch a dispatched chunk's tokens (the host sync) and route
        them: request outputs, EOS and budget retirement, slot frees."""
        with span("batch.wait"):
            host = _host(chunk["toks"])  # (k, S)
        self._settle(chunk["timed"])
        with span("batch.route"):
            return self._route_chunk(chunk, host)

    def _route_chunk(self, chunk, host: np.ndarray):
        k = chunk["k"]
        results = []
        now = time.time()
        for s, req in chunk["owners"].items():
            if self._slot_req[s] is not req or req.done:
                continue  # retired while this chunk was in flight
            new = []
            for step_i in range(chunk["emit_from"][s], k):
                t = int(host[step_i, s])
                finished = self.scheduler.on_token(s, t == EOS_TOKEN)
                if t != EOS_TOKEN:
                    new.append(t)
                if finished:
                    req.done = True
                    req.finish_t = now
                    self._slot_req[s] = None
                    self._pending[s] = []
                    break
            if new:
                self._carry[s] = new[-1]  # keeps spec blocks in step
                if req.first_token_t is None:
                    req.first_token_t = now
            req.out.extend(new)
            if new or req.done:
                results.append((req.id, new, req.done))
        return results

    def step(self) -> list[tuple[int, list[int], bool]]:
        """Admit and run one decode chunk (or speculative round),
        synchronously. Returns [(request_id, new_tokens, finished)] for
        every request that produced tokens or finished."""
        with span("batch.step"):
            if self.spec:
                return self._step_spec() or []
            chunk = self._dispatch_chunk()
            return self._process_chunk(chunk) if chunk else []

    @property
    def pending(self) -> int:
        return self.scheduler.num_active + self.scheduler.num_queued

    def run(self, max_chunks: int = 10_000) -> dict[int, list[int]]:
        """Drain all queued and active requests. Plain decode keeps one
        chunk of lookahead: chunk N+1 is queued on the device before the
        host fetches and routes chunk N's tokens (a retired slot is reused
        one chunk late). Speculative rounds are synchronous: each block's
        inputs depend on the previous block's acceptance."""
        if self.spec:
            rounds = 0
            while self.pending and rounds < max_chunks:
                with span("batch.step"):
                    if self._step_spec() is None:
                        break
                rounds += 1
            return {rid: r.out for rid, r in self._requests.items()}
        chunks = 0
        in_flight = None
        while chunks < max_chunks:
            with span("batch.step"):
                nxt = self._dispatch_chunk() if self.pending else None
                if in_flight is None and nxt is None:
                    break
                if in_flight:
                    self._process_chunk(in_flight)
            in_flight = nxt
            chunks += 1
        if in_flight:
            with span("batch.step"):
                self._process_chunk(in_flight)
        return {rid: r.out for rid, r in self._requests.items()}

    def stats(self) -> dict:
        reqs = [r for r in self._requests.values() if r.done]
        total_tokens = sum(len(r.out) for r in reqs)
        if not reqs:
            return {"finished": 0, "total_tokens": 0}
        t0 = min(r.submit_t for r in reqs)
        t1 = max(r.finish_t for r in reqs)
        lat = [r.finish_t - r.submit_t for r in reqs]
        out = {
            "finished": len(reqs),
            "total_tokens": total_tokens,
            "wall_s": t1 - t0,
            "tok_per_s": total_tokens / (t1 - t0) if t1 > t0 else 0.0,
            "mean_latency_s": sum(lat) / len(lat),
            "max_latency_s": max(lat),
        }
        if self.spec:
            st = dict(self.spec_stats)
            if st["proposed"]:
                st["accept_rate"] = round(st["accepted"] / st["proposed"], 4)
            out["spec"] = st
        if self.prefix_cache is not None:
            pc = self.prefix_cache
            out["prefix_cache"] = {
                "hits": pc.hits, "misses": pc.misses,
                "rows_saved": pc.rows_saved, "entries": len(pc._entries)}
        return out
