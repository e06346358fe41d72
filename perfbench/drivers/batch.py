"""Closed-loop clients through BatchEngine.submit and step.

Each client sends its next request as soon as its last one has finished,
with no think time. The loop runs ramp_s seconds before the window opens,
so that the window starts on a busy engine; then the window's steps for
`seconds` (in a traced run, and until the traced part, trace_s seconds
from one second in, has ended); then, with no more requests sent, steps until every request
sent in the window has finished (the drain), so that each one's first
token and the sample for the check are there. Every step is one
engine.step(): it admits, advances each long prompt by a block, runs one
chunk of decode steps, and returns the tokens back on the host.

- output_tok_s: the tokens the window's steps returned, over the time
  from the window's first step's start to its last step's end.
- ttft_p95_ms: over every request sent in the window, from its
  submission to the end of the step that returned its first token.
- tpot_p95_ms: over every request that finished in the window with two
  tokens or more, (last token's time - first token's time) / (tokens -
  1).
"""

from __future__ import annotations

from perfbench import port
from perfbench.drivers.common import (Record, Rows, bucket, now, p95,
                                      prompt_blocks)
from perfbench.traffic import Traffic

DRAIN_S = 120.0
TRACE_LEAD_S = 1.0


class Driver:
    def __init__(self, shape, mix, weights, seed, device):
        self.shape, self.mix, self.w, self.device = shape, mix, weights, device
        self.seed = seed
        self.traffic = Traffic(mix, seed, shape.vocab)
        self.records: dict[int, Record] = {}
        self.rows = Rows()

    # -- shapes ------------------------------------------------------------

    def prefill_keys(self, length: int) -> set:
        if length <= self.forced_max:
            return set()
        return {(T, bucket(self.buckets, pos + T)) for pos, T, _ in
                prompt_blocks(length - 1, self.block, self.mix["max_seq"])}

    def rounds(self) -> list:
        """Warm-up rounds: (prompt length, temperature), each sent to
        every slot at once with one token to answer, so that each slot's
        prefill graphs and the chunk graphs of every window and sampling
        flavour the mix can reach are captured before the window."""
        mx, k = self.mix["max_seq"], self.mix["chunk"]
        pool, outs = self.traffic.prompts, self.traffic.outputs
        starts = [k if L <= self.forced_max else L - 1 + k for L in pool]
        hi = min(mx, max(pool) - 1 + max(outs) - 1 + k)
        wins = [b for b in self.buckets
                if bucket(self.buckets, min(starts)) <= b
                <= bucket(self.buckets, hi)]
        share = float(self.mix["greedy_share"])
        temps = ([0.0] if share > 0 else []) + \
            ([float(self.mix["temperature"])] if share < 1 else [])
        rounds = [(min(b - k + 1, mx - 1), t) for b in wins for t in temps]
        have = set().union(*(self.prefill_keys(L) for L, _ in rounds))
        for L in sorted(set(pool)):
            if self.prefill_keys(L) - have:
                rounds.append((L, temps[0]))
                have |= self.prefill_keys(L)
        return rounds

    def setup(self):
        port.prebuild()
        self.block = port.block()
        self.forced_max = port.forced_prompt_max()
        self.buckets = port.buckets(self.mix["max_seq"])
        self.engine = port.batch_engine(self.w, self.mix, self.seed,
                                        self.device)
        eng = self.engine
        for L, temp in self.rounds():
            for _ in range(self.mix["slots"]):
                eng.submit(self.traffic.prompt_of(L), max_new=1,
                           temperature=temp)
            while eng.pending:
                eng.step()
        self.warm_graphs = port.graphs_held(eng)

    # -- the window ----------------------------------------------------------

    def _send(self, t: float, in_window: bool):
        req = self.traffic.next()
        rid = self.engine.submit(req.prompt, max_new=req.max_new,
                                 temperature=req.temperature, topp=req.top_p)
        self.records[rid] = Record(req, t, in_window)

    def window(self, seconds: float, tracer=None) -> dict:
        eng, mix = self.engine, self.mix
        t_ramp = now()
        for _ in range(mix["clients"]):
            self._send(t_ramp, False)
        phase, t0, t_close, t1 = "ramp", None, None, None
        tokens = 0
        tracing = False
        t_trace = None
        while True:
            t_s = now()
            if phase == "ramp" and t_s - t_ramp >= mix["ramp_s"]:
                phase, t0 = "window", t_s
            owed = tracer is not None and not tracer.stopped
            if phase == "window" and t_s - t0 >= seconds and (
                    not owed or t_s - t0 >= seconds + DRAIN_S):
                phase, t_close = "drain", t_s
            if tracing and phase == "drain":
                tracer.stop()
                tracing = False
            if (tracer is not None and not tracer.started
                    and phase == "window"
                    and (t_s - t0 >= TRACE_LEAD_S or seconds <= 2 * TRACE_LEAD_S)):
                tracer.start()
                tracing, t_trace = True, now()
            if phase == "drain" and all(
                    r.done for r in self.records.values() if r.in_window):
                break
            if phase == "drain" and t_s - t_close > DRAIN_S:
                break
            if phase == "window":
                self.rows.active_slots.append(eng.scheduler.num_active)
            results = eng.step()
            t_e = now()
            if phase == "window":
                t1 = t_e
            for rid, new, fin in results:
                rec = self.records.get(rid)
                if rec is None:
                    continue
                if new:
                    first = rec.first_t is None
                    if first:
                        rec.first_t = t_e
                    if tracing:
                        self._count(rec, len(rec.tokens), len(new), first)
                    rec.tokens += new
                    rec.last_t = t_e
                    if phase == "window":
                        tokens += len(new)
                if fin:
                    rec.done = True
                    rec.last_t = rec.last_t or t_e
                    if phase != "drain":
                        self._send(t_e, phase == "window")
            if tracing and t_e - t_trace >= mix["trace_s"]:
                tracer.stop()
                tracing = False
        self.graphs_after = port.graphs_held(eng)
        sent = [r for r in self.records.values() if r.in_window]
        ttft = [(r.first_t - r.submit_t) * 1e3 for r in sent
                if r.first_t is not None]
        tpot = [(r.last_t - r.first_t) * 1e3 / (len(r.tokens) - 1)
                for r in self.records.values()
                if r.done and len(r.tokens) >= 2 and t0 <= r.last_t <= t1]
        return {"t0": t0, "t1": t1, "attempted": len(sent),
                "failed": sum(not r.done for r in sent),
                "output_tok_s": tokens / (t1 - t0), "output_tokens": tokens,
                "ttft_p95_ms": p95(ttft), "tpot_p95_ms": p95(tpot),
                "requests": len(sent), "ttft_samples": len(ttft),
                "tpot_samples": len(tpot)}

    def _count(self, rec: Record, before: int, new: int, first: bool):
        """The rows behind a traced step's tokens for one request: its
        decode rows, and with its first token the rows of its prompt (the
        forced ones, or the padding and the single-token last block of its
        prompt blocks)."""
        L = len(rec.req.prompt)
        rows = self.rows.rows
        rows += [("t1", L - 1 + before + j, True, True) for j in range(new)]
        if not first:
            return
        if L <= self.forced_max:
            rows += [("t1", p, False, True) for p in range(L - 1)]
            return
        for pos, T, m in prompt_blocks(L - 1, self.block,
                                       self.mix["max_seq"])[-1:]:
            if T == 1:
                rows.append(("t1", pos, False, True))
            else:
                self.rows.block_padding += T - m

    def served(self):
        from perfbench.judge import Served
        return [Served(r.req.prompt, list(r.tokens))
                for r in self.records.values() if r.done and r.req.greedy]

    def free(self):
        self.engine = None
