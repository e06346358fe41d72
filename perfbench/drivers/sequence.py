"""One client through InferenceEngine.generate_benchmark: a request's
prompt is prefilled (forced single steps below half a block, blocks
from there) and its tokens decoded in device chunks; the next request
starts when the last one's tokens are back.

The window runs requests until `seconds` have passed and then ends with
the request under way, so the rate counts every request it started; a
traced run traces whole requests, from the window's second on, until it
has held one of each prompt path and trace_s seconds, starting where the
next request takes the other path."""

from __future__ import annotations

from perfbench import port
from perfbench.drivers.common import (Record, Rows, bucket, cover, now,
                                      prompt_blocks)
from perfbench.traffic import Traffic


class Driver:
    def __init__(self, shape, mix, weights, seed, device):
        if float(mix["greedy_share"]) != 1.0:
            raise ValueError("the sequence driver serves greedy requests "
                             "only (greedy_share 1)")
        self.shape, self.mix, self.w, self.device = shape, mix, weights, device
        self.traffic = Traffic(mix, seed, shape.vocab)
        self.records: list[Record] = []
        self.rows = Rows()

    # -- shapes ----------------------------------------------------------

    def _forced(self, n: int) -> bool:
        return n < self.block // 2

    def keys(self, length: int, out: int) -> set:
        """The graphs a request of this prompt length and output asks
        the engine for."""
        mx, k0 = self.mix["max_seq"], self.mix["chunk"]
        n, keys = length - 1, set()
        if n and self._forced(n):
            keys.add(("forced", bucket(self.buckets, n)))
        elif n:
            blocks = prompt_blocks(n, self.block, mx)
            for i, (pos, T, m) in enumerate(blocks):
                keys.add(("prompt", i == len(blocks) - 1, T,
                          bucket(self.buckets, pos + T)))
        pos, left = n, out
        while left > 0 and pos < mx:
            k = min(k0, left, mx - pos)
            keys.add(("decode", bucket(self.buckets, pos + k)))
            pos, left = pos + k, left - k
        return keys

    def setup(self):
        port.prebuild()
        self.block = port.block()
        self.buckets = port.buckets(self.mix["max_seq"])
        self.engine = port.sequence_engine(self.w, self.mix, self.device)
        out = max(self.traffic.outputs)
        needs = {L: self.keys(L, out) for L in set(self.traffic.prompts)}
        for L in cover(needs):
            self._generate(self.traffic.prompt_of(L), out)
        self.warm_graphs = port.graphs_held(self.engine)

    def _generate(self, prompt, out):
        toks, _, _ = self.engine.generate_benchmark(
            prompt, len(prompt) + out - 1)
        return toks

    # -- the window --------------------------------------------------------

    def window(self, seconds: float, tracer=None) -> dict:
        t0 = now()
        self.t0 = t0
        tracing, seen, t_trace, upcoming = False, set(), None, None
        while True:
            t = now()
            owed = tracer is not None and not tracer.stopped
            if t - t0 >= seconds and not owed:
                break
            if t - t0 >= seconds + 60.0:
                break  # a traced window that never met both paths
            req, upcoming = upcoming or self.traffic.next(), None
            if tracer is not None and not tracer.started \
                    and len(self.records) >= 1:
                # start where the next request takes the other prompt path,
                # so that two requests hold both
                upcoming = self.traffic.next()
                if (self._forced(len(req.prompt) - 1)
                        != self._forced(len(upcoming.prompt) - 1)):
                    tracer.start()
                    tracing, t_trace = True, now()
            rec = Record(req, now(), in_window=True)
            rec.tokens = self._generate(req.prompt, req.max_new)
            rec.first_t = rec.last_t = now()
            rec.done = True
            self.records.append(rec)
            if tracing:
                self._count(rec)
                seen.add(self._forced(len(req.prompt) - 1))
                if len(seen) == 2 and now() - t_trace >= self.mix["trace_s"]:
                    tracer.stop()
                    tracing = False
        if tracing:
            tracer.stop()
        t1 = self.records[-1].last_t
        n = sum(len(r.tokens) for r in self.records)
        self.graphs_after = port.graphs_held(self.engine)
        return {"t0": t0, "t1": t1, "attempted": len(self.records),
                "failed": 0, "b1_tok_s": n / (t1 - t0),
                "output_tokens": n, "requests": len(self.records),
                "thirds": self.thirds(t0, t1)}

    def thirds(self, t0: float, t1: float) -> list[float]:
        """The rate over each third of the window: whether a run's rate
        moves inside the run, or only from one run to the next."""
        edges = [t0 + (t1 - t0) * i / 3 for i in range(4)]
        toks = [0.0, 0.0, 0.0]
        for r in self.records:
            span = r.last_t - r.submit_t
            for i in range(3):
                inside = min(r.last_t, edges[i + 1]) - max(r.submit_t,
                                                           edges[i])
                if inside > 0 and span > 0:
                    toks[i] += len(r.tokens) * inside / span
        return [x / ((t1 - t0) / 3) for x in toks]

    def _count(self, rec: Record):
        """The rows of a traced request: every row of its one-token
        passes, the padding of its prompt blocks, and the row of a block
        that runs the head (the blocks' own rows are counted from the
        launch counters)."""
        n = len(rec.req.prompt) - 1
        rows = self.rows.rows
        if self._forced(n):
            rows += [("t1", p, False, True) for p in range(n)]
        else:
            blocks = prompt_blocks(n, self.block, self.mix["max_seq"])
            for i, (pos, T, m) in enumerate(blocks):
                last = i == len(blocks) - 1
                if T == 1:
                    rows.append(("t1", pos, last, True))
                    continue
                if last:  # the head runs on the prompt's last row
                    rows.append(("block", pos + m - 1, True, False))
                self.rows.block_padding += T - m
        rows += [("t1", n + i, True, True) for i in range(len(rec.tokens))]

    def served(self):
        from perfbench.judge import Served
        return [Served(r.req.prompt, list(r.tokens)) for r in self.records
                if r.done and r.req.greedy]

    def free(self):
        self.engine = None
