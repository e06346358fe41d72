"""Traffic from a mix file (mixes/<name>.json) and a seed.

A mix gives the distributions of prompt and output lengths (with the
published statistic each is taken from, under `source`), the share of
greedy requests and the sampling settings. Each distribution is cut
into `strata` equal-probability strata, and one value is drawn inside
each stratum, from the stratum's whole range of quantiles: the top
stratum's draw comes from the distribution's tail, up to the mix's clip.
Requests come in rounds of `strata`, and each round takes every stratum
once (prompt lengths, output lengths and the greedy flags each shuffled
on their own). The draws and the order come from the mix's own
`order_seed`, so every seed sends the same sizes in the same order, and
the run's seed draws the prompts' token ids (and the weights and the
sampling coins elsewhere): on the card the order of the sizes moved a
serving cell's rate by 10 % from seed to seed, the ids and weights by
3 % (PERF.md).
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

BOS = 1
FIRST_ID = 3  # prompt ids are drawn from [3, vocab): no BOS or EOS inside


@dataclasses.dataclass
class Request:
    index: int
    prompt: list[int]
    max_new: int
    temperature: float
    top_p: float

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def quantile(spec: dict, q: float) -> int:
    """spec's value at quantile q, rounded and clipped to its range."""
    kind = spec["dist"]
    if kind == "fixed":
        return int(spec["value"])
    if kind == "uniform":
        lo, hi = spec["min"], spec["max"]
        return int(round(lo + (hi - lo) * q))
    if kind == "lognormal":
        v = spec["median"] * math.exp(spec["sigma"] * NormalDist().inv_cdf(q))
        return int(round(min(max(v, spec["min"]), spec["max"])))
    raise ValueError(f"unknown distribution {kind!r}")


def strata_values(spec: dict, n: int, rng: np.random.Generator) -> list[int]:
    """One value drawn inside each of n equal-probability strata of spec,
    in the strata's order."""
    tiny = 1e-12
    return [quantile(spec, min(max((i + u) / n, tiny), 1.0 - tiny))
            for i, u in enumerate(rng.random(n))]


class Traffic:
    """The requests of one run, in order: `next()` gives the next."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix = mix
        self.n = int(mix["strata"])
        self.order = np.random.default_rng(int(mix["order_seed"]))
        self.prompts = strata_values(mix["prompt"], self.n, self.order)
        self.outputs = strata_values(mix["output"], self.n, self.order)
        n_greedy = int(round(self.n * float(mix["greedy_share"])))
        self.greedy = [i < n_greedy for i in range(self.n)]
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.count = 0
        self._round: list[tuple[int, int, bool]] = []

    def _new_round(self):
        p = self.order.permutation(self.n)
        o = self.order.permutation(self.n)
        g = self.order.permutation(self.n)
        self._round = [(self.prompts[p[i]], self.outputs[o[i]],
                        self.greedy[g[i]]) for i in range(self.n)][::-1]

    def next(self) -> Request:
        if not self._round:
            self._new_round()
        plen, out, greedy = self._round.pop()
        ids = self.rng.integers(FIRST_ID, self.vocab, size=plen - 1)
        req = Request(self.count, [BOS] + [int(t) for t in ids], out,
                      0.0 if greedy else float(self.mix["temperature"]),
                      float(self.mix["top_p"]))
        self.count += 1
        return req

    def prompt_of(self, length: int) -> list[int]:
        """A prompt of this many tokens for warming up, from its own
        stream so that the run's requests stay as drawn."""
        rng = np.random.default_rng(length)
        return [BOS] + [int(t) for t in rng.integers(FIRST_ID, self.vocab,
                                                      size=length - 1)]
