"""The general generator over the committed mixes."""

import json
import os
from collections import Counter

import numpy as np
import pytest

from perfbench.traffic import (BOS, FIRST_ID, Traffic, quantile,
                               strata_values)

MIXES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mixes")
NAMES = sorted(f[:-5] for f in os.listdir(MIXES) if f.endswith(".json"))


def load(name):
    with open(os.path.join(MIXES, f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", NAMES)
def test_lengths_lie_in_the_mix(name):
    mix = load(name)
    t = Traffic(mix, 2**31 + 99, 32000)
    for _ in range(3 * t.n):
        r = t.next()
        assert mix["prompt"]["min"] <= len(r.prompt) <= mix["prompt"]["max"]
        assert r.prompt[0] == BOS
        assert all(FIRST_ID <= x < 32000 for x in r.prompt[1:])
        if mix["output"]["dist"] == "fixed":
            assert r.max_new == mix["output"]["value"]
        else:
            assert mix["output"]["min"] <= r.max_new <= mix["output"]["max"]
        assert len(r.prompt) + 1 <= mix["max_seq"]


@pytest.mark.parametrize("name", NAMES)
def test_a_seed_repeats_and_every_seed_sends_the_same_sizes(name):
    mix = load(name)
    a, b = Traffic(mix, 7 * 2**31, 32000), Traffic(mix, 7 * 2**31, 32000)
    c = Traffic(mix, 5, 32000)
    ra = [a.next() for _ in range(2 * a.n)]
    rb = [b.next() for _ in range(2 * b.n)]
    rc = [c.next() for _ in range(2 * c.n)]
    assert [(r.prompt, r.max_new, r.temperature) for r in ra] == \
        [(r.prompt, r.max_new, r.temperature) for r in rb]
    # the sizes and the sampling in the same order, other token ids
    assert [(len(r.prompt), r.max_new, r.greedy) for r in ra] == \
        [(len(r.prompt), r.max_new, r.greedy) for r in rc]
    assert [r.prompt for r in ra] != [r.prompt for r in rc]
    # one round holds every stratum once
    for key in (lambda r: len(r.prompt), lambda r: r.max_new,
                lambda r: r.greedy):
        assert Counter(map(key, ra[:a.n])) == Counter(map(key, ra[a.n:]))


def test_the_order_comes_from_the_mix():
    mix = dict(load("serve_long"), order_seed=2)
    a, b = Traffic(load("serve_long"), 3, 64000), Traffic(mix, 3, 64000)
    assert [len(a.next().prompt) for _ in range(16)] != \
        [len(b.next().prompt) for _ in range(16)]


def test_greedy_share():
    mix = load("serve_long")
    t = Traffic(mix, 3, 64000)
    assert sum(t.next().greedy for _ in range(t.n)) == round(
        t.n * mix["greedy_share"])


def test_strata_values():
    rng = np.random.default_rng(0)
    v = strata_values({"dist": "uniform", "min": 0, "max": 100}, 4, rng)
    assert [i * 25 <= x <= (i + 1) * 25 for i, x in enumerate(v)] == \
        [True] * 4
    spec = {"dist": "lognormal", "median": 64, "sigma": 0.75, "min": 16,
            "max": 384}
    v = strata_values(spec, 16, rng)
    assert v == sorted(v) and v[7] <= 64 <= v[8]
    assert strata_values({"dist": "fixed", "value": 5}, 3, rng) == [5, 5, 5]


@pytest.mark.parametrize("name", NAMES)
def test_each_stratum_draws_from_its_whole_range(name):
    """A value lies inside its stratum's quantiles, so the top stratum's
    comes from the tail beyond the midpoint's quantile about half the
    time, and over many draws reaches the clip."""
    mix = load(name)
    n = int(mix["strata"])
    for key in ("prompt", "output"):
        spec = mix[key]
        top = []
        for seed in range(64):
            v = strata_values(spec, n, np.random.default_rng(seed))
            for i, x in enumerate(v):
                assert quantile(spec, i / n + 1e-12) <= x <= \
                    quantile(spec, (i + 1) / n - 1e-12)
            top.append(v[-1])
        if spec["dist"] != "fixed":
            assert max(top) == quantile(spec, 1 - 1e-12)
            assert min(top) <= quantile(spec, 1 - 0.5 / n) <= max(top)
