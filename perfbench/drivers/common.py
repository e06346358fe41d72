"""What both drivers share: the host clock, percentiles, the record of
a request and the rows a traced window computed."""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from perfbench.traffic import Request


def now() -> float:
    return time.perf_counter()


def p95(values) -> float | None:
    return float(np.percentile(np.asarray(values, float), 95)) \
        if len(values) else None


@dataclasses.dataclass
class Record:
    req: Request
    submit_t: float
    in_window: bool = False
    tokens: list = dataclasses.field(default_factory=list)
    first_t: float | None = None
    last_t: float | None = None
    done: bool = False


@dataclasses.dataclass
class Rows:
    """What a traced window computed, from the harness's own records:
    rows (group, position, head, attend), group "t1" for every row of a
    one-token pass and "block" for a prompt block's row that runs the
    head; the padding rows of the prompt blocks (their real rows are the
    blocks the launch counters count, less this); and the scheduler's
    active slots before each step."""

    rows: list = dataclasses.field(default_factory=list)
    block_padding: int = 0
    active_slots: list = dataclasses.field(default_factory=list)


def prompt_blocks(n: int, block: int, max_seq: int):
    """The blocks an engine prefills n prompt tokens in from position 0:
    (start, T, real rows), a last single token as T = 1."""
    out, pos = [], 0
    while pos < n:
        m = min(block, n - pos)
        T = 1 if m == 1 else block
        if pos + T > max_seq:
            T, m = 1, 1
        out.append((pos, T, m))
        pos += m
    return out


def bucket(buckets: list[int], seq: int) -> int:
    for b in buckets:
        if seq <= b:
            return b
    return buckets[-1]


def cover(needs: dict) -> list:
    """A few of needs' keys (candidates) whose sets together hold every
    element of the union, largest new share first."""
    left = set().union(*needs.values()) if needs else set()
    chosen = []
    while left:
        best = max(needs, key=lambda c: (len(needs[c] & left), c))
        chosen.append(best)
        left -= needs[best]
    return chosen
