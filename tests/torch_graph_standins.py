"""Stand-ins for CUDA graphs, for holding engine/graphs.py's bookkeeping
and the engines' step bodies on the CPU.

Imports torch and the port only: tests/torch_tp_ranks.py's spawned ranks
import it too, and they never load JAX.
"""

from __future__ import annotations

import threading

import torch

from llama_cu_awq_torch.engine.graphs import Graph, GraphSet, record_launches
from llama_cu_awq_torch.ops.cuda import add_launches, count
from llama_cu_awq_torch.parallel.mesh import (COLLECTIVES, all_gather_last,
                                              all_reduce_sum)


class _Replays:
    """A stand-in for torch.cuda.CUDAGraph: counts its replays."""

    def __init__(self):
        self.n = 0

    def replay(self):
        self.n += 1


class _CountingSet(GraphSet):
    """GraphSet.run's bookkeeping with a stand-in capture (no stream, no
    pool): the body runs under record_launches as it does inside a
    capture, and the graph only counts its replays."""

    def __init__(self):
        self.graphs = {}

    def capture(self, body):
        _, launches = record_launches(body)
        return Graph(_Replays(), launches, 0.0, 0)


class _FirstBody:
    """A stand-in for torch.cuda.CUDAGraph: every replay runs the body its
    key was captured from, never the one the caller passes now, as a CUDA
    graph replays the launches and arguments it recorded. What the body
    counts is taken back: a replay launches nothing through the wrappers,
    and Graph.replay adds the capture's launches."""

    def __init__(self, body):
        self.body = body
        self.n = 0

    def replay(self):
        self.n += 1
        record_launches(self.body)


class _StaleSet(GraphSet):
    """GraphSet.run over _FirstBody graphs, on the CPU: an engine body
    that reads a tensor made for one call (a host snapshot, a position
    computed on the host) replays that first call's values, as a graph
    would, and the engine's streams part from the oracle's. A capture
    counts the launches of the key's first, eager call. Under tensor
    parallelism the first body's collectives run live at every replay,
    so the ranks' replays pair up as the split graphs' do."""

    def __init__(self):
        self.graphs = {}
        self._first = ({}, {})

    def run(self, key, body, n=1):
        if key not in self.graphs and n > 0:
            _, self._first = record_launches(body)
            add_launches(*self._first)  # it ran eagerly: counted
            self.graphs[key] = self.capture(body)
            n -= 1
        super().run(key, body, n)

    def capture(self, body):
        return Graph(_FirstBody(body), self._first, 0.0, 0)


class _Segment:
    """A stand-in for one captured segment: its replays are logged with
    the collectives run so far."""

    def __init__(self, log, i):
        self.log, self.i = log, i

    def capture_end(self):
        self.log.append(("end", self.i))

    def replay(self):
        self.log.append(("segment", self.i, dict(COLLECTIVES)))


class _SplitSet(GraphSet):
    """GraphSet.run and split_capture over stand-in segments, on the CPU
    (no stream, no pool): the body runs as it does in a capture, its
    collectives split it, and a replay logs each segment beside the
    collectives run before it."""

    def __init__(self):
        self.graphs = {}
        self.log = []
        self.begun = 0

    def begin_segment(self):
        self.begun += 1
        return _Segment(self.log, self.begun - 1)

    def capture(self, body):
        return self.split_capture(body)


def split_body(tp, x, z, out, during=None):
    """A TP step's shape: launches, an all-reduce of x, launches, another,
    a launch, the gather of z into out, a launch. during(), where given,
    runs between the two all-reduces (in a capture: inside segment 1)."""

    def body():
        count("int4_matmul_fused", "gemv/qkv")
        all_reduce_sum(x, tp)
        count("int4_matmul_fused", "gemv/o")
        count("attention_step", "bf16/B1")
        if during is not None:
            during()
        all_reduce_sum(x, tp)
        count("int4_matmul_fused", "gemv/down")
        out.copy_(all_gather_last(z, tp))
        count("dense_gemv", "bf16/m1")

    return body


def in_thread(fn):
    """fn() on another thread, joined; returns what it returned."""
    res = {}
    t = threading.Thread(target=lambda: res.setdefault("out", fn()))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    return res["out"]


def split_job(tp):
    """The split capture's bookkeeping on this rank (every rank runs the
    same): the eager call, the capture with an all-reduce on another
    thread inside segment 1, a replay, and a collective outside any
    capture. Returns what the tests check."""
    from llama_cu_awq_torch.ops.cuda import reset_launches
    from llama_cu_awq_torch.parallel.mesh import reset_collectives

    reset_launches()
    reset_collectives()
    x = torch.full((3,), float(tp.rank + 1))
    z = torch.tensor([float(tp.rank)])
    out = torch.zeros(tp.size)
    y = torch.ones(2)
    gs = _SplitSet()
    body = split_body(tp, x, z, out, during=lambda: in_thread(
        lambda: all_reduce_sum(y, tp)))
    res = {}
    gs.run(("step",), body, 1)  # eager, collectives live; then captured
    g = gs.graphs[("step",)]
    res["after_capture"] = dict(x=x.tolist(), y=y.tolist(),
                                collectives=dict(COLLECTIVES))
    res["segments"] = g.segments
    res["capture_log"] = list(gs.log)
    res["launches"] = [g.launches] + [sp[2] for sp in g.splits]
    gs.log.clear()
    before = dict(COLLECTIVES)
    gs.run(("step",), body, 1)  # a replay
    res["replay_log"] = list(gs.log)
    res["before_replay"] = before
    res["after_replay"] = dict(x=x.tolist(), collectives=dict(COLLECTIVES))
    w = torch.ones(1)
    all_reduce_sum(w, tp)  # outside a capture: at once
    res["outside"] = w.tolist()
    return res


def check_split_job(res, x_replayed):
    """split_job's result as the split capture must leave it: 4 segments
    ended in order, each holding its own launches; a replay runs segment
    0, all-reduce, segment 1, all-reduce, segment 2, gather, segment 3;
    the other thread's all-reduce and the one outside a capture ran at
    once. x_replayed: x after one replay (its two all-reduces)."""
    assert res["segments"] == 4
    assert res["capture_log"] == [("end", i) for i in range(4)]
    assert res["launches"] == [
        ({"int4_matmul_fused": 1}, {"int4_matmul_fused/gemv/qkv": 1}),
        ({"int4_matmul_fused": 1, "attention_step": 1},
         {"int4_matmul_fused/gemv/o": 1, "attention_step/bf16/B1": 1}),
        ({"int4_matmul_fused": 1}, {"int4_matmul_fused/gemv/down": 1}),
        ({"dense_gemv": 1}, {"dense_gemv/bf16/m1": 1})]
    # the eager call's 2 all-reduces and gather, and the other thread's
    # all-reduce in the eager call and in the capture; none of the
    # capture's own
    assert res["after_capture"]["collectives"] == {"all_reduce": 4,
                                                   "all_gather": 1,
                                                   "dp_gather": 0}
    assert res["after_capture"]["y"] == [4.0, 4.0]
    b = res["before_replay"]
    assert res["replay_log"] == [
        ("segment", 0, b),
        ("segment", 1, {**b, "all_reduce": b["all_reduce"] + 1}),
        ("segment", 2, {**b, "all_reduce": b["all_reduce"] + 2}),
        ("segment", 3, {**b, "all_reduce": b["all_reduce"] + 2,
                        "all_gather": b["all_gather"] + 1})]
    assert res["after_replay"]["x"] == [x_replayed] * 3
    assert res["outside"] == [2.0]
