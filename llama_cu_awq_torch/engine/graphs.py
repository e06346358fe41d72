"""CUDA graphs of the engine's step bodies: captured once, then replayed.

The counterpart of the JAX engine's engine_jit cache of compiled
executables (llama_cu_awq_tpu/engine/engine.py:89-153): where jit compiles
one executable per function and static arguments and the host dispatches
a whole lax.scan with one call, a GraphSet captures one CUDA graph per key
and the host replays a step, a forced prompt token, a prefill block, a
speculative verify or, in BatchEngine, a chunk step, a slot's prefill
block or a spec block with one graph launch, no Python launch per
kernel.

A body reads and writes only tensors of fixed address: the engine's step
state and output buffers, the cache and the weights. A graph replays the
body's launches with the arguments they had when it was captured, so
whatever the host decided then (forward's plan, the window, the shapes)
belongs in the key. The rules:

- the first call of a key runs the body eagerly on the current stream (a
  real step, counted by the wrappers as ever), then captures it on the
  set's own stream; a capture runs nothing;
- under tensor parallelism the capture splits at the collectives (the
  JAX TP step is one compiled program, collectives included,
  llama_cu_awq_tpu/engine/engine.py:166-178, 265-326): a collective the
  body calls (parallel/mesh.py all_reduce_sum, all_gather_last) ends the
  segment being captured, is recorded as a step that runs it on the very
  tensors it was given, and the next segment's capture begins in the
  same pool. A replay runs segment 0, collective 0, segment 1, ... on
  the current stream, the segments back to back: a T=1 step of a model
  of L layers is 2L + 2 segments around 2L all-reduces and the logits'
  gather. A body with no collective is one segment. The tensors a
  collective holds stay allocated as long as the graph, and every other
  tensor that crosses a split is alive in the capture when the next
  segment's allocations are made, so no segment reuses memory another
  still reads. Every rank takes the same keys in the same order (the
  keys depend only on the plan, the window and T, which the ranks
  compute alike): the first call's collectives run live, a capture runs
  none, and the replays' pair up;
- the graphs of a set share one memory pool, where a body's temporaries
  live at fixed addresses. Every result a caller reads is copied into a
  static buffer inside the body, never read from the pool, so the graphs
  may replay in any order, one at a time on one stream (the segments of
  one graph always back to back, in the order they were captured);
- the split attention kernels' scratch is kept per stream
  (ops/cuda/attention_step.split_scratch) and may not grow during a
  capture; `reserve` sizes it on the capture stream, for the largest
  batch and window and the rank's heads, before the first capture, and a
  capture that would grow it raises;
- the launches a body counts while it is captured are taken back from
  ops.cuda's counters and added again at every replay of its segment
  (add_launches), so LAUNCHES and VARIANT_LAUNCHES read as if each
  kernel had been launched from Python; REPLAYS counts the graphs and
  segments replayed, and CAPTURES the graphs captured and the seconds
  their captures took (Graph.capture_seconds), always, since captures
  happen in set-up; a capture is the span graph.capture of a trace
  (utils/profiling.py);
- the cyclic garbage collector is off while any capture runs
  (`collector_off`): a collection inside a capture may free an old
  engine's graphs, and destroying a graph is a call a capture does not
  allow (it invalidates the capture);
- nothing here catches an error: a body that cannot be captured raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
from typing import Callable

import torch

from llama_cu_awq_torch.ops.cuda import (LAUNCHES, VARIANT_LAUNCHES,
                                         add_launches)
from llama_cu_awq_torch.parallel.mesh import split_at_collectives
from llama_cu_awq_torch.utils.profiling import span

Launches = tuple[dict[str, int], dict[str, int]]

# graphs replayed, and the segments they replayed
REPLAYS = {"graphs": 0, "segments": 0}
# graphs captured, and the seconds their captures took
CAPTURES = {"graphs": 0, "seconds": 0.0}


def _take_back(k0: dict, v0: dict) -> Launches:
    """The launches counted since the counters read (k0, v0), taken back
    from the counters."""
    kernels = {k: n - k0[k] for k, n in LAUNCHES.items() if n != k0[k]}
    variants = {k: n - v0.get(k, 0) for k, n in VARIANT_LAUNCHES.items()
                if n != v0.get(k, 0)}
    add_launches({k: -n for k, n in kernels.items()},
                 {k: -n for k, n in variants.items()})
    return kernels, variants


def record_launches(fn: Callable[[], object]) -> tuple[object, Launches]:
    """Run fn(); return its result and the launches it counted, per kernel
    and per variant, with the counters left as they were before."""
    k0, v0 = dict(LAUNCHES), dict(VARIANT_LAUNCHES)
    out = fn()
    return out, _take_back(k0, v0)


# captures in progress in this process, over every thread (serving runs
# one engine thread per replica): the collector is process-wide
_CAPTURING = {"count": 0, "was_enabled": False}
_CAPTURING_LOCK = threading.Lock()
# one GraphSet.capture at a time in this process: its synchronize and
# empty_cache must not meet another thread's capture under way (a
# capture waits for no other rank, so this lock cannot deadlock a group)
_ONE_CAPTURE = threading.Lock()


@contextlib.contextmanager
def collector_off():
    """The cyclic garbage collector off from the first capture in progress
    to the end of the last, then as it was before."""
    with _CAPTURING_LOCK:
        if _CAPTURING["count"] == 0:
            _CAPTURING["was_enabled"] = gc.isenabled()
            gc.disable()
        _CAPTURING["count"] += 1
    try:
        yield
    finally:
        with _CAPTURING_LOCK:
            _CAPTURING["count"] -= 1
            if _CAPTURING["count"] == 0 and _CAPTURING["was_enabled"]:
                gc.enable()


@dataclasses.dataclass
class Graph:
    """One captured body: its first segment and the launches a replay of
    it stands for, what capturing the body cost (seconds on the host
    clock and the bytes the shared pool grew by), and after the first
    segment, each collective the body called with the segment captured
    after it."""

    graph: object  # torch.cuda.CUDAGraph
    launches: Launches
    capture_seconds: float
    pool_bytes: int
    # (the collective, the next segment, its launches)
    splits: list = dataclasses.field(default_factory=list)

    @property
    def segments(self) -> int:
        return 1 + len(self.splits)

    def replay(self) -> None:
        self.graph.replay()
        add_launches(*self.launches)
        for collective, graph, launches in self.splits:
            collective()
            graph.replay()
            add_launches(*launches)
        REPLAYS["graphs"] += 1
        REPLAYS["segments"] += 1 + len(self.splits)


class GraphSet:
    """An engine's graphs, keyed by the caller, on one device."""

    def __init__(self, device: torch.device, reserve: Callable[[], None]):
        """reserve(): sizes what a capture may not grow (the split
        kernels' scratch), run on the capture stream."""
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: dict[tuple, Graph] = {}
        with torch.cuda.stream(self.stream):
            reserve()
        torch.cuda.current_stream(device).wait_stream(self.stream)

    def run(self, key: tuple, body: Callable[[], None], n: int = 1) -> None:
        """body() n times on the current stream: a key's first call runs
        it eagerly and captures it, every later one replays the graph."""
        if n <= 0:
            return
        g = self.graphs.get(key)
        if g is None:
            body()
            n -= 1
            g = self.graphs[key] = self.capture(body)
        for _ in range(n):
            g.replay()

    def capture(self, body: Callable[[], None]) -> Graph:
        """A graph of body()'s launches, on this set's stream and pool,
        split at its collectives: one synchronize and one reading of the
        pool a key, whatever its segments."""
        with span("graph.capture"), _ONE_CAPTURE:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            with torch.cuda.stream(self.stream):
                g = self.split_capture(body)
            torch.cuda.synchronize(self.device)
            g.capture_seconds = time.perf_counter() - t0
            g.pool_bytes = (torch.cuda.memory_reserved(self.device)
                            - reserved)
            CAPTURES["graphs"] += 1
            CAPTURES["seconds"] += g.capture_seconds
        return g

    def begin_segment(self):
        """A CUDA graph capturing on the current stream into the pool
        (capture_end() ends it)."""
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool,
                            capture_error_mode="thread_local")
        return graph

    def split_capture(self, body: Callable[[], None]) -> Graph:
        """body() captured as segments split at the collectives it calls
        from this thread (see the module docstring)."""
        done = []  # (the collective before it or None, segment, launches)
        cur = {"before": None, "graph": None, "counts": None}

        def begin(before):
            cur["before"] = before
            cur["graph"] = self.begin_segment()
            cur["counts"] = dict(LAUNCHES), dict(VARIANT_LAUNCHES)

        def end():
            cur["graph"].capture_end()
            done.append((cur["before"], cur["graph"],
                         _take_back(*cur["counts"])))

        def split(collective):
            end()
            begin(collective)

        with collector_off(), split_at_collectives(split):
            begin(None)
            try:
                body()
            except BaseException:
                # the body's error, not the unfinished capture's
                with contextlib.suppress(RuntimeError):
                    cur["graph"].capture_end()
                raise
            end()
        (_, first, launches), rest = done[0], done[1:]
        return Graph(first, launches, 0.0, 0, rest)
