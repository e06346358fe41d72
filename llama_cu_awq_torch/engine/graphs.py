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
- the graphs of a set share one memory pool, where a body's temporaries
  live at fixed addresses. Every result a caller reads is copied into a
  static buffer inside the body, never read from the pool, so the graphs
  may replay in any order, one at a time on one stream;
- the split attention kernels' scratch is kept per stream
  (ops/cuda/attention_step.split_scratch) and may not grow during a
  capture; `reserve` sizes it on the capture stream, for the largest
  batch and window, before the first capture, and a capture that would
  grow it raises;
- the launches a body counts while it is captured are taken back from
  ops.cuda's counters and added again at every replay (add_launches), so
  LAUNCHES and VARIANT_LAUNCHES read as if each kernel had been launched
  from Python;
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

Launches = tuple[dict[str, int], dict[str, int]]


def record_launches(fn: Callable[[], object]) -> tuple[object, Launches]:
    """Run fn(); return its result and the launches it counted, per kernel
    and per variant, with the counters left as they were before."""
    k0, v0 = dict(LAUNCHES), dict(VARIANT_LAUNCHES)
    out = fn()
    kernels = {k: n - k0[k] for k, n in LAUNCHES.items() if n != k0[k]}
    variants = {k: n - v0.get(k, 0) for k, n in VARIANT_LAUNCHES.items()
                if n != v0.get(k, 0)}
    add_launches({k: -n for k, n in kernels.items()},
                 {k: -n for k, n in variants.items()})
    return out, (kernels, variants)


# captures in progress in this process, over every thread (serving runs
# one engine thread per replica): the collector is process-wide
_CAPTURING = {"count": 0, "was_enabled": False}
_CAPTURING_LOCK = threading.Lock()


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
    """One captured body, the launches each replay stands for, and what
    capturing it cost: seconds on the host clock and the bytes the shared
    pool grew by."""

    graph: object  # torch.cuda.CUDAGraph
    launches: Launches
    capture_seconds: float
    pool_bytes: int

    def replay(self) -> None:
        self.graph.replay()
        add_launches(*self.launches)


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
        """A graph of body()'s launches, on this set's stream and pool."""
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with collector_off(), torch.cuda.graph(
                graph, pool=self.pool, stream=self.stream,
                capture_error_mode="thread_local"):
            _, launches = record_launches(body)
        torch.cuda.synchronize(self.device)
        return Graph(graph, launches, time.perf_counter() - t0,
                     torch.cuda.memory_reserved(self.device) - reserved)
