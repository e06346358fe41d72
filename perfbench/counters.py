"""The program's own counters, read where it keeps them, and None where
it keeps no such record (an older program): its tracing counters
(llama_cu_awq_torch.utils.profiling counters(), which count only while
the profiler runs, so after a traced run they hold the traced part of
its window) and its graph captures (engine.graphs CAPTURES, counted
always)."""

from __future__ import annotations


def tracing() -> dict | None:
    from llama_cu_awq_torch.utils import profiling
    fn = getattr(profiling, "counters", None)
    return fn() if fn is not None else None


def captures() -> dict | None:
    from llama_cu_awq_torch.engine import graphs
    c = getattr(graphs, "CAPTURES", None)
    return dict(c) if c is not None else None
