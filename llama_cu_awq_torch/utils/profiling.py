"""Profiling hooks: the counterpart of llama_cu_awq_tpu/utils/profiling.py.

`profile_trace(dir)` wraps any engine call in torch.profiler: the host's
operations, and the card's kernels and copies where there is a card. When
the block ends it writes a Chrome trace (chrome://tracing or Perfetto) to
dir/TRACE_FILE, where the gaps between the card's operations show how long
the host kept it idle. The CLI's `--profile DIR` runs the whole command
under it.

The program's own tracing has one switch, the profiler that is running
(profile_trace, the bench's --profile, or any torch.profiler session):

- `span(name)` is a torch.profiler.record_function while a session runs,
  so the engines' phases land in the same trace as the card's kernels, on
  its clock; otherwise one shared null context, and the only cost is the
  check of torch's flag;
- `count(name, n)` and `add_ms(name, ms)` add to COUNTERS only while a
  session runs, so after it the counters hold what it saw; `add(name, n)`
  adds whether or not one runs, for work a session saw launched and a
  later host sync settles; `counters()` is a copy of them and
  `reset_counters()` clears them.

The names the engines use (PERF.md lists each beside the metric it feeds):
spans batch.step > batch.admit, batch.prefill, batch.dispatch, batch.wait,
batch.route (engine/batch.py); seq.request > seq.reset, seq.prompt,
seq.decode, seq.wait (engine/engine.py); graph.capture
(engine/graphs.py). Counters, all in engine/batch.py:
attention_rows_active, attention_rows_parked, attention_steps,
attention_plain_steps; on the card prefill_device_ms, prefill_blocks,
decode_device_ms, decode_steps.
"""

from __future__ import annotations

import contextlib
import os
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_FILE = "trace.json"

COUNTERS: dict[str, float] = {}
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a torch.profiler session is running (torch's module flag,
    read at every call)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A named range of the trace while a session runs, else the shared
    null context."""
    if enabled():
        return torch.profiler.record_function(name)
    return _OFF


def add(name: str, n: float) -> None:
    COUNTERS[name] = COUNTERS.get(name, 0) + n


def count(name: str, n: int = 1) -> None:
    if enabled():
        add(name, n)


def add_ms(name: str, ms: float) -> None:
    if enabled():
        add(name, ms)


def counters() -> dict[str, float]:
    return dict(COUNTERS)


def reset_counters() -> None:
    COUNTERS.clear()


@contextmanager
def profile_trace(log_dir: str):
    """Trace the enclosed block; the trace is written even if it raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
