"""Profiling hooks: the counterpart of llama_cu_awq_tpu/utils/profiling.py.

`profile_trace(dir)` wraps any engine call in torch.profiler: the host's
operations, and the card's kernels and copies where there is a card. When
the block ends it writes a Chrome trace (chrome://tracing or Perfetto) to
dir/TRACE_FILE, where the gaps between the card's operations show how long
the host kept it idle. The CLI's `--profile DIR` runs the whole command
under it.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch

TRACE_FILE = "trace.json"


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
