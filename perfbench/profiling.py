"""Tracing with torch.profiler.

A copy of llama_cu_awq_torch/utils/profiling.py `profile_trace`, kept
here so that the yardstick does not move with the program, split in two:
`start` begins tracing the host's operations and the card's kernels and
copies; the caller stops the session, and `write` writes its Chrome
trace to dir/TRACE_FILE, so that a run can write it after its window.
"""

from __future__ import annotations

import os

import torch

TRACE_FILE = "trace.json"


def start():
    """A started torch.profiler session: the host, and the card where
    there is one."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def write(prof, log_dir: str) -> str:
    """Write a stopped session's trace; returns the file's path."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path
