"""device_idle_share in the batch-1 cells, where it moves b1_tok_s: the reader of
metrics/device_idle_share.py."""

from perfbench.metrics.device_idle_share import read  # noqa: F401
