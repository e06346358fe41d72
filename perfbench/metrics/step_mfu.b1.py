"""step_mfu in the batch-1 cells, where it moves b1_tok_s: the reader of
metrics/step_mfu.py."""

from perfbench.metrics.step_mfu import read  # noqa: F401
