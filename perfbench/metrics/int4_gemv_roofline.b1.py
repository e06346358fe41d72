"""int4_gemv_roofline in the batch-1 cells, where it moves b1_tok_s: the reader of
metrics/int4_gemv_roofline.py."""

from perfbench.metrics.int4_gemv_roofline import read  # noqa: F401
