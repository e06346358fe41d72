"""The card's milliseconds a prompt block of the batch engine: CUDA
events around each slot's prefill block launch, prefill_device_ms over
prefill_blocks, in the traced window; none where it held no block."""

from perfbench import counters


def read(ctx):
    c = counters.tracing()
    if c is None or not c.get("prefill_blocks"):
        return None
    return c.get("prefill_device_ms", 0.0) / c["prefill_blocks"]
