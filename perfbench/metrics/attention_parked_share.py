"""The share of the cache rows that the attention_step launches of the
traced window read for slots that take no step: free slots, slots
capped at the cache's end, and slots parked at the dead tail rows while
they prefill (the batch engine's attention_rows_parked over it and
attention_rows_active). Only chunks whose window runs the kernel count
(attention_plain_steps the others)."""

from perfbench import counters


def read(ctx):
    c = counters.tracing()
    if c is None:
        return None
    active = c.get("attention_rows_active", 0)
    parked = c.get("attention_rows_parked", 0)
    if active + parked <= 0:
        return None
    return 100.0 * parked / (active + parked)
