"""The card's milliseconds a decode step of the batch engine: CUDA events
around each chunk's replays of its step graph (forced prompt tokens
included), decode_device_ms over decode_steps, in the traced window.
The note holds the check of the event times against the trace: decode
and prefill milliseconds together lie between the card's busy time and
the window (the events count the gaps between replays)."""

from perfbench import counters


def read(ctx):
    c = counters.tracing()
    if c is None or not c.get("decode_steps"):
        return None
    dec, pre = c.get("decode_device_ms", 0.0), c.get("prefill_device_ms", 0.0)
    events_s = (dec + pre) / 1e3
    ctx.note("device_ms",
             f"decode {dec / 1e3:.6f} s over {c['decode_steps']} steps, "
             f"prefill {pre / 1e3:.6f} s over {c.get('prefill_blocks', 0)} "
             f"blocks: {events_s:.6f} s, {100 * events_s / ctx.busy_s:.2f} % "
             f"of busy {ctx.busy_s:.6f} s, window {ctx.window_s:.6f} s")
    return dec / c["decode_steps"]
