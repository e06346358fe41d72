"""Seconds the program spent capturing CUDA graphs in the run, set-up
included (engine.graphs CAPTURES, each capture's Graph.capture_seconds);
none where it captured nothing."""

from perfbench import counters


def read(ctx):
    c = counters.captures()
    if c is None or not c.get("graphs"):
        return None
    ctx.note("graph_capture_s", f"{c['graphs']} graphs captured in "
                                f"{c['seconds']:.3f} s")
    return c["seconds"]
