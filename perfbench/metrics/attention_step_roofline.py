"""The decode attention kernel's share of its byte roofline: the bytes
its launches in the traced window need over the card's peak bandwidth,
over the device time of the kernel's family (families/attention_step
.json; its split combine runs inside the same launch).

Bytes: the cache rows each launch reads, min(pos + j, window) a slot at
step j, counted by the batch engine (attention_rows_active and
attention_rows_parked, a row of every layer's keys and values,
work.kv_row_bytes), and each launch's own rows from its variant key: the
qkv row in, the new key and value rows and the attention row out, the
positions and rope factors. The note checks attention_steps x layers
against the launch counter's growth and gives the share of the window's
chunk steps that ran the kernel."""

from perfbench import counters, work


def launch_bytes(key: str) -> int | None:
    """One launch's own bytes from attention_step/<cache>/B<b>/H<h>/kv<k>
    /D<d> (bf16 qkv), or None for another cache format."""
    parts = key.split("/")
    if len(parts) != 6 or parts[1] != "bf16":
        return None
    B, H, kv, D = (int(p.lstrip("BHkvD")) for p in parts[2:])
    return B * ((H + 2 * kv) * D * 2 + 2 * kv * D * 2 + H * D * 4 + 4
                + 2 * D * 4)


def read(ctx):
    c = counters.tracing()
    if c is None or not c.get("attention_steps"):
        return None
    fam = work.load_family("attention_step")
    secs, n = ctx.trace.family_seconds(fam["kernels"])
    prefix = fam["counter_kernel"] + "/"
    own, launched = 0, 0
    for key, count in ctx.launches.items():
        if key.startswith(prefix):
            b = launch_bytes(key)
            if b is None:
                ctx.note("attention_step", f"launch {key}: not a bf16 cache")
                return None
            own += b * count
            launched += count
    steps, layers = c["attention_steps"], ctx.shape.layers
    rows = c.get("attention_rows_active", 0) + c.get("attention_rows_parked",
                                                     0)
    plain = c.get("attention_plain_steps", 0)
    ctx.note("attention_step",
             f"{launched} launches counted, {n} in the trace, {secs:.6f} s; "
             f"attention_steps {steps} x {layers} layers = {steps * layers} "
             f"({launched - steps * layers} launches outside chunks); "
             f"{rows} rows; the kernel ran {steps} of {steps + plain} chunk "
             f"steps")
    if secs <= 0:
        return None
    nbytes = rows * work.kv_row_bytes(ctx.shape) + own
    return 100.0 * nbytes / work.PEAK_BYTES / secs
