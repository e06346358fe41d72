"""The w4 GEMV's share of its roofline: the bytes its launches in the
traced window need (work.w4_bytes, from each launch's variant key) over
the card's peak bandwidth, over the device time of the family's kernels
and the rms epilogues that follow them (families/int4_gemv.json)."""

from perfbench import work


def read(ctx):
    fam = work.load_family("int4_gemv")
    secs, n = ctx.trace.family_seconds(fam["kernels"], fam["epilogue"],
                                       fam["owners"])
    nbytes, launched = 0, 0
    for key, count in ctx.launches.items():
        l = work.Launch.parse(key)
        if l is not None and l.kernel == fam["counter_kernel"]:
            nbytes += work.w4_bytes(l) * count
            launched += count
    ctx.note("int4_gemv", f"{launched} launches counted, {n} in the trace, "
                          f"{secs:.6f} s")
    if secs <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / work.PEAK_BYTES / secs
