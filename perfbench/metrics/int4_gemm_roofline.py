"""The w4 GEMM's share of its roofline: for each launch in the traced
window, the larger of its operations over the peak rate and its bytes
over the peak bandwidth, with only the prompt rows a block really holds
(the blocks' rows less their padding, from the harness's records), over
the device time of the family's kernels and the rms epilogues that
follow them (families/int4_gemm.json)."""

from perfbench import work


def read(ctx):
    fam = work.load_family("int4_gemm")
    secs, n = ctx.trace.family_seconds(fam["kernels"], fam["epilogue"],
                                       fam["owners"])
    launches = [(work.Launch.parse(k), c) for k, c in ctx.launches.items()]
    launches = [(l, c) for l, c in launches
                if l is not None and l.kernel == fam["counter_kernel"]]
    rows = sum(l.m * c for l, c in launches)
    blocks = ctx.block_rows()
    ctx.note("int4_gemm", f"{sum(c for _, c in launches)} launches counted, "
                          f"{n} kernels in the trace, {secs:.6f} s")
    if secs <= 0 or not rows or blocks is None:
        return None
    real, padded = blocks
    keep = real / padded if padded else 1.0
    least = sum(work.least_seconds(work.w4_ops(l, l.m * keep),
                                   work.w4_bytes(l, l.m * keep)) * c
                for l, c in launches)
    return 100.0 * least / secs
