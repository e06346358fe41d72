"""The whole step's share of the card's peak: the least time of every
forward pass in the traced window, over the window.

Passes are counted from the launch counters (work.passes) and grouped
into one-token passes and prompt blocks; a group's least time is the
larger of its operations over the peak rate and its bytes over the peak
bandwidth. Bytes: every layer's weights once a pass, the lm_head once a
launch, and each row's embedding, the key and value rows its position
reads and the row it writes. Operations: 2 x parameters a row, attention
over the positions a one-token row sees, and the head where it runs.
The rows come from the harness's records (drivers/common.Rows); a prompt
block's rows are its real rows, and their attention is left out, so the
count is a lower bound."""

from perfbench import work


def read(ctx):
    s = ctx.shape
    by_m = work.passes(ctx.launches, s)
    if not by_m:
        return None
    blocks = by_m.get(ctx.block_width, 0)
    t1 = sum(n for m, n in by_m.items() if m != ctx.block_width)
    heads = work.head_launches(ctx.launches, s)
    ops_t1, bytes_t1 = 0, t1 * work.layer_weight_bytes(s) \
        + heads * work.head_bytes(s)
    ops_blk = 0
    for group, pos, head, attend in ctx.rows.rows:
        if group == "t1":
            ops_t1 += work.row_ops(s, pos, head, attend)
            bytes_t1 += work.row_bytes(s, pos, attend)
        elif head:
            ops_blk += 2 * s.vocab * s.dim
    real = ctx.block_rows()[0] if blocks else 0
    ops_blk += real * work.row_ops(s, 0, False, attend=False)
    bytes_blk = blocks * work.layer_weight_bytes(s) \
        + real * work.row_bytes(s, 0, attend=False)
    least = work.least_seconds(ops_t1, bytes_t1)
    if blocks:
        least += work.least_seconds(ops_blk, bytes_blk)
    ctx.note("step_mfu", f"passes by rows {by_m}, head launches {heads}, "
                         f"block rows {real}")
    return 100.0 * least / ctx.window_s
