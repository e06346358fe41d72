"""The card's idle share: 1 - the union of its kernel, copy and memset
intervals over the traced window."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
