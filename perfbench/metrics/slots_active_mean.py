"""The batch engine's mean occupied slots: scheduler.num_active read
before each step of the window."""


def read(ctx):
    xs = ctx.rows.active_slots
    return sum(xs) / len(xs) if xs else None
