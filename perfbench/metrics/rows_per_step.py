"""Mean active rows per batched decode step started inside the window."""


def read(ctx):
    steps = ctx.window_steps()
    return sum(len(s.rids) for s in steps) / len(steps) if steps else None
